"""UJI Pen Characters (v2) loader (counterpart of vae_assoc_tpu/data/uji.py).

The reference system derives both modalities from the UJI Pen Characters
v2 online-handwriting set: per-character pen-tip coordinate sequences,
from which it builds rasterized images and resampled trajectories.

UJI v2 is a plain-text format (UCI ML repository, "UJIpenchars2"):

    //comment lines
    WORD <character> <writer-tag>
      NUMSTROKES <k>
        POINTS <n> # <x1> <y1> <x2> <y2> ... <xn> <yn>
        ... (k POINTS lines)

Sessions are read into the padded raw-stroke structure the synthetic
generator produces, multi-stroke characters concatenated into one
polyline. Everything here is host numpy, bit-identical to the JAX
package's loader; ``PairedDataset.from_uji`` moves the result to the
device. Pass local file paths: nothing here downloads.
"""

from __future__ import annotations

import re
from typing import Iterable, List, Optional, Sequence, Tuple

import numpy as np

_WORD_RE = re.compile(r"^\s*WORD\s+(\S+)\s*(\S*)")
_NUMSTROKES_RE = re.compile(r"^\s*NUMSTROKES\s+(\d+)")
_POINTS_RE = re.compile(r"^\s*POINTS\s+(\d+)\s*#\s*(.*)$")


def parse_uji_text(text: str) -> List[Tuple[str, List[np.ndarray]]]:
    """Parse UJI v2 text → list of (character, [stroke arrays [n_i, 2]])."""
    samples: List[Tuple[str, List[np.ndarray]]] = []
    char: Optional[str] = None
    strokes: List[np.ndarray] = []
    expected = 0
    for line in text.splitlines():
        if line.lstrip().startswith("//"):
            continue
        m = _WORD_RE.match(line)
        if m:
            if char is not None and strokes:
                samples.append((char, strokes))
            char = m.group(1)
            strokes = []
            expected = 0
            continue
        m = _NUMSTROKES_RE.match(line)
        if m:
            expected = int(m.group(1))
            continue
        m = _POINTS_RE.match(line)
        if m:
            n = int(m.group(1))
            vals = np.array(m.group(2).split(), dtype=np.float64)
            if vals.size != 2 * n:
                raise ValueError(
                    f"POINTS header says {n} points but line has {vals.size} values"
                )
            strokes.append(vals.reshape(n, 2).astype(np.float32))
    if char is not None and strokes:
        samples.append((char, strokes))
    return samples


def write_uji_text(
    samples: Sequence[Tuple[str, Sequence[np.ndarray]]],
    *,
    writer_tag: str = "w01",
    header: str = "",
) -> str:
    """Serialize (character, [stroke arrays]) samples to UJI v2 text —
    the exact inverse of :func:`parse_uji_text` (round-trip tested).

    Strokes are written verbatim in the file/tablet convention
    (:func:`parse_uji_text` also returns raw file coordinates; the y-up
    flip happens later, in the loaders). Callers serializing y-up data —
    e.g. the synthetic generator's strokes — must negate y themselves so
    the loaders' flip restores it. Used to build format-faithful fixtures
    and to re-export filtered subsets.
    """
    lines = []
    for h in header.splitlines():
        lines.append(f"// {h}")
    for char, strokes in samples:
        lines.append(f"WORD {char} {writer_tag}")
        lines.append(f"  NUMSTROKES {len(strokes)}")
        for s in strokes:
            s = np.asarray(s, np.float64)
            flat = " ".join(_fmt_coord(v) for xy in s for v in xy)
            lines.append(f"    POINTS {len(s)} # {flat}")
    return "\n".join(lines) + "\n"


def _fmt_coord(v: float) -> str:
    # UJI v2 files carry integer tablet coordinates; keep integers clean
    # and fall back to repr-exact floats for synthetic data.
    if float(v).is_integer():
        return str(int(v))
    return repr(float(np.float32(v)))


def _load_python(paths, max_points):
    """Pure-Python per-file parse → (points, lengths, names) per file."""
    out = []
    for p in paths:
        with open(p, "r", encoding="utf-8", errors="replace") as f:
            samples = parse_uji_text(f.read())
        # Drop characters with zero total points (e.g. a lone "POINTS 0 #"
        # line) — the C++ parser skips them too, keeping outputs identical.
        samples = [s for s in samples if sum(len(st) for st in s[1]) > 0]
        if not samples:
            out.append((np.zeros((0, max_points, 2), np.float32),
                        np.zeros((0,), np.int32), []))
            continue
        n = len(samples)
        points = np.zeros((n, max_points, 2), np.float32)
        lengths = np.empty((n,), np.int32)
        names = []
        for i, (c, strokes) in enumerate(samples):
            poly = np.concatenate(strokes, axis=0)
            if len(poly) > max_points:
                idx = np.linspace(0, len(poly) - 1, max_points).round().astype(int)
                poly = poly[idx]
            # UJI y grows downward (tablet coords); flip so y is up like
            # the synthetic generator; pipeline normalization rescales.
            poly = poly * np.array([1.0, -1.0], np.float32)
            points[i, : len(poly)] = poly
            points[i, len(poly):] = poly[-1]
            lengths[i] = len(poly)
            names.append(c)
        out.append((points, lengths, names))
    return out


def _load_native(paths, max_points):
    from vae_assoc_tpu_torch import native

    out = []
    for p in paths:
        # Parity contract with the Python twin is BYTES-ARE-ASCII: the C++
        # parser splits/tokenizes raw bytes, while Python decodes UTF-8 and
        # uses unicode-aware splitlines (U+0085/U+2028/U+2029 also break
        # lines) and unicode \s/\d regexes. Real UJI v2 files are ASCII;
        # anything else routes to the Python parser rather than risk a
        # silent accept/reject divergence.
        with open(p, "rb") as f:
            raw = f.read()
        if not raw.isascii():
            raise ValueError(
                f"{p}: non-ASCII bytes — the native UJI parser's parity "
                "contract is ASCII-only; use native='never' (or 'auto', "
                "which falls back) for this file"
            )
        r = native.parse_uji_file_native(p, max_points)
        out.append((r["points"], r["lengths"], r["names"]))
    return out


def load_uji_files(
    paths: Sequence[str],
    *,
    max_points: int = 256,
    charset: Optional[Iterable[str]] = None,
    native: str = "auto",
):
    """Load UJI files into the padded raw-stroke structure.

    Multi-stroke characters are concatenated into one polyline (pen-up
    segments become straight connecting segments, as in the reference's
    flattening). Characters longer than `max_points` are uniformly
    subsampled to fit, preserving endpoints.

    native: "auto" uses the C++ parser (vae_assoc_tpu_torch.native, built
    with g++ at first use) when it builds and accepts the files, else the
    Python parser; "never"/"always" force one side. Outputs are
    bit-identical.

    Returns dict(points [N, max_points, 2] f32, lengths [N] i32,
    labels [N] i32, label_names list[str]).
    """
    if native == "always":
        per_file = _load_native(paths, max_points)
    elif native == "never":
        per_file = _load_python(paths, max_points)
    else:
        try:
            per_file = _load_native(paths, max_points)
        except Exception:
            per_file = _load_python(paths, max_points)

    points = np.concatenate([f[0] for f in per_file], axis=0)
    lengths = np.concatenate([f[1] for f in per_file], axis=0)
    names = [n for f in per_file for n in f[2]]
    if charset is not None:
        allowed = set(charset)
        keep = [i for i, c in enumerate(names) if c in allowed]
        points, lengths = points[keep], lengths[keep]
        names = [names[i] for i in keep]
    if len(names) == 0:
        raise ValueError("no samples parsed from UJI files")

    label_names = sorted(set(names))
    label_map = {c: i for i, c in enumerate(label_names)}
    labels = np.array([label_map[c] for c in names], np.int32)
    return {
        "points": points,
        "lengths": lengths,
        "labels": labels,
        "label_names": label_names,
    }


def save_prepared(path: str, data: dict) -> None:
    """Pickle the prepared raw-stroke dict (the reference system caches its
    prepared dataset the same way)."""
    import pickle

    with open(path, "wb") as f:
        pickle.dump(data, f, protocol=4)


def load_prepared(path: str) -> dict:
    """Read a :func:`save_prepared` file. Unpickling runs code: read only
    files this program wrote."""
    import pickle

    with open(path, "rb") as f:
        return pickle.load(f)
