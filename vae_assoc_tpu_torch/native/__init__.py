"""The native (C++) UJI parser, built with g++ at first use (counterpart of vae_assoc_tpu/native).

The only host work of the input path that grows with the dataset is
parsing the UJI text files; ``uji_parser.cc`` does it behind a plain C
interface, bound here with ctypes. The library is built from the source
beside this file into ``native/build/<hash of the source>/`` (git-ignored)
the first time a parse needs it, never at import and never beside the
source. ``data/uji.py`` keeps a Python parser with bit-identical output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parent / "uji_parser.cc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
COMMAND = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17"]

_lock = threading.Lock()
_lib = None


class _UjiParse(ctypes.Structure):
    _fields_ = [
        ("n_samples", ctypes.c_int32),
        ("max_points", ctypes.c_int32),
        ("points", ctypes.POINTER(ctypes.c_float)),
        ("lengths", ctypes.POINTER(ctypes.c_int32)),
        ("names", ctypes.c_char_p),
        ("names_len", ctypes.c_int64),
        ("error", ctypes.c_char_p),
    ]


def build() -> Path:
    """Compile the parser unless the library of this source and command
    exists; return it.

    Each process compiles to a file of its own and renames it into place,
    so processes building at once never load a half-written library."""
    h = hashlib.sha256(SRC.read_bytes() + " ".join(COMMAND).encode()).hexdigest()[:16]
    lib = BUILD_DIR / h / "libuji_parser.so"
    if lib.exists():
        return lib
    lib.parent.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    out = subprocess.run([*COMMAND, str(SRC), "-o", str(tmp)], capture_output=True,
                         text=True, timeout=300)
    if out.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ could not build {SRC.name}:\n{out.stderr[-3000:]}")
    os.replace(tmp, lib)
    return lib


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            lib.uji_parse_file.restype = ctypes.POINTER(_UjiParse)
            lib.uji_parse_file.argtypes = [ctypes.c_char_p, ctypes.c_int32]
            lib.uji_parse_free.argtypes = [ctypes.POINTER(_UjiParse)]
            lib.uji_parse_free.restype = None
            _lib = lib
    return _lib


def available() -> bool:
    """True if the library is built, or can be, and loads."""
    try:
        _load()
        return True
    except (OSError, RuntimeError, subprocess.SubprocessError):
        return False


def parse_uji_file_native(path: str, max_points: int = 256) -> dict:
    """Parse one UJI v2 file with the C++ parser.

    Returns dict(points [N, max_points, 2] f32, lengths [N] i32, names
    list[str] per sample), bit-identical to the Python parser's per-file
    output (``data/uji.py``)."""
    if max_points < 1:
        raise ValueError(f"max_points must be >= 1, got {max_points}")
    lib = _load()
    res = lib.uji_parse_file(os.fsencode(path), max_points)
    try:
        r = res.contents
        if r.error:
            raise ValueError(r.error.decode())
        n = r.n_samples
        if n == 0:
            # A valid empty parse (a comments-only file): the Python
            # parser's [], without reading the buffers.
            return {"points": np.zeros((0, max_points, 2), np.float32),
                    "lengths": np.zeros((0,), np.int32), "names": []}
        pts = np.ctypeslib.as_array(r.points, shape=(n, max_points, 2)).copy()
        lengths = np.ctypeslib.as_array(r.lengths, shape=(n,)).copy()
        names = r.names.decode().split("\n") if r.names_len else []
        return {"points": pts, "lengths": lengths, "names": names}
    finally:
        lib.uji_parse_free(res)
