"""The port's UJI loader (data/uji.py), its native parser (native/) and the
resampler's single-curve, check and unflatten functions (ops/resample.py)
against the JAX package's.

The loader is host numpy in both packages, so parse results are held bit
for bit. The resample functions run in fp32 on the CPU: rtol 1e-5, atol
1e-6 of the polyline's largest coordinate (the arc-length cumsum adds in
another order, and its rounding grows with the coordinates).
"""

import os
import random
import textwrap

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vae_assoc_tpu.data import uji as juji
from vae_assoc_tpu.ops import resample as jres
from vae_assoc_tpu_torch import native
from vae_assoc_tpu_torch.data import uji
from vae_assoc_tpu_torch.ops import resample as tres

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "ujipenchars2_format.txt")

# The first torch.sqrt a process runs on the CPU has been seen to compute one
# thread's share of a large tensor with a coarser routine (errors of 3e-4
# relative, in about one process of eight); after one small call every later
# call is exact. Every worker imports this module while collecting.
torch.sqrt(torch.ones(4))
RTOL, ATOL = 1e-5, 1e-6

UJI_TEXT = textwrap.dedent(
    """\
    // UJIpenchars2 style sample
    WORD a w01
      NUMSTROKES 2
        POINTS 3 # 10 20 11 21 12 22
        POINTS 2 # 30 40 31 41
    WORD b w01
      NUMSTROKES 1
        POINTS 4 # 1 2 3 4 5 6 7 8
    WORD a w02
      NUMSTROKES 1
        POINTS 400 # {}
    """
).format(" ".join(str(i % 97) for i in range(800)))


@pytest.fixture()
def uji_file(tmp_path):
    p = tmp_path / "sample.txt"
    p.write_text(UJI_TEXT)
    return str(p)


def _same(got, want):
    for k in ("points", "lengths", "labels"):
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert got["label_names"] == want["label_names"]


def test_fixture_is_pure_ascii():
    with open(FIXTURE, "rb") as f:
        assert f.read().isascii()


def test_parse_and_write_round_trip_match_jax(rng):
    samples = [
        ("a", [rng.integers(0, 1000, (5, 2)).astype(np.float32),
               rng.integers(0, 1000, (3, 2)).astype(np.float32)]),
        ("7", [(rng.random((4, 2)) * 100).astype(np.float32)]),
    ]
    text = uji.write_uji_text(samples, header="round trip")
    assert text == juji.write_uji_text(samples, header="round trip")
    got, want = uji.parse_uji_text(text), juji.parse_uji_text(text)
    assert [c for c, _ in got] == [c for c, _ in want] == ["a", "7"]
    for (_, src), (_, g), (_, w) in zip(samples, got, want):
        for s, gs, ws in zip(src, g, w):
            np.testing.assert_array_equal(gs, s)
            np.testing.assert_array_equal(gs, ws)


@pytest.mark.parametrize("native_mode", ["never", "always", "auto"])
def test_load_fixture_is_bit_equal_to_jax(native_mode):
    got = uji.load_uji_files([FIXTURE], native=native_mode)
    want = juji.load_uji_files([FIXTURE], native="never")
    assert got["points"].shape == (240, 256, 2)
    assert got["label_names"] == [str(d) for d in range(10)]
    _same(got, want)


@pytest.mark.parametrize("max_points", [4, 64])
def test_subsample_multistroke_and_charset_match_jax(uji_file, max_points):
    for native_mode in ("never", "always"):
        got = uji.load_uji_files([uji_file], max_points=max_points, native=native_mode)
        _same(got, juji.load_uji_files([uji_file], max_points=max_points, native="never"))
    got = uji.load_uji_files([uji_file], max_points=64, native="always")
    np.testing.assert_array_equal(got["lengths"], [5, 4, 64])
    np.testing.assert_array_equal(got["labels"], [0, 1, 0])
    assert got["points"][0, 0, 1] == -20.0  # y flipped
    only_b = uji.load_uji_files([uji_file], charset="b", native="always")
    _same(only_b, juji.load_uji_files([uji_file], charset="b", native="never"))
    assert only_b["label_names"] == ["b"] and len(only_b["lengths"]) == 1
    with pytest.raises(ValueError, match="no samples"):
        uji.load_uji_files([uji_file], charset="z", native="never")


def test_native_builds_into_a_build_directory_at_first_use():
    lib = native.build()
    assert lib.exists() and lib.parent.parent == native.BUILD_DIR
    assert not (native.SRC.parent / "libuji_parser.so").exists()
    assert native.available()


def test_native_error_paths_and_empty_file(uji_file, tmp_path):
    with pytest.raises(ValueError, match="cannot open"):
        native.parse_uji_file_native(str(tmp_path / "missing.txt"))
    bad = tmp_path / "bad.txt"
    bad.write_text("WORD x w\n POINTS 3 # 1 2 3 4\n")
    with pytest.raises(ValueError, match="header says 3"):
        native.parse_uji_file_native(str(bad))
    with pytest.raises(ValueError, match="header says 3"):
        uji.load_uji_files([str(bad)], native="never")
    empty = tmp_path / "comments_only.txt"
    empty.write_text("// UJI v2 comments only\n//\n")
    r = native.parse_uji_file_native(str(empty), 64)
    assert r["points"].shape == (0, 64, 2) and r["names"] == []
    both = uji.load_uji_files([uji_file, str(empty)], native="always")
    _same(both, juji.load_uji_files([uji_file, str(empty)], native="never"))


def test_native_refuses_non_ascii_and_auto_falls_back(tmp_path):
    text = "WORD a w01\nNUMSTROKES 1\u0085garbage\nPOINTS 2 # 1 2 3 4\n"
    p = tmp_path / "nel.txt"
    p.write_text(text, encoding="utf-8")
    with pytest.raises(ValueError, match="ASCII"):
        uji.load_uji_files([str(p)], max_points=16, native="always")
    auto = uji.load_uji_files([str(p)], max_points=16, native="auto")
    _same(auto, juji.load_uji_files([str(p)], max_points=16, native="never"))


def test_native_agrees_with_python_on_fuzzed_input(tmp_path):
    """On any input the two parsers agree on accept or reject and, on
    accept, bit for bit."""
    tokens = [
        "WORD", "NUMSTROKES", "POINTS", "#", "//", "a", "b", "w01", "", "0", "1", "-1",
        "4.5", "1e3", "nan", "inf", "x", "99999999999999999999", "POINTS 3 # 1 2 3 4 5 6",
        "WORD a w01", "NUMSTROKES 1", "POINTS 2 # 1 2 3 4", "POINTS 1 #5 6", "POINTS 0 #",
        "POINTS -1 # 1 2", "POINTS 2 2 # 1 2 3 4", "\t", "\r", "0x1A", "nan(12)", "+5",
        "5.", ".5", "1e", "POINTS 007 # 1 2", "WORD\rPOINTS 1 # 1 2", "POINTS 1 # 1e999 2",
    ]
    rnd = random.Random(0)
    path = str(tmp_path / "fuzz.txt")
    for case in range(150):
        lines = [rnd.choice(tokens) if rnd.random() < 0.5
                 else " ".join(rnd.choice(tokens) for _ in range(rnd.randrange(1, 6)))
                 for _ in range(rnd.randrange(0, 16))]
        text = "\n".join(lines) + ("\n" if rnd.random() < 0.8 else "")
        with open(path, "w") as f:
            f.write(text)
        mp = rnd.choice([4, 16])
        out = {}
        for name, fn in (("py", uji._load_python), ("cc", uji._load_native)):
            try:
                out[name] = fn([path], mp)[0]
            except ValueError:
                out[name] = None
        assert (out["py"] is None) == (out["cc"] is None), f"case {case}: {text!r}"
        if out["py"] is not None:
            (pp, pl, pn), (cp, cl, cn) = out["py"], out["cc"]
            assert pn == cn and np.array_equal(pl, cl) and np.array_equal(pp, cp), text


def test_prepared_round_trip(uji_file, tmp_path):
    data = uji.load_uji_files([uji_file], native="never")
    p = str(tmp_path / "prep.pkl")
    uji.save_prepared(p, data)
    _same(uji.load_prepared(p), data)


def _polyline(rng, n, pad):
    pts = rng.normal(size=(n, 2)).astype(np.float32).cumsum(axis=0)
    out = np.empty((pad, 2), np.float32)
    out[:n], out[n:] = pts, pts[-1]
    return out


@pytest.mark.parametrize("length,num", [(37, 50), (2, 9), (1, 10), (64, 200)])
def test_arc_length_resample_matches_jax(rng, length, num):
    pts = _polyline(rng, length, 64)
    got = tres.arc_length_resample(torch.as_tensor(pts), length, num)
    want = jres.arc_length_resample(jnp.asarray(pts), jnp.int32(length), num)
    assert got.shape == (num, 2)
    scale = float(np.abs(pts).max())
    np.testing.assert_allclose(got.numpy() / scale, np.asarray(want) / scale,
                               rtol=RTOL, atol=ATOL)
    if length == 1:  # degenerate: a constant polyline at the first point
        np.testing.assert_array_equal(got.numpy(), np.broadcast_to(pts[0], (num, 2)))


def test_batch_resample_and_unflatten_match_jax(rng):
    pts = np.stack([_polyline(rng, n, 32) for n in (1, 5, 32, 17)])
    lengths = np.array([1, 5, 32, 17])
    got = tres.normalize_and_flatten(torch.as_tensor(pts), torch.as_tensor(lengths), 30)
    want = jres.normalize_and_flatten(jnp.asarray(pts), jnp.asarray(lengths, jnp.int32), 30)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
    flat = rng.normal(size=(4, 60)).astype(np.float32)
    back = tres.unflatten_trajectory(torch.as_tensor(flat))
    assert back.shape == (4, 30, 2)
    np.testing.assert_array_equal(back.numpy(),
                                  np.asarray(jres.unflatten_trajectory(jnp.asarray(flat))))


def test_validate_strokes_raises_the_reference_messages(rng):
    pts = rng.normal(size=(4, 32, 2)).astype(np.float32)
    assert tres.validate_strokes(torch.as_tensor(pts), torch.tensor([1, 16, 32, 8]))
    with pytest.raises(ValueError, match="must be >= 1"):
        tres.validate_strokes(torch.as_tensor(pts), torch.tensor([0, 16, 32, 8]))
    with pytest.raises(ValueError, match="padded point capacity 32"):
        tres.validate_strokes(torch.as_tensor(pts), torch.tensor([1, 16, 33, 8]))
    pts[0, 3, 1] = np.nan
    with pytest.raises(ValueError, match="non-finite coordinates inside valid stroke region"):
        tres.validate_strokes(torch.as_tensor(pts), torch.tensor([8, 8, 8, 8]))
    pts[0, 3, 1], pts[1, 12, 0] = 0.0, np.nan  # NaN in the padding is not read
    assert tres.validate_strokes(torch.as_tensor(pts), torch.tensor([8, 8, 8, 8]))
