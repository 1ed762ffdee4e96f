"""The port's RBF encoding (ops/rbf.py), stroke augmentation (ops/augment.py),
the featurization options of data/pipeline.py and train_loop's
refresh_data hook, against the JAX package's.

Tolerances, fp32 on the CPU:

- ``rbf_basis``: 1e-6 (the same arithmetic, exp rounded by two libraries).
- RBF reconstructions ``rbf_reconstruct(fit_rbf(y))``: atol 5e-5 on curves
  in [-1, 1]. The Gram matrix of 100 bases over 100 steps has a condition
  number κ ≈ 4.2e6, so the fp32 *weights* of two solvers may differ in
  their leading digits while both reconstruct the curve: the weights are
  held to a float64 solve instead, at relative error κ · 2⁻²⁴ (the fp32
  perturbation bound of a solve), per sample.
- Augmentation with the JAX draws injected: rtol 1e-5, atol 1e-5 × the
  strokes' largest coordinate (sin/cos and 2×2 products rounded apart).
- Features: 1e-5 (the pipeline's existing parity tolerance).
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vae_assoc_tpu import configs as jcfg
from vae_assoc_tpu.data import pipeline as jpipe
from vae_assoc_tpu.data.uji import load_uji_files as jload
from vae_assoc_tpu.ops import augment as jaug
from vae_assoc_tpu.ops import rbf as jrbf
from vae_assoc_tpu.train import loop as jloop
from vae_assoc_tpu_torch import configs as tcfg
from vae_assoc_tpu_torch.data import pipeline as tpipe
from vae_assoc_tpu_torch.ops import augment as taug
from vae_assoc_tpu_torch.ops import rbf as trbf
from vae_assoc_tpu_torch.ops.resample import normalize_and_flatten
from vae_assoc_tpu_torch.train import loop as tloop

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "ujipenchars2_format.txt")

# The first torch.sqrt a process runs on the CPU has been seen to compute one
# thread's share of a large tensor with a coarser routine (errors of 3e-4
# relative, in about one process of eight); after one small call every later
# call is exact. Every worker imports this module while collecting.
torch.sqrt(torch.ones(4))
F32_EPS = 2.0 ** -24


def _fixture(n=48):
    raw = jload([FIXTURE], native="never")
    return raw["points"][:n], raw["lengths"][:n], raw["labels"][:n]


@pytest.mark.parametrize("t,k", [(100, 100), (100, 20), (50, 1), (200, 32)])
def test_rbf_basis_matches_jax(t, k):
    np.testing.assert_allclose(trbf.rbf_basis(t, k, device="cpu").numpy(),
                               np.asarray(jrbf.rbf_basis(t, k)), rtol=1e-6, atol=1e-6)


def test_rbf_basis_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        trbf.rbf_basis(100, 20)


@pytest.mark.parametrize("k", [100, 50, 20])
def test_rbf_fit_reconstructs_as_jax_and_solves_as_float64(k):
    pts, lengths, _ = _fixture()
    curves = normalize_and_flatten(torch.as_tensor(pts), torch.as_tensor(lengths), 100,
                                   flatten=False)
    w = trbf.fit_rbf(curves, n_centers=k)
    jw = jrbf.fit_rbf(jnp.asarray(curves.numpy()), n_centers=k)
    assert w.shape == (48, 2 * k) and w.dtype == torch.float32
    np.testing.assert_allclose(trbf.rbf_reconstruct(w, 100).numpy(),
                               np.asarray(jrbf.rbf_reconstruct(jw, 100)), rtol=0, atol=5e-5)
    phi = trbf.rbf_basis(100, k, device="cpu").double().numpy()
    gram = phi.T @ phi + 1e-6 * np.eye(k)
    w64 = np.linalg.solve(gram, np.einsum("tk,btd->bkd", phi, curves.double().numpy()))
    w64 = w64.reshape(48, -1)
    rel = np.linalg.norm(w.double().numpy() - w64, axis=1) / np.linalg.norm(w64, axis=1)
    assert rel.max() <= np.linalg.cond(gram) * F32_EPS, rel.max()


@pytest.mark.parametrize("encoding", ["resample", "rbf"])
def test_featurize_the_fixture_matches_jax(encoding):
    pts, lengths, _ = _fixture()
    kw = dict(traj_encoding=encoding, rbf_centers=40)
    ji, jt = jpipe.featurize_pairs(jnp.asarray(pts), jnp.asarray(lengths), **kw)
    ti, tt = tpipe.featurize_pairs(torch.as_tensor(pts), torch.as_tensor(lengths), **kw)
    assert tt.shape == (48, 80 if encoding == "rbf" else 200)
    np.testing.assert_allclose(ti.numpy(), np.asarray(ji), rtol=1e-5, atol=1e-5)
    ds = tpipe.PairedDataset(pts, lengths, device="cpu", **kw)
    assert ds.traj_features == tt.shape[1]
    if encoding == "rbf":
        got = ds.decode_trajectories(tt).numpy()
        want = np.asarray(jrbf.rbf_reconstruct(jt, 100))
        np.testing.assert_allclose(got, want, rtol=0, atol=5e-5)
    else:
        np.testing.assert_allclose(tt.numpy(), np.asarray(jt), rtol=1e-5, atol=1e-5)
        np.testing.assert_array_equal(ds.trajectories_2d().numpy(),
                                      tt.numpy().reshape(48, 100, 2))


def test_unknown_encoding_raises():
    ds = tpipe.PairedDataset.from_synthetic(4, traj_encoding="nope", device="cpu")
    with pytest.raises(ValueError, match="traj_encoding"):
        ds.features()


def test_augment_config_validation():
    with pytest.raises(ValueError, match="max_rotate"):
        taug.AugmentConfig(max_rotate=-1)
    with pytest.raises(ValueError, match="max_scale"):
        taug.AugmentConfig(max_scale=1.5)
    hash(taug.AugmentConfig())
    assert dataclasses.asdict(taug.AugmentConfig()) == dataclasses.asdict(jaug.AugmentConfig())


def _strokes(b=8, p=64, seed=0):
    r = np.random.RandomState(seed)
    pts = r.randn(b, p, 2).astype(np.float32) * 50 + 500  # tablet-like coordinates
    lengths = r.randint(p // 2, p + 1, b).astype(np.int32)
    return pts, lengths


def _jax_draws(key, b, p):
    """The draws of vae_assoc_tpu/ops/augment.py, in its order."""
    k_rot, k_shear, k_scale, k_jit = jax.random.split(key, 4)
    u = [np.array(jax.random.uniform(k, (b,), minval=-1.0, maxval=1.0))
         for k in (k_rot, k_shear, k_scale)]
    noise = np.array(jax.random.normal(k_jit, (b, p, 2), jnp.float32))
    return [torch.from_numpy(v) for v in (*u, noise)]


@pytest.mark.parametrize("cfg", [taug.AugmentConfig(),
                                 taug.AugmentConfig(max_rotate=45, point_jitter=0.0),
                                 taug.AugmentConfig(max_shear=0.4, max_scale=0.5,
                                                    point_jitter=0.05)])
def test_apply_augment_with_the_jax_draws_matches_jax(cfg):
    pts, lengths = _strokes()
    key = jax.random.key(3)
    want = np.asarray(jaug.augment_strokes(jnp.asarray(pts), jnp.asarray(lengths), key,
                                           jaug.AugmentConfig(**dataclasses.asdict(cfg))))
    got = taug.apply_augment(torch.from_numpy(pts), torch.from_numpy(lengths).long(),
                             *_jax_draws(key, *pts.shape[:2]), cfg).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(pts).max())


def test_identity_config_is_the_identity_and_rotation_an_isometry():
    pts, lengths = _strokes(b=4, p=16)
    x, n = torch.from_numpy(pts), torch.from_numpy(lengths).long()
    ident = taug.AugmentConfig(max_rotate=0, max_shear=0, max_scale=0, point_jitter=0)
    out = taug.augment_strokes(x, n, torch.Generator().manual_seed(0), ident)
    np.testing.assert_allclose(out.numpy(), pts, atol=1e-4)
    rot = taug.AugmentConfig(max_rotate=45, max_shear=0, max_scale=0, point_jitter=0)
    out = taug.augment_strokes(x, n, torch.Generator().manual_seed(7), rot).numpy()
    for i in range(4):
        d0 = np.linalg.norm(pts[i, :, None] - pts[i, None], axis=-1)
        d1 = np.linalg.norm(out[i, :, None] - out[i, None], axis=-1)
        np.testing.assert_allclose(d1, d0, rtol=1e-4, atol=1e-2)
    assert np.abs(out - pts).max() > 1.0


def test_draws_are_the_generators_in_order_and_deterministic():
    pts, lengths = _strokes()
    x, n = torch.from_numpy(pts), torch.from_numpy(lengths).long()
    cfg = taug.AugmentConfig()
    a = taug.augment_strokes(x, n, torch.Generator().manual_seed(3), cfg)
    b = taug.augment_strokes(x, n, torch.Generator().manual_seed(3), cfg)
    c = taug.augment_strokes(x, n, torch.Generator().manual_seed(4), cfg)
    assert torch.equal(a, b) and (a - c).abs().max() > 1e-3
    g = torch.Generator().manual_seed(3)
    u = [torch.rand(8, generator=g) * 2 - 1 for _ in range(3)]
    noise = torch.randn(x.shape, generator=g)
    assert torch.equal(a, taug.apply_augment(x, n, *u, noise, cfg))


def test_draws_follow_their_distributions():
    """On the unit basis vectors (extent 1), each transform alone shows its
    draw: θ and the shear within their bounds, the scale in 1 ± max, the
    jitter's standard deviation point_jitter."""
    b = 4096
    basis = torch.tensor([[1.0, 0.0], [0.0, 1.0], [0.0, 0.0]]).expand(b, 3, 2)
    n = torch.full((b,), 3)
    off = dict(max_rotate=0, max_shear=0, max_scale=0, point_jitter=0)

    def run(seed, **kw):
        cfg = taug.AugmentConfig(**{**off, **kw})
        return taug.augment_strokes(basis, n, torch.Generator().manual_seed(seed), cfg)

    theta = torch.rad2deg(torch.atan2(*run(1, max_rotate=15)[:, 0].flip(-1).T))
    shear = run(2, max_shear=0.15)[:, 1, 0]
    scale = run(3, max_scale=0.15)[:, 0, 0]
    for v, lo, hi in ((theta, -15, 15), (shear, -0.15, 0.15), (scale, 0.85, 1.15)):
        assert lo <= float(v.min()) and float(v.max()) <= hi
        span = hi - lo
        assert abs(float(v.mean()) - (lo + hi) / 2) < 0.05 * span
        assert abs(float(v.std()) - span / 12 ** 0.5) < 0.05 * span
    jit = run(4, point_jitter=0.01) - basis
    assert abs(float(jit.std()) - 0.01) < 5e-4 and abs(float(jit.mean())) < 5e-4


def test_augmented_pair_is_consistent_and_clean_features_stay_cached():
    from vae_assoc_tpu_torch.ops.rasterize import rasterize_trajectories

    ds = tpipe.PairedDataset.from_synthetic(16, seed=0, device="cpu")
    cfg = taug.AugmentConfig(max_rotate=30, point_jitter=0.0)
    imgs_c, trajs_c = ds.features()
    imgs_a, trajs_a = ds.features(augment=cfg, generator=torch.Generator().manual_seed(11))
    assert float((imgs_a - imgs_c).abs().mean()) > 1e-3
    assert float((trajs_a - trajs_c).abs().mean()) > 1e-3
    again = ds.features(augment=cfg, generator=torch.Generator().manual_seed(11))
    assert torch.equal(again[0], imgs_a) and torch.equal(again[1], trajs_a)
    redraw = rasterize_trajectories(trajs_a.reshape(16, -1, 2)).numpy()
    a, c = imgs_a.numpy(), imgs_c.numpy()
    corr_aug = np.mean([np.corrcoef(redraw[i], a[i])[0, 1] for i in range(16)])
    corr_clean = np.mean([np.corrcoef(redraw[i], c[i])[0, 1] for i in range(16)])
    assert corr_aug > corr_clean + 0.1, (corr_aug, corr_clean)
    assert ds.features()[0] is imgs_c
    with pytest.raises(ValueError, match="generator given without augment"):
        ds.features(generator=torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="generator is None"):
        tpipe.featurize_pairs(ds._points, ds._lengths, augment=cfg)


@pytest.mark.parametrize("encoding", ["resample", "rbf"])
def test_subset_equals_the_slice_of_the_full_set(encoding):
    ds = tpipe.PairedDataset.from_synthetic(16, seed=0, traj_encoding=encoding,
                                            rbf_centers=20, device="cpu")
    idx = np.array([1, 3, 5, 8])
    sub = ds.subset(idx)
    assert len(sub) == 4 and sub.traj_encoding == encoding and sub.device == ds.device
    np.testing.assert_array_equal(sub.labels, np.asarray(ds.labels)[idx])
    for s, f in zip(sub.features(), ds.features()):
        np.testing.assert_allclose(s.numpy(), f.numpy()[idx], rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("n,frac,seed", [(10, 0.2, 0), (97, 0.25, 3), (240, 0.1, 7)])
def test_split_train_val_returns_the_jax_indices(n, frac, seed):
    r = np.random.default_rng(1)
    xs = [r.normal(size=(n, 3)).astype(np.float32), np.arange(n)]
    tr, va, (ti, vi) = tpipe.split_train_val([torch.from_numpy(xs[0]), xs[1]], frac, seed=seed)
    jtr, jva, (jti, jvi) = jpipe.split_train_val(xs, frac, seed=seed)
    np.testing.assert_array_equal(ti, jti)
    np.testing.assert_array_equal(vi, jvi)
    for got, want in zip(tr + va, jtr + jva):
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    assert isinstance(tr[0], torch.Tensor) and isinstance(tr[1], np.ndarray)
    with pytest.raises(ValueError, match="empty split"):
        tpipe.split_train_val(xs, 0.9999, seed=seed)
    with pytest.raises(ValueError, match="row-aligned"):
        tpipe.split_train_val([xs[0], xs[1][:-1]], frac)


def _recorder(log, zero):
    def make(cfg, tc):
        def step(state, xs):
            log.append([np.asarray(x) for x in xs])
            return state, {"total": zero()}
        return step
    return make


def test_refresh_data_feeds_the_jax_loops_batches(monkeypatch):
    """Both loops call the hook at each epoch's start and step through the
    fresh arrays in the same order: the batches match bit for bit. (The
    totals of a real run cannot be compared: the packages draw ε from
    different streams.)"""
    r = np.random.default_rng(0)
    data = [r.uniform(0, 1, (40, 6)).astype(np.float32),
            r.normal(size=(40, 4)).astype(np.float32)]
    arch = [dict(n_input=w, n_hidden_recog_1=8, n_hidden_gener_1=8, n_z=2) for w in (6, 4)]
    cfgs = [c.AssocConfig([c.ModalityConfig("image", arch[0], recon="bernoulli"),
                           c.ModalityConfig("trajectory", arch[1], recon="gaussian")])
            for c in (jcfg, tcfg)]
    kw = dict(batch_size=8, steps_per_call=2, seed=3)
    logs, calls = ([], []), ([], [])

    def refresh(calls):
        def fn(e):
            calls.append(e)
            return [d + np.float32(0.25 * e) for d in data]
        return fn

    monkeypatch.setattr(jloop, "make_train_step", _recorder(logs[0], lambda: jnp.float32(0)))
    monkeypatch.setattr(tloop, "make_train_step", _recorder(logs[1], lambda: torch.tensor(0.0)))
    jloop.train_loop(cfgs[0], jcfg.TrainConfig(**kw), data, epochs=3,
                     refresh_data=refresh(calls[0]))
    tloop.train_loop(cfgs[1], tcfg.TrainConfig(**kw), data, epochs=3, device="cpu",
                     refresh_data=refresh(calls[1]))
    assert calls[0] == calls[1] == [0, 1, 2]
    assert len(logs[1]) == len(logs[0]) == 6
    for t, j in zip(*logs[::-1]):
        for a, b in zip(t, j):
            np.testing.assert_array_equal(a, b)


def test_refresh_data_trains_and_refuses_other_shapes():
    ds = tpipe.PairedDataset.from_synthetic(32, seed=0, n_timesteps=20, device="cpu")
    arch = [dict(n_input=w, n_hidden_recog_1=8, n_hidden_recog_2=8, n_hidden_gener_1=8,
                 n_hidden_gener_2=8, n_z=2) for w in (784, 40)]
    cfg = tcfg.AssocConfig([tcfg.ModalityConfig("image", arch[0], recon="bernoulli"),
                            tcfg.ModalityConfig("trajectory", arch[1], recon="gaussian")])
    tc = tcfg.TrainConfig(batch_size=16, use_pallas="mega")
    gen, calls = torch.Generator().manual_seed(0), []

    def refresh(e):
        calls.append(e)
        return ds.features(augment=taug.AugmentConfig(), generator=gen)

    state, hist = tloop.train_loop(cfg, tc, ds.features(), epochs=3, refresh_data=refresh)
    assert calls == [0, 1, 2] and state.step == 6 and np.isfinite(hist[-1]["total"])
    with pytest.raises(ValueError, match="original shapes"):
        tloop.train_loop(cfg, tc, ds.features(), epochs=1,
                         refresh_data=lambda e: [ds.features()[0][:16], ds.features()[1]])
