"""The port's losses and samplers (ops/losses.py, ops/sampling.py) against the
JAX package's and the numpy oracle.

fp32 on the CPU: rtol = atol = 1e-6 against JAX (the same formulas; sums
may reduce in another order); bitwise against tests/oracle_np.py where the
reduction order is pinned and the term has no transcendental function.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import oracle_np as oracle
from vae_assoc_tpu.ops import losses as jl
from vae_assoc_tpu.ops import sampling as js
from vae_assoc_tpu_torch.ops import losses as tl
from vae_assoc_tpu_torch.ops import sampling as ts

TOL = 1e-6


def _close(t, j):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), rtol=TOL, atol=TOL)


def _data(b=13, d=9, k=3, seed=0):
    r = np.random.default_rng(seed)
    mus = [r.normal(size=(b, d)).astype(np.float32) for _ in range(k)]
    lvs = [(0.3 * r.normal(size=(b, d))).astype(np.float32) for _ in range(k)]
    zs = [r.normal(size=(b, d)).astype(np.float32) for _ in range(k)]
    return mus, lvs, zs


@pytest.mark.parametrize("parity_mode", [False, True])
@pytest.mark.parametrize("by", ["logits", "probs"])
def test_bernoulli_recon_matches_jax(parity_mode, by):
    r = np.random.default_rng(1)
    x = r.uniform(0, 1, (11, 20)).astype(np.float32)
    logits = (3 * r.normal(size=(11, 20))).astype(np.float32)
    kw = {"logits": logits} if by == "logits" else {"probs": 1 / (1 + np.exp(-logits))}
    j = jl.bernoulli_recon(jnp.asarray(x), parity_mode=parity_mode,
                           **{k: jnp.asarray(v) for k, v in kw.items()})
    t = tl.bernoulli_recon(torch.from_numpy(x), parity_mode=parity_mode,
                           **{k: torch.from_numpy(np.asarray(v)) for k, v in kw.items()})
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=TOL, atol=1e-5)


@pytest.mark.parametrize("ordered", [False, True])
def test_gaussian_recon_and_kl_match_jax(ordered):
    r = np.random.default_rng(2)
    x, y = (r.normal(size=(7, 30)).astype(np.float32) for _ in range(2))
    _close(tl.gaussian_recon(torch.from_numpy(x), torch.from_numpy(y), ordered=ordered),
           jl.gaussian_recon(jnp.asarray(x), jnp.asarray(y), ordered=ordered))
    mu, lv = (r.normal(size=(7, 5)).astype(np.float32) for _ in range(2))
    _close(tl.kl_divergence(torch.from_numpy(mu), torch.from_numpy(lv), ordered=ordered),
           jl.kl_divergence(jnp.asarray(mu), jnp.asarray(lv), ordered=ordered))


def test_ordered_reductions_are_bitwise_the_oracle():
    r = np.random.default_rng(3)
    a = (r.normal(size=(6, 257)) * 10 ** r.uniform(-3, 3, (6, 257))).astype(np.float32)
    b = r.normal(size=(6, 257)).astype(np.float32)
    for axis in (-1, 0):
        np.testing.assert_array_equal(tl.ordered_sum(torch.from_numpy(a), axis).numpy(),
                                      oracle.ordered_sum(a, axis))
        np.testing.assert_array_equal(tl.ordered_mean(torch.from_numpy(a), axis).numpy(),
                                      oracle.ordered_mean(a, axis))
    np.testing.assert_array_equal(
        tl.gaussian_recon(torch.from_numpy(a), torch.from_numpy(b), ordered=True).numpy(),
        oracle.gaussian_recon(a, b))
    mus, _, _ = _data()
    np.testing.assert_array_equal(
        tl.assoc_loss([torch.from_numpy(m) for m in mus], ordered=True).numpy(),
        oracle.assoc_term(mus))


@pytest.mark.parametrize("form,negatives", [
    ("mean_l2", "local"), ("sample_l2", "local"), ("sym_kl", "local"),
    ("infonce", "local"), ("infonce", "global"),
])
def test_assoc_loss_matches_jax(form, negatives):
    mus, lvs, zs = _data()
    kw = dict(form=form, temp=0.2, negatives=negatives)
    j = jl.assoc_loss([jnp.asarray(m) for m in mus], z_logvars=[jnp.asarray(v) for v in lvs],
                      zs=[jnp.asarray(z) for z in zs], **kw)
    t = tl.assoc_loss([torch.from_numpy(m) for m in mus],
                      z_logvars=[torch.from_numpy(v) for v in lvs],
                      zs=[torch.from_numpy(z) for z in zs], **kw)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-5, atol=1e-5)


def test_infonce_streams_any_batch_and_equals_dense(monkeypatch):
    # Stream from 300 rows in blocks of 128 (a ragged last block of 44)
    # instead of 8192 / 1024, so a non-power-of-two batch streams here.
    mus, _, _ = _data(b=300, d=6, k=2, seed=4)
    a, b = (torch.from_numpy(m).requires_grad_() for m in mus)
    dense = tl.assoc_loss([a, b], form="infonce")
    ga = torch.autograd.grad(dense.sum(), [a, b])
    monkeypatch.setattr(tl, "INFONCE_STREAM_MIN_B", 300)
    monkeypatch.setattr(tl, "INFONCE_BLOCK", 128)
    calls = []
    orig = tl._lse_block
    monkeypatch.setattr(tl, "_lse_block", lambda *args: calls.append(1) or orig(*args))
    streamed = tl.assoc_loss([a, b], form="infonce")
    gs = torch.autograd.grad(streamed.sum(), [a, b])
    assert len(calls) >= 2 * 3  # both directions, three blocks each
    np.testing.assert_allclose(streamed.detach().numpy(), dense.detach().numpy(),
                               rtol=1e-5, atol=1e-5)
    for g, h in zip(gs, ga):
        np.testing.assert_allclose(g.numpy(), h.numpy(), rtol=1e-4, atol=1e-6)


def test_infonce_rejects_bad_arguments():
    mus, _, _ = _data()
    with pytest.raises(ValueError, match="temperature"):
        tl.assoc_loss([torch.from_numpy(m) for m in mus], form="infonce", temp=0.0)
    with pytest.raises(ValueError, match="negatives"):
        tl.assoc_loss([torch.from_numpy(m) for m in mus], form="infonce", negatives="x")
    with pytest.raises(ValueError, match="unknown assoc_form"):
        tl.assoc_loss([torch.from_numpy(m) for m in mus], form="l1")


def _philox_ref(ctr, key):
    """Philox4x32-10 on Python ints (Salmon et al.)."""
    c, k = list(ctr), list(key)
    for _ in range(10):
        p0, p1 = 0xD2511F53 * c[0], 0xCD9E8D57 * c[2]
        c = [(p1 >> 32) ^ c[1] ^ k[0], p1 & 0xFFFFFFFF, (p0 >> 32) ^ c[3] ^ k[1],
             p0 & 0xFFFFFFFF]
        k = [(k[0] + 0x9E3779B9) & 0xFFFFFFFF, (k[1] + 0xBB67AE85) & 0xFFFFFFFF]
    return c


def test_philox_reference_matches_known_answers():
    # Random123's known-answer vectors for philox4x32_10.
    assert _philox_ref([0] * 4, [0, 0]) == [0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8]
    assert _philox_ref([0xFFFFFFFF] * 4, [0xFFFFFFFF] * 2) == [
        0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD]


def test_philox_normal_is_box_muller_of_the_counter_stream():
    seed = 0x1234_5678_9ABC_DEF0
    eps = ts.philox_normal(seed, 5, 3, "cpu", row0=7)
    for r in range(5):
        for c in range(3):
            w = _philox_ref([7 + r, c, 0, 0], [seed & 0xFFFFFFFF, seed >> 32])
            u1 = np.float32(w[0] >> 8) * np.float32(1 / (1 << 24)) + np.float32(1e-7)
            u2 = np.float32(w[1] >> 8) * np.float32(1 / (1 << 24))
            want = np.sqrt(np.float32(-2) * np.log(u1)) * np.cos(np.float32(6.283185307179586) * u2)
            np.testing.assert_allclose(eps[r, c].item(), want, rtol=1e-6, atol=1e-6)


def test_philox_normal_does_not_depend_on_the_tile():
    whole = ts.philox_normal(99, 40, 6, "cpu")
    parts = torch.cat([ts.philox_normal(99, 16, 6, "cpu", row0=s) for s in (0, 16)]
                      + [ts.philox_normal(99, 8, 6, "cpu", row0=32)])
    assert torch.equal(whole, parts)
    assert not torch.equal(whole, ts.philox_normal(100, 40, 6, "cpu"))


def test_philox_normal_is_standard_normal():
    e = ts.philox_normal(5, 4000, 50, "cpu").double()
    assert abs(e.mean().item()) < 0.01 and abs(e.std().item() - 1) < 0.01
    assert torch.isfinite(e).all()


def test_fold_in_is_pure_and_spreads():
    assert ts.fold_in(3, 4) == ts.fold_in(3, 4)
    seeds = {ts.fold_in(s, d) for s in range(20) for d in range(20)}
    assert len(seeds) == 400 and all(0 <= v < 2 ** 64 for v in seeds)


def test_reparameterize_matches_jax():
    r = np.random.default_rng(6)
    mu, lv, eps = (r.normal(size=(4, 5)).astype(np.float32) for _ in range(3))
    _close(ts.reparameterize(torch.from_numpy(mu), torch.from_numpy(lv), eps=torch.from_numpy(eps)),
           js.reparameterize(jnp.asarray(mu), jnp.asarray(lv), eps=jnp.asarray(eps)))
    g = torch.Generator().manual_seed(0)
    z = ts.reparameterize(torch.zeros(3, 2), torch.zeros(3, 2), generator=g)
    assert z.shape == (3, 2)
    with pytest.raises(ValueError, match="generator"):
        ts.reparameterize(torch.zeros(3, 2), torch.zeros(3, 2))
