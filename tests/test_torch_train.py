"""The port's training slice (models/vae.py, models/assoc.py, train/, data/,
convert.py) against the JAX package on the CPU.

Both sides get the same weights (convert.py) and the same ε (injected:
the two packages' random streams differ by design). fp32 throughout; the
JAX mega path runs its Pallas kernels in interpret mode, the port's its
plain twins. Tolerances: 1e-5 relative for losses and gradients (another
summation order), 1e-6 for the optimizer fed identical gradients.
"""

import contextlib
import dataclasses
import os
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from vae_assoc_tpu import configs as jcfg
from vae_assoc_tpu.data import pipeline as jpipe
from vae_assoc_tpu.data.synthetic import generate_raw_strokes
from vae_assoc_tpu.models import assoc as jassoc
from vae_assoc_tpu.models import vae as jvae
from vae_assoc_tpu.train import loop as jloop
from vae_assoc_tpu.train import step as jstep
from vae_assoc_tpu_torch import configs as tcfg
from vae_assoc_tpu_torch import convert
from vae_assoc_tpu_torch.data import pipeline as tpipe
from vae_assoc_tpu_torch.models import assoc as tassoc
from vae_assoc_tpu_torch.models import vae as tvae
from vae_assoc_tpu_torch.train import loop as tloop
from vae_assoc_tpu_torch.train import step as tstep

B = 37


def _archs(depth=2, hidden=16):
    def arch(n_in):
        return dict(n_input=n_in, n_z=4, **{f"n_hidden_{n}_{k}": hidden
                                           for n in ("recog", "gener")
                                           for k in range(1, depth + 1)})
    return arch(24), arch(12)


def _configs(form="mean_l2", n_cond=0, transfer="softplus", depth=2, lam=1.0):
    """(JAX AssocConfig, port AssocConfig) of a two-modality model."""
    a, b = _archs(depth)
    out = []
    for c in (jcfg, tcfg):
        out.append(c.AssocConfig(
            [c.ModalityConfig("image", a, recon="bernoulli", n_cond=n_cond, transfer=transfer),
             c.ModalityConfig("trajectory", b, recon="gaussian", n_cond=n_cond,
                              transfer=transfer)],
            assoc_lambda=lam, assoc_form=form))
    return out


def _models(jc, tc_, seed=0):
    jp = jassoc.init_assoc(jax.random.PRNGKey(seed), jc)
    return jp, convert.from_jax_numpy(jax.tree.map(np.asarray, jp), tc_, "cpu")


def _batch(n_cond=0, batch=B, seed=1):
    r = np.random.default_rng(seed)
    xs = [r.uniform(0, 1, (batch, 24)).astype(np.float32),
          r.normal(size=(batch, 12)).astype(np.float32)]
    if n_cond:
        xs.append(r.integers(0, n_cond, batch).astype(np.int32))
    eps = [r.normal(size=(batch, 4)).astype(np.float32) for _ in range(2)]
    return xs, eps


def _port_grads(model):
    return {k: p.grad.numpy().copy() for k, p in model.named_parameters()}


def _jax_flat(tree):
    return dict(convert._flatten(jax.tree.map(np.asarray, tree)))


def _assert_trees(got: dict, want: dict, rtol):
    assert set(got) == set(want)
    for k in want:
        w = np.asarray(want[k])
        np.testing.assert_allclose(got[k], w, rtol=rtol, atol=rtol * max(np.abs(w).max(), 1e-30),
                                   err_msg=k)


def _loss_both(use_pallas, form, n_cond, parity_mode=False):
    jc, tc_ = _configs(form, n_cond)
    jp, tm = _models(jc, tc_)
    xs, eps = _batch(n_cond)
    jx = [jnp.asarray(x) for x in xs]
    (jt, jm), jg = jax.value_and_grad(
        lambda p: jassoc.assoc_loss_fn(p, jx, jc, eps=[jnp.asarray(e) for e in eps],
                                       use_pallas=use_pallas, parity_mode=parity_mode),
        has_aux=True)(jp)
    tt, tmets = tassoc.assoc_loss_fn(tm, [torch.from_numpy(x) for x in xs], tc_,
                                     eps=[torch.from_numpy(e) for e in eps],
                                     use_pallas=use_pallas, parity_mode=parity_mode)
    tt.backward()
    return (jt, jm, _jax_flat(jg)), (tt, tmets, _port_grads(tm))


@pytest.mark.parametrize("use_pallas,form,n_cond", [
    ("mega", "mean_l2", 0), ("mega", "sample_l2", 0), ("mega", "infonce", 3),
    (False, "mean_l2", 0), (False, "sym_kl", 3),
])
def test_assoc_loss_fn_matches_jax(use_pallas, form, n_cond):
    (jt, jm, jg), (tt, tm, tg) = _loss_both(use_pallas, form, n_cond)
    assert set(tm) == set(jm) == {"recon_image", "kl_image", "recon_trajectory",
                                  "kl_trajectory", "assoc", "total"}
    for k in jm:
        np.testing.assert_allclose(tm[k].item(), float(jm[k]), rtol=1e-5, atol=1e-6, err_msg=k)
    np.testing.assert_allclose(tt.item(), float(jt), rtol=1e-5)
    _assert_trees(tg, jg, 1e-5)


ONE_MODALITY = {"image": (0, "bernoulli"), "trajectory": (1, "gaussian")}


@pytest.mark.parametrize("modality", sorted(ONE_MODALITY))
@pytest.mark.parametrize("use_pallas", [False, "mega", True])
def test_one_modality_loss_matches_jax(modality, use_pallas):
    # Baseline configs 1 and 2: one modality, λ = 0 (the joint loss kernel at
    # K = 1, the megakernel over a single tower), at the helpers' widths.
    which, recon = ONE_MODALITY[modality]
    arch = _archs()[which]
    jc, tc_ = (c.AssocConfig([c.ModalityConfig(modality, arch, recon=recon)], assoc_lambda=0.0)
               for c in (jcfg, tcfg))
    jp, tm = _models(jc, tc_)
    xs, eps = _batch()
    x, e = xs[which], eps[which]
    (jt, jm), jg = jax.value_and_grad(
        lambda p: jassoc.assoc_loss_fn(p, [jnp.asarray(x)], jc, eps=[jnp.asarray(e)],
                                       use_pallas=use_pallas), has_aux=True)(jp)
    tt, tmets = tassoc.assoc_loss_fn(tm, [torch.from_numpy(x)], tc_, eps=[torch.from_numpy(e)],
                                     use_pallas=use_pallas)
    tt.backward()
    assert set(tmets) == set(jm)
    for k in jm:
        np.testing.assert_allclose(tmets[k].item(), float(jm[k]), rtol=1e-5, atol=1e-6, err_msg=k)
    np.testing.assert_allclose(tt.item(), float(jt), rtol=1e-5)
    _assert_trees(_port_grads(tm), _jax_flat(jg), 1e-5)


def test_parity_mode_matches_jax():
    (jt, jm, jg), (tt, tm, tg) = _loss_both(False, "mean_l2", 0, parity_mode=True)
    for k in jm:
        np.testing.assert_allclose(tm[k].item(), float(jm[k]), rtol=1e-6, err_msg=k)
    _assert_trees(tg, jg, 1e-5)


@pytest.mark.parametrize("kind", ["bernoulli", "gaussian"])
def test_vae_forward_loss_and_reconstruct_match_jax(kind):
    arch = _archs()[0]
    jm = jcfg.ModalityConfig("m", arch, recon=kind, n_cond=3)
    tm = tcfg.ModalityConfig("m", arch, recon=kind, n_cond=3)
    from vae_assoc_tpu.models import networks as jnet

    jp = jnet.init_mlp_vae_params(jax.random.PRNGKey(2), arch, n_cond=3)
    tp = convert.from_jax_numpy({"modalities": (jax.tree.map(np.asarray, jp),)},
                                tcfg.AssocConfig([tm]), "cpu").modalities[0]
    xs, eps = _batch(n_cond=3)
    x, cond, e = xs[0], xs[2], eps[0]
    jo = jvae.vae_forward(jp, jnp.asarray(x), jm, eps=jnp.asarray(e), cond=jnp.asarray(cond))
    with torch.no_grad():
        to = tvae.vae_forward(tp, torch.from_numpy(x), tm, eps=torch.from_numpy(e),
                              cond=torch.from_numpy(cond))
        for a, b in zip(to, jo):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-5)
        for pm in (False, True):
            jl = jvae.vae_loss(jo, jnp.asarray(x), jm, parity_mode=pm)
            tl = tvae.vae_loss(to, torch.from_numpy(x), tm, parity_mode=pm)
            for k in jl:
                np.testing.assert_allclose(tl[k].item(), float(jl[k]), rtol=1e-5)
        np.testing.assert_allclose(
            tvae.reconstruct(tp, torch.from_numpy(x), tm, eps=torch.from_numpy(e),
                             cond=torch.from_numpy(cond)).numpy(),
            np.asarray(jvae.reconstruct(jp, jnp.asarray(x), jm, eps=jnp.asarray(e),
                                        cond=jnp.asarray(cond))), rtol=1e-5, atol=1e-5)


def test_plain_and_mega_paths_draw_the_same_eps_from_a_seed():
    _, tc_ = _configs()
    _, tm = _models(*_configs())
    xs = [torch.from_numpy(x) for x in _batch()[0]]
    with torch.no_grad():
        a = tassoc.assoc_loss_fn(tm, xs, tc_, seed=5, use_pallas=False)[1]
        b = tassoc.assoc_loss_fn(tm, xs, tc_, seed=5, use_pallas="mega")[1]
        c = tassoc.assoc_loss_fn(tm, xs, tc_, seed=6, use_pallas="mega")[1]
    for k in a:
        np.testing.assert_allclose(b[k].item(), a[k].item(), rtol=1e-5)
    assert c["total"].item() != b["total"].item()


@contextlib.contextmanager
def _fallback_warns(category, expect: bool):
    """Expect one warning of ``category``, or make any such warning an error."""
    if expect:
        with pytest.warns(category, match="composable"):
            yield
    else:
        with warnings.catch_warnings():
            warnings.simplefilter("error", category)
            yield


@pytest.mark.parametrize("case", ["relu", "depth3", "parity_mode"])
def test_mega_falls_back_to_the_composable_kernels(case):
    # A config the megakernel does not implement warns and trains on the
    # composable kernels; parity_mode under "mega" runs the kernel towers
    # with the ordered plain losses. Both as the JAX package does.
    kw = {"relu": dict(transfer="relu"), "depth3": dict(depth=3), "parity_mode": {}}[case]
    parity = case == "parity_mode"
    jc, tc_ = _configs(**kw)
    jp, tm = _models(jc, tc_)
    reason = tassoc.mega_fallback_reason(tc_)
    assert reason == jassoc.mega_fallback_reason(jc)
    assert (reason is None) == parity
    xs, eps = _batch()
    with _fallback_warns(jassoc.MegaFallbackWarning, not parity):
        (jt, jm), jg = jax.value_and_grad(
            lambda p: jassoc.assoc_loss_fn(p, [jnp.asarray(x) for x in xs], jc,
                                           eps=[jnp.asarray(e) for e in eps],
                                           use_pallas="mega", parity_mode=parity),
            has_aux=True)(jp)
    with _fallback_warns(tassoc.MegaFallbackWarning, not parity):
        tt, tmets = tassoc.assoc_loss_fn(tm, [torch.from_numpy(x) for x in xs], tc_,
                                         eps=[torch.from_numpy(e) for e in eps],
                                         use_pallas="mega", parity_mode=parity)
    tt.backward()
    for k in jm:
        np.testing.assert_allclose(tmets[k].item(), float(jm[k]), rtol=1e-5, atol=1e-6, err_msg=k)
    _assert_trees(_port_grads(tm), _jax_flat(jg), 1e-5)


OPT_CASES = {
    "defaults": {},
    "clip": dict(grad_clip_norm=0.5),
    "cosine_warmup": dict(lr_schedule="cosine", decay_steps=5, warmup_steps=2, lr_end_factor=0.1),
    "accum3": dict(accum_steps=3),
    "ema": dict(ema_decay=0.9),
    "all": dict(grad_clip_norm=0.5, lr_schedule="cosine", decay_steps=4, warmup_steps=1,
                accum_steps=2, ema_decay=0.8),
}


@pytest.mark.parametrize("case", sorted(OPT_CASES))
def test_optimizer_matches_optax(case):
    kw = OPT_CASES[case]
    jo = jstep.make_optimizer(jcfg.TrainConfig(learning_rate=0.01, **kw))
    ttc = tcfg.TrainConfig(learning_rate=0.01, **kw)
    to = tstep.make_optimizer(ttc)
    r = np.random.default_rng(0)
    shapes = [(5, 3), (3,), (7,)]
    p0 = [r.normal(size=s).astype(np.float32) for s in shapes]
    jp = [jnp.asarray(p) for p in p0]
    tp = [torch.from_numpy(p.copy()) for p in p0]
    js, ts = jo.init(jp), to.init(tp)
    for _ in range(6):
        g = [(r.normal(size=s) * 10 ** r.uniform(-3, 1)).astype(np.float32) for s in shapes]
        u, js = jo.update([jnp.asarray(x) for x in g], js, jp)
        jp = optax.apply_updates(jp, u)
        to.update([torch.from_numpy(x) for x in g], ts, tp)
        for a, b in zip(tp, jp):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-7)
    if ttc.ema_decay:
        for a, b in zip(tstep.ema_params(ttc, ts),
                        jstep.ema_params(jcfg.TrainConfig(learning_rate=0.01, **kw), js)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-7)


def test_objective_weights_match_jax():
    ttc = tcfg.TrainConfig(kl_beta=0.5, kl_anneal_steps=4, assoc_warmup_steps=3, accum_steps=2)
    jtc = jcfg.TrainConfig(kl_beta=0.5, kl_anneal_steps=4, assoc_warmup_steps=3, accum_steps=2)
    assert tstep.objective_weights(tcfg.TrainConfig(), 7) is None
    jc, tc_ = _configs(lam=0.7)
    names = ["recon_image", "kl_image", "recon_trajectory", "kl_trajectory", "assoc", "total"]
    vals = np.random.default_rng(0).uniform(1, 5, len(names)).astype(np.float32)
    for step in (0, 3, 5, 9):
        jt, jm = jstep.apply_objective_weights(
            jnp.float32(vals[-1]), {n: jnp.float32(v) for n, v in zip(names, vals)},
            jc, jtc, jnp.int32(step))
        tt, tm = tstep.apply_objective_weights(
            torch.tensor(vals[-1]), {n: torch.tensor(v) for n, v in zip(names, vals)},
            tc_, ttc, step)
        np.testing.assert_allclose(tt.item(), float(jt), rtol=1e-6)
        for k in ("kl_beta_eff", "assoc_scale_eff"):
            np.testing.assert_allclose(tm[k].item(), float(jm[k]), rtol=1e-6)
    t0 = torch.tensor(1.0)
    assert tstep.apply_objective_weights(t0, {"total": t0}, tc_, tcfg.TrainConfig(), 3)[0] is t0


def test_training_state_continues_a_jax_run():
    # Three JAX steps on the mega path, the state carried into the port,
    # then three more steps on both sides with the same ε.
    jc, tc_ = _configs()
    jtc, ttc = jcfg.TrainConfig(learning_rate=0.01), tcfg.TrainConfig(learning_rate=0.01)
    jp, _ = _models(jc, tc_)
    opt = jstep.make_optimizer(jtc)
    js = jstep.TrainState(jnp.int32(0), jp, opt.init(jp), jax.random.key(0))

    @jax.jit
    def jax_step(state, xs, eps):
        (_, m), g = jax.value_and_grad(
            lambda p: jassoc.assoc_loss_fn(p, xs, jc, eps=eps, use_pallas="mega"),
            has_aux=True)(state.params)
        u, os_ = opt.update(g, state.opt_state, state.params)
        return state._replace(step=state.step + 1, params=optax.apply_updates(state.params, u),
                              opt_state=os_), m

    batches = [_batch(seed=10 + t) for t in range(6)]
    for xs, eps in batches[:3]:
        js, _ = jax_step(js, [jnp.asarray(x) for x in xs], [jnp.asarray(e) for e in eps])
    adam = js.opt_state[0]
    ts = convert.train_state_from_jax_numpy(
        jax.tree.map(np.asarray, js.params),
        (np.asarray(adam.count), jax.tree.map(np.asarray, adam.mu), jax.tree.map(np.asarray, adam.nu)),
        np.asarray(js.step), tc_, ttc, "cpu")
    assert ts.step == 3 and ts.opt_state.adam.count == 3
    topt = tstep.make_optimizer(ttc)
    for xs, eps in batches[3:]:
        js, jm = jax_step(js, [jnp.asarray(x) for x in xs], [jnp.asarray(e) for e in eps])
        ts, tm = tstep._one_step(ts, [torch.from_numpy(x) for x in xs], tc_, ttc, topt,
                                 eps=[torch.from_numpy(e) for e in eps])
        for k in jm:
            np.testing.assert_allclose(tm[k].item(), float(jm[k]), rtol=1e-5, err_msg=k)
    params, (count, mu, nu), step = convert.train_state_to_jax_numpy(ts)
    adam = js.opt_state[0]
    assert int(step) == int(js.step) == 6 and int(count) == int(adam.count) == 6
    for got, want in ((params, js.params), (mu, adam.mu), (nu, adam.nu)):
        _assert_trees(dict(convert._flatten(got)), _jax_flat(want), 1e-5)


def test_train_state_converts_both_ways_bitwise():
    jc, tc_ = _configs()
    ttc = tcfg.TrainConfig()
    jp, _ = _models(jc, tc_)
    flat = jax.tree.map(np.asarray, jp)
    mu = jax.tree.map(lambda a: np.asarray(a) * 0.5, flat)
    nu = jax.tree.map(lambda a: np.asarray(a) ** 2, flat)
    ts = convert.train_state_from_jax_numpy(flat, (np.int32(4), mu, nu), np.int32(9), tc_, ttc, "cpu")
    params, (count, mu2, nu2), step = convert.train_state_to_jax_numpy(ts)
    assert (int(count), int(step)) == (4, 9)
    for a, b in ((params, flat), (mu2, mu), (nu2, nu)):
        fa, fb = dict(convert._flatten(a)), dict(convert._flatten(b))
        assert set(fa) == set(fb)
        for k in fb:
            np.testing.assert_array_equal(fa[k], fb[k])


def _recorder(log, make_zero):
    def make(cfg, tc):
        def step(state, xs):
            log.append([np.asarray(x).copy() for x in xs])
            return state, {"total": make_zero()}
        return step
    return make


def test_train_loop_consumes_the_jax_batch_order(monkeypatch):
    jc, tc_ = _configs()
    kw = dict(batch_size=8, steps_per_call=2, seed=3)
    xs, _ = _batch(batch=41)
    jlog, tlog = [], []
    monkeypatch.setattr(jloop, "make_train_step", _recorder(jlog, lambda: jnp.float32(0)))
    monkeypatch.setattr(tloop, "make_train_step", _recorder(tlog, lambda: torch.tensor(0.0)))
    jloop.train_loop(jc, jcfg.TrainConfig(**kw), xs, epochs=2)
    tloop.train_loop(tc_, tcfg.TrainConfig(**kw), xs, epochs=2, device="cpu")
    assert len(tlog) == len(jlog) == 4
    for t, j in zip(tlog, jlog):
        for a, b in zip(t, j):
            assert a.shape == (2, 8, b.shape[-1])
            np.testing.assert_array_equal(a, b)


def test_make_train_step_runs_steps_per_call():
    _, tc_ = _configs()
    xs = [torch.from_numpy(x) for x in _batch(batch=16)[0]]
    one = tstep.make_train_step(tc_, tcfg.TrainConfig(use_pallas="mega"))
    two = tstep.make_train_step(tc_, tcfg.TrainConfig(use_pallas="mega", steps_per_call=2))
    sa = tstep.init_train_state(tc_, tcfg.TrainConfig(), device="cpu")
    sb = tstep.init_train_state(tc_, tcfg.TrainConfig(), device="cpu")
    sa, m1 = one(sa, xs)
    sa, m2 = one(sa, xs)
    sb, m = two(sb, [torch.stack([x, x]) for x in xs])
    assert sb.step == sa.step == 2 and m["total"].shape == (2,)
    np.testing.assert_allclose(m["total"].numpy(), [m1["total"].item(), m2["total"].item()],
                               rtol=1e-6)
    for p, q in zip(sa.params.parameters(), sb.params.parameters()):
        torch.testing.assert_close(p, q, rtol=0, atol=0)


def test_train_loop_fused_is_deterministic_and_learns():
    _, tc_ = _configs()
    xs = [torch.from_numpy(x) for x in _batch(batch=96)[0]]
    ttc = tcfg.TrainConfig(batch_size=16, steps_per_call=2, use_pallas="mega", seed=4,
                           learning_rate=3e-3)
    s1, h1 = tloop.train_loop_fused(tc_, ttc, xs, epochs=4)
    s2, h2 = tloop.train_loop_fused(tc_, ttc, xs, epochs=4)
    s3, h3 = tloop.train_loop_fused(tc_, dataclasses.replace(ttc, seed=5), xs, epochs=4)
    assert s1.step == 24 and len(h1) == 4
    assert [h["total"] for h in h1] == [h["total"] for h in h2]
    assert [h["total"] for h in h1] != [h["total"] for h in h3]
    for p, q in zip(s1.params.parameters(), s2.params.parameters()):
        assert torch.equal(p, q)
    assert h1[-1]["total"] < h1[0]["total"]
    assert h1[0]["samples_per_sec"] > 0 and "grad_norm" in h1[0]


def test_rasterize_matches_jax_at_the_edges_and_on_repeated_points():
    """The port splats by a product of row and column weights, the JAX
    package by scatter-add: the same sums, clamping at the grid's edges and
    points stacked on one pixel included."""
    from vae_assoc_tpu.ops.rasterize import rasterize_trajectories as jrast
    from vae_assoc_tpu_torch.ops.rasterize import rasterize_trajectories as trast

    r = np.random.default_rng(7)
    traj = r.uniform(-1.3, 1.3, (5, 40, 2)).astype(np.float32)  # past the edges
    traj[:, 20:] = traj[:, :1]  # 20 points on one spot
    traj[0, :5] = [[-1.1, 1.1], [1.1, -1.1], [1.0, 1.0], [-1.0, -1.0], [1.2, 1.2]]
    want = np.asarray(jrast(jnp.asarray(traj)))
    got = trast(torch.from_numpy(traj)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_pipeline_features_match_jax():
    raw = generate_raw_strokes(29, seed=3)
    ji, jt = jpipe.featurize_pairs(jnp.asarray(raw["points"]), jnp.asarray(raw["lengths"]))
    ds = tpipe.PairedDataset.from_synthetic(29, seed=3, device="cpu")
    ti, tt = ds.features()
    assert ti.shape == (29, 784) and tt.shape == (29, 200)
    np.testing.assert_allclose(ti.numpy(), np.asarray(ji), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), rtol=1e-5, atol=1e-5)
    fixture = os.path.join(os.path.dirname(__file__), "fixtures", "ujipenchars2_format.txt")
    ji, jt = jpipe.PairedDataset.from_uji([fixture]).features()
    ti, tt = tpipe.PairedDataset.from_uji([fixture], device="cpu").features()
    assert ti.shape == (240, 784) and tt.shape == (240, 200)
    np.testing.assert_allclose(ti.numpy(), np.asarray(ji), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("entry", ["init_train_state", "train_loop", "train_loop_fused",
                                   "PairedDataset", "load_params", "init_sweep_state",
                                   "sweep_loop", "driver.main", "entry", "dryrun_multichip"])
def test_training_entry_points_default_to_cuda(entry, tmp_path, monkeypatch):
    # Without a GPU, an entry point that the caller did not point at the CPU
    # raises instead of quietly training there.
    from vae_assoc_tpu_torch import graft_entry
    from vae_assoc_tpu_torch.train import driver, sweep
    from vae_assoc_tpu_torch.utils import checkpoint as tckpt

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, tc_ = _configs()
    ttc = tcfg.TrainConfig(batch_size=8)
    xs, _ = _batch(batch=16)
    if entry == "load_params":
        tckpt.save_params(tmp_path, tassoc.init_assoc(0, tc_, device="cpu"), tc_)
    call = {
        "init_train_state": lambda: tstep.init_train_state(tc_, ttc),
        "train_loop": lambda: tloop.train_loop(tc_, ttc, xs, epochs=1),
        "train_loop_fused": lambda: tloop.train_loop_fused(tc_, ttc, xs, epochs=1),
        "PairedDataset": lambda: tpipe.PairedDataset.from_synthetic(4),
        "load_params": lambda: tckpt.load_params(tmp_path),
        "init_sweep_state": lambda: sweep.init_sweep_state(tc_, ttc, [0, 1]),
        "sweep_loop": lambda: sweep.sweep_loop(tc_, ttc, xs, seeds=[0, 1], epochs=1),
        "driver.main": lambda: driver.main(["--depth", "1", "--hidden", "8", "--epochs", "1"]),
        "entry": lambda: graft_entry.entry(),
        "dryrun_multichip": lambda: graft_entry.dryrun_multichip(4),
    }[entry]
    match = ("the training CLI runs on the card.*no CUDA device" if entry == "driver.main"
             else f"{entry}\\(device='cuda'\\).*no CUDA device")
    with pytest.raises(RuntimeError, match=match):
        call()


def test_remat_recomputes_the_same_gradients():
    _, tc_ = _configs()
    xs = [torch.from_numpy(x) for x in _batch()[0]]
    grads = []
    for remat in (False, True):
        _, tm = _models(*_configs())
        total, _ = tassoc.assoc_loss_fn(tm, xs, tc_, seed=3, remat=remat)
        total.backward()
        grads.append(_port_grads(tm))
    _assert_trees(grads[1], grads[0], 1e-6)
