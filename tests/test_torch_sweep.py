"""The port's E-model sweep (vae_assoc_tpu_torch/train/sweep.py) against
the JAX package's, on the CPU at widths of 16.

- A JAX sweep state (E = 3, one JAX step in, so the moments are nonzero),
  carried into the port by ``convert.sweep_state_from_jax_numpy``, takes 3
  vmapped steps with per-model learning rates and λs and injected ε, held
  against a JAX reference that ``jax.vmap``s ``assoc_loss_fn(eps=)``, the
  objective rebuilt with λ (``_total_with_lambda``) and the optax chain
  at learning rate 1 with the update scaled per model, as the JAX
  package's ``_one_step(lr_scale=)`` does: fp32, every leaf within a
  relative error norm of 1e-5.
- Member i follows the port's standalone step with seed i, on its own ε
  stream, within the same bound.
- ``steps_per_call=2`` gives [N, E] metrics; the refusals of both
  packages match; ``sweep_loop``'s batches and history match JAX's.
- The data-parallel sweep on 2 gloo ranks (spawned once for the module)
  equals the one-process sweep on the global batch with InfoNCE's global
  negatives and with mean-L2, and each member equals the port's DP step
  with local negatives.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from vae_assoc_tpu import configs as jcfg
from vae_assoc_tpu.models import assoc as jassoc
from vae_assoc_tpu.train import step as jstep
from vae_assoc_tpu.train import sweep as jsw
from vae_assoc_tpu_torch import configs as tcfg
from vae_assoc_tpu_torch import convert
from vae_assoc_tpu_torch.parallel import dp, mesh
from vae_assoc_tpu_torch.train import step as tstep
from vae_assoc_tpu_torch.train import sweep as tsw

ARCH = dict(n_input=24, n_z=4, n_hidden_recog_1=16, n_hidden_recog_2=16,
            n_hidden_gener_1=16, n_hidden_gener_2=16)
SEEDS = [3, 5, 7]
LRS = [1e-3, 3e-3, 5e-4]
LAMS = [0.5, 1.0, 2.0]
B = 16
TOL = 1e-5


def _cfg(c, **kw):
    return c.AssocConfig([c.ModalityConfig("image", ARCH, recon="bernoulli"),
                          c.ModalityConfig("trajectory", dict(ARCH), recon="gaussian")],
                         assoc_lambda=0.5, **kw)


def _batch(rng, n=B):
    return [rng.uniform(0, 1, (n, 24)).astype(np.float32),
            rng.normal(size=(n, 24)).astype(np.float32)]


def _close(got, want, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)
    assert err <= TOL, (what, err)


def _adam(opt_state):
    return next(s for s in jax.tree.leaves(
        opt_state, is_leaf=lambda s: isinstance(s, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState))


JTC = jcfg.TrainConfig(batch_size=B, grad_clip_norm=5.0)
TTC = tcfg.TrainConfig(batch_size=B, grad_clip_norm=5.0)


@functools.lru_cache(maxsize=None)
def _jax_state():
    """A JAX sweep state one JAX sweep step in, as numpy."""
    cfg = _cfg(jcfg)
    state = jsw.init_sweep_state(cfg, JTC, SEEDS)
    state, _ = jsw.make_sweep_step(cfg, JTC)(state, [jnp.asarray(x) for x in
                                                    _batch(np.random.default_rng(9))])
    return jax.tree.map(np.asarray, state._replace(rng=jax.random.key_data(state.rng)))


def test_sweep_state_converts_both_ways_bit_for_bit():
    js = _jax_state()
    a = _adam(js.opt_state)
    state = convert.sweep_state_from_jax_numpy(
        js.params, (a.count, a.mu, a.nu), js.step, SEEDS, _cfg(tcfg), TTC, "cpu")
    assert state.step == 1 and state.opt_state.adam.count == 1 and state.seed == tuple(SEEDS)
    params, (count, mu, nu), step = convert.sweep_state_to_jax_numpy(state)
    for got, want in ((params, js.params), (mu, a.mu), (nu, a.nu)):
        for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
            assert g.shape == w.shape and g.shape[0] == 3
            np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(count, a.count)
    np.testing.assert_array_equal(step, js.step)
    with pytest.raises(ValueError, match="lockstep"):
        convert.sweep_state_from_jax_numpy(
            js.params, (np.array([1, 2, 1]), a.mu, a.nu), js.step, SEEDS, _cfg(tcfg), TTC,
            "cpu")


def test_vmapped_steps_match_jax_with_per_model_lr_and_lambda():
    jtc, ttc = JTC, TTC
    js = _jax_state()
    a = _adam(js.opt_state)
    state = convert.sweep_state_from_jax_numpy(js.params, (a.count, a.mu, a.nu), js.step,
                                               SEEDS, _cfg(tcfg), ttc, "cpu")
    jcfg_ = _cfg(jcfg)
    opt = jstep.make_optimizer(dataclasses.replace(jtc, learning_rate=1.0))

    def one(params, opt_state, xs, eps, lr, lam):
        def loss(p):
            total, m = jassoc.assoc_loss_fn(p, xs, jcfg_, eps=eps)
            total = jstep._total_with_lambda(m, jcfg_, lam)
            return total, {**m, "total": total}

        grads, m = jax.grad(loss, has_aux=True)(params)
        updates, opt_state = opt.update(grads, opt_state, params)
        updates = jax.tree.map(lambda u: lr * u, updates)
        return optax.apply_updates(params, updates), opt_state, m

    jone = jax.jit(jax.vmap(one, in_axes=(0, 0, None, 0, 0, 0)))
    jp, jo = js.params, js.opt_state
    step = tsw.make_sweep_step(_cfg(tcfg), ttc, vary_lr=True, vary_assoc=True)
    rng = np.random.default_rng(1)
    lrs, lams = torch.tensor(LRS), torch.tensor(LAMS)
    for _ in range(3):
        xs = _batch(rng)
        eps = [rng.normal(size=(3, B, 4)).astype(np.float32) for _ in range(2)]
        jp, jo, jm = jone(jp, jo, [jnp.asarray(x) for x in xs],
                          [jnp.asarray(e) for e in eps], jnp.asarray(LRS), jnp.asarray(LAMS))
        state, tm = step(state, [torch.from_numpy(x) for x in xs], lrs, lams,
                         eps=[torch.from_numpy(e) for e in eps])
        for k in ("total", "assoc", "recon_image", "kl_trajectory"):
            _close(tm[k].numpy(), jm[k], k)
    assert state.step == 4
    params, (_, mu, nu), _ = convert.sweep_state_to_jax_numpy(state)
    ja = _adam(jo)
    for got, want in ((params, jp), (mu, ja.mu), (nu, ja.nu)):
        for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
            _close(g, w, "leaf")


def test_members_follow_their_standalone_runs():
    cfg, tc = _cfg(tcfg), tcfg.TrainConfig(batch_size=B, grad_clip_norm=5.0)
    state = tsw.init_sweep_state(cfg, tc, SEEDS, device="cpu")
    step = tsw.make_sweep_step(cfg, tc, vary_lr=True, vary_assoc=True)
    rng = np.random.default_rng(2)
    batches = [[torch.from_numpy(x) for x in _batch(rng)] for _ in range(3)]
    for xs in batches:
        state, m = step(state, xs, torch.tensor(LRS), torch.tensor(LAMS))
    for i, (seed, lr, lam) in enumerate(zip(SEEDS, LRS, LAMS)):
        tc_i = dataclasses.replace(tc, seed=seed, learning_rate=lr)
        cfg_i = dataclasses.replace(cfg, assoc_lambda=lam)
        ref = tstep.init_train_state(cfg_i, tc_i, device="cpu")
        f = tstep.make_train_step(cfg_i, tc_i)
        for xs in batches:
            ref, rm = f(ref, xs)
        member = tsw.select_model(state, i)
        assert member.seed == seed and member.step == ref.step == 3
        _close(m["total"][i], rm["total"], "total")
        _close(m["grad_norm"][i], rm["grad_norm"], "grad_norm")
        for g, w in zip(member.params.parameters(), ref.params.parameters()):
            _close(g.detach(), w.detach(), "param")
        for g, w in zip(member.opt_state.adam.nu, ref.opt_state.adam.nu):
            _close(g, w, "nu")


def test_steps_per_call_stacks_metrics_per_model():
    cfg = _cfg(tcfg)
    tc = tcfg.TrainConfig(batch_size=B, steps_per_call=2, kl_anneal_steps=4)
    state = tsw.init_sweep_state(cfg, tc, SEEDS, device="cpu")
    rng = np.random.default_rng(3)
    xs = [torch.from_numpy(np.stack([a, b])) for a, b in zip(_batch(rng), _batch(rng))]
    state, m = tsw.make_sweep_step(cfg, tc)(state, xs)
    assert state.step == 2
    assert all(v.shape == (2, 3) for v in m.values()), {k: v.shape for k, v in m.items()}
    assert m["kl_beta_eff"][0, 0] == 0 and m["kl_beta_eff"][1, 0] > 0


def _refusals(c, sw, pkg):
    cfg = _cfg(c)
    arr = (lambda v: jnp.asarray(v, jnp.float32)) if pkg == "jax" else torch.tensor
    kw = {} if pkg == "jax" else {"device": "cpu"}
    state = sw.init_sweep_state(cfg, c.TrainConfig(batch_size=B), [0, 1, 2], **kw)
    data = _batch(np.random.default_rng(4))
    conv = (lambda x: [jnp.asarray(a) for a in x]) if pkg == "jax" else (
        lambda x: [torch.from_numpy(a) for a in x])
    return {
        "lr_schedule": (lambda: sw.make_sweep_step(
            cfg, c.TrainConfig(lr_schedule="cosine", decay_steps=5), vary_lr=True),
            "constant"),
        "lr_warmup": (lambda: sw.make_sweep_step(
            cfg, c.TrainConfig(warmup_steps=2), vary_lr=True), "constant"),
        "lr_ema": (lambda: sw.make_sweep_step(cfg, c.TrainConfig(ema_decay=0.9),
                                              vary_lr=True), "ema_decay"),
        "extras_count": (lambda: sw.make_sweep_step(cfg, c.TrainConfig(), vary_assoc=True)(
            state, conv(data)), "hyperparameter array"),
        "extras_shape": (lambda: sw.make_sweep_step(cfg, c.TrainConfig(), vary_assoc=True)(
            state, conv(data), arr([1.0, 2.0])), r"shape \(3,\)"),
        "duplicate_seeds": (lambda: sw.init_sweep_state(cfg, c.TrainConfig(), [1, 1], **kw),
                            "duplicate seeds"),
        "no_seeds": (lambda: sw.init_sweep_state(cfg, c.TrainConfig(), [], **kw),
                     "at least one seed"),
        "loop_lrs": (lambda: sw.sweep_loop(cfg, c.TrainConfig(batch_size=4), data,
                                           seeds=[0, 1], learning_rates=[1e-3], epochs=1),
                     "learning_rates must have one entry"),
        "loop_rows": (lambda: sw.sweep_loop(cfg, c.TrainConfig(batch_size=4),
                                            [data[0], data[1][:8]], seeds=[0, 1], epochs=1),
                      "modality 1 has 8 rows"),
        "loop_batch": (lambda: sw.sweep_loop(cfg, c.TrainConfig(batch_size=64), data,
                                             seeds=[0, 1], epochs=1), "batch_size 64 >"),
        "loop_spc": (lambda: sw.sweep_loop(cfg, c.TrainConfig(batch_size=8, steps_per_call=4),
                                           data, seeds=[0, 1], epochs=1),
                     "steps_per_call 4 >"),
    }


REFUSALS = ["lr_schedule", "lr_warmup", "lr_ema", "extras_count", "extras_shape",
            "duplicate_seeds", "no_seeds", "loop_lrs", "loop_rows", "loop_batch", "loop_spc"]


@pytest.mark.parametrize("pkg", ["jax", "torch"])
@pytest.mark.parametrize("case", REFUSALS)
def test_refusals_match_jax(case, pkg):
    c, sw = (jcfg, jsw) if pkg == "jax" else (tcfg, tsw)
    fn, match = _refusals(c, sw, pkg)[case]
    with pytest.raises(ValueError, match=match):
        fn()


def test_port_refuses_remat():
    with pytest.raises(ValueError, match="rematerialize"):
        tsw.make_sweep_step(_cfg(tcfg), tcfg.TrainConfig(remat=True))


def test_sweep_loop_batches_and_history_match_jax(monkeypatch):
    rng = np.random.default_rng(5)
    data = _batch(rng, 40)
    seen = {"jax": [], "torch": []}

    def recorder(pkg, e):
        def make(*a, **kw):
            def step_fn(state, xs, *extras, **kw2):
                seen[pkg].append([np.asarray(x) for x in xs])
                zeros = jnp.zeros(e) if pkg == "jax" else torch.zeros(e)
                return state, {"total": zeros}
            return step_fn
        return make

    for pkg, mod in (("jax", jsw), ("torch", tsw)):
        monkeypatch.setattr(mod, "make_sweep_step", recorder(pkg, 2))
    jtc = jcfg.TrainConfig(batch_size=8, steps_per_call=2, seed=11)
    ttc = tcfg.TrainConfig(batch_size=8, steps_per_call=2, seed=11)
    jsw.sweep_loop(_cfg(jcfg), jtc, data, seeds=[0, 1], epochs=2)
    tsw.sweep_loop(_cfg(tcfg), ttc, data, seeds=[0, 1], epochs=2, device="cpu")
    assert len(seen["jax"]) == len(seen["torch"]) == 4  # 2 calls of 2 steps an epoch
    for j, t in zip(seen["jax"], seen["torch"]):
        for a, b in zip(j, t):
            np.testing.assert_array_equal(a, b)
    monkeypatch.undo()

    _, jh = jsw.sweep_loop(_cfg(jcfg), jtc, data, seeds=[0, 1],
                           assoc_lambdas=[0.5, 1.0], epochs=2)
    _, th = tsw.sweep_loop(_cfg(tcfg), ttc, data, seeds=[0, 1],
                           assoc_lambdas=[0.5, 1.0], epochs=2, device="cpu")
    assert len(jh) == len(th) == 2
    for j, t in zip(jh, th):
        assert sorted(j) == sorted(t)
        for k in j:
            assert np.shape(j[k]) == np.shape(t[k]) == (2,), k
        np.testing.assert_allclose(t["sweep_model_samples_per_sec"],
                                   2 * t["samples_per_sec"])
    assert np.all(th[1]["total"] < th[0]["total"])


# ---------------------------------------------------------------------------
# The data-parallel sweep on 2 gloo ranks
# ---------------------------------------------------------------------------

DPB = 16


def _dp_inputs():
    rng = np.random.default_rng(6)
    xs = [_batch(rng, DPB) for _ in range(2)]
    eps = [[rng.normal(size=(3, DPB, 4)).astype(np.float32) for _ in range(2)]
           for _ in range(2)]
    return xs, eps


DP_CASES = {"global": dict(assoc_form="infonce", assoc_negatives="global"),
            "local": dict(assoc_form="infonce", assoc_negatives="local"),
            "mean_l2": {}}
DP_TC = dict(batch_size=DPB, grad_clip_norm=5.0, kl_anneal_steps=3)


def _dp_worker(rank):
    """Every case's 2 DP sweep steps on this rank's rows, and for local
    negatives each member's port DP step on the same rows and ε."""
    m = mesh.make_mesh(2, device_type="cpu")
    xs, eps = _dp_inputs()
    rows = slice(rank * DPB // 2, (rank + 1) * DPB // 2)
    out = {}
    for name, kw in DP_CASES.items():
        cfg, tc = _cfg(tcfg, **kw), tcfg.TrainConfig(**DP_TC)
        state = tsw.init_dp_sweep_state(cfg, tc, m, SEEDS)
        step = tsw.make_dp_sweep_step(cfg, tc, m, vary_lr=True, vary_assoc=True)
        for x, e in zip(xs, eps):
            state, met = step(state, [torch.from_numpy(a[rows]) for a in x],
                              torch.tensor(LRS), torch.tensor(LAMS),
                              eps=[torch.from_numpy(a[:, rows]) for a in e])
        out[name] = ([p.detach().numpy() for p in state.params.parameters()],
                     {k: v.numpy() for k, v in met.items()})
        if name == "local":
            members = []
            for i, (seed, lr, lam) in enumerate(zip(SEEDS, LRS, LAMS)):
                cfg_i = dataclasses.replace(cfg, assoc_lambda=lam)
                tc_i = dataclasses.replace(tc, seed=seed, learning_rate=lr)
                s = dp.init_dp_train_state(cfg_i, tc_i, m)
                f = dp.make_dp_train_step(cfg_i, tc_i, m)
                for x, e in zip(xs, eps):
                    s, _ = f(s, [torch.from_numpy(a[rows]) for a in x],
                             eps=[torch.from_numpy(a[i, rows]) for a in e])
                members.append([p.detach().numpy() for p in s.params.parameters()])
            out["local_members"] = members
    return out


@pytest.fixture(scope="module")
def dp_ranks():
    return mesh.spawn(_dp_worker, 2, device_type="cpu", timeout_s=240)


@pytest.mark.parametrize("case", ["global", "mean_l2"])
def test_dp_sweep_equals_the_one_process_sweep(dp_ranks, case):
    cfg, tc = _cfg(tcfg, **DP_CASES[case]), tcfg.TrainConfig(**DP_TC)
    state = tsw.init_sweep_state(cfg, tc, SEEDS, device="cpu")
    step = tsw.make_sweep_step(cfg, tc, vary_lr=True, vary_assoc=True)
    xs, eps = _dp_inputs()
    for x, e in zip(xs, eps):
        state, met = step(state, [torch.from_numpy(a) for a in x], torch.tensor(LRS),
                          torch.tensor(LAMS), eps=[torch.from_numpy(a) for a in e])
    want = [p.detach().numpy() for p in state.params.parameters()]
    for res in dp_ranks:
        got, got_m = res[case]
        for g, w in zip(got, want):
            _close(g, w, case)
        _close(got_m["total"], met["total"].numpy(), "total")
    for g, w in zip(dp_ranks[0][case][0], dp_ranks[1][case][0]):
        np.testing.assert_array_equal(g, w)  # the ranks stay replicated


def test_dp_sweep_members_equal_the_dp_step_with_local_negatives(dp_ranks):
    for res in dp_ranks:
        got = res["local"][0]
        for i, member in enumerate(res["local_members"]):
            for g, w in zip(got, member):
                _close(g[i], w, f"member {i}")
