"""The port's pipeline-parallel layout (vae_assoc_tpu_torch/parallel/pp.py)
against the JAX package's parallel/pp.py and the port's single-device and
DP steps, and the ring's shift against a single-process roll.

The ranks are gloo processes on the CPU, spawned once per world size (2
and 4 stages) by a module fixture; each runs every case of its world and
hands back numpy results that the tests hold here against JAX (the JAX
tests' 8-device mesh cut to 2 or 4 devices). JAX is imported only here.
Every case starts from the JAX package's initial weights and injects the
ε the JAX step draws from its key, so the port's PP, JAX's
``make_pp_train_step`` and the port's single-device step take the same
steps. The cases mirror tests/test_pp.py: S = 2 and 4, n_micro 4/8/16,
asymmetric depths, clip + EMA, a conditional model, annealing and
``steps_per_call``.

Tolerances: against the port's single-device step, tests/test_pp.py's
(losses rtol 1e-5, weights rtol 3e-5 / atol 1e-6, optimizer state rtol
1e-4 / atol 1e-6); against JAX, the same on the losses and, on each
weight leaf, rtol 2e-4 with an atol of 2e-4 times the leaf's largest
value (two frameworks' products, as tests/test_torch_train.py scales its
atol per leaf). DP × PP against pure DP at tests/test_pp.py's tolerances;
the layout, its round trip and the ring shift bit for bit.
"""

import dataclasses
import re
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from vae_assoc_tpu_torch import configs as tcfg
from vae_assoc_tpu_torch import convert
from vae_assoc_tpu_torch.ops import collectives
from vae_assoc_tpu_torch.parallel import dp, mesh, pp
from vae_assoc_tpu_torch.train import step as tstep

WORLDS = (2, 4)


def _arch(depth, hidden, n_in, n_z=6):
    a = dict(n_input=n_in, n_z=n_z)
    for k in range(1, depth + 1):
        a[f"n_hidden_recog_{k}"] = hidden
        a[f"n_hidden_gener_{k}"] = hidden
    return a


def _cfg(c, kind="deep"):
    if kind == "asym":  # depths and widths differ per net
        img = dict(n_input=20, n_z=6)
        for k in range(1, 6):
            img[f"n_hidden_recog_{k}"] = 24
        for k in range(1, 10):
            img[f"n_hidden_gener_{k}"] = 16
        mods = [c.ModalityConfig("image", img, recon="bernoulli"),
                c.ModalityConfig("trajectory", _arch(5, 32, 14), recon="gaussian")]
        return c.AssocConfig(mods, assoc_lambda=1.0)
    n_cond = 4 if kind == "cond" else 0
    return c.AssocConfig(
        [c.ModalityConfig("image", _arch(5, 24, 20), recon="bernoulli", n_cond=n_cond),
         c.ModalityConfig("trajectory", _arch(5, 24, 14), recon="gaussian", n_cond=n_cond)],
        assoc_lambda=1.5)


# name → (stages, config kind, TrainConfig fields, n_micro, steps)
CASES = {
    "s2": (2, "deep", dict(batch_size=16), None, 3),
    "micro4": (4, "deep", dict(batch_size=32), 4, 2),
    "micro8": (4, "deep", dict(batch_size=32), None, 3),  # 2·S, the default
    "micro16": (4, "deep", dict(batch_size=32), 16, 2),
    "asym": (4, "asym", dict(batch_size=16), None, 2),
    "clip_ema": (4, "deep", dict(batch_size=32, grad_clip_norm=1.0, ema_decay=0.9), None, 3),
    "cond": (4, "cond", dict(batch_size=32), None, 2),
    "anneal": (4, "deep", dict(batch_size=32, kl_beta=0.5, kl_anneal_steps=4), None, 3),
    "spc": (4, "deep", dict(batch_size=32, steps_per_call=3), None, 2),
}


def _batches(rng, cfg, b, spc=1):
    """One step's (or one stack's) batch list: each modality, then the
    one-hot condition of a conditional model."""
    lead = (b,) if spc == 1 else (spc, b)
    xs = [rng.uniform(0, 1, lead + (m.arch["n_input"],)).astype(np.float32)
          if m.recon == "bernoulli" else
          rng.normal(size=lead + (m.arch["n_input"],)).astype(np.float32)
          for m in cfg.modalities]
    if cfg.n_cond:
        xs.append(np.eye(cfg.n_cond, dtype=np.float32)[rng.integers(0, cfg.n_cond, lead)])
    return xs


def _jax_eps(rng_key, step, cfg, b):
    """The ε that the JAX step at ``step`` draws from the state's key
    (train/step.py::_one_step, models/assoc.py::assoc_forward): the key
    split, the step folded in, one key per modality. Returns (ε list, the
    next key)."""
    import jax

    rng_key, k = jax.random.split(rng_key)
    keys = jax.random.split(jax.random.fold_in(k, step), len(cfg.modalities))
    return [np.asarray(jax.random.normal(kk, (b, m.arch["n_z"])))
            for kk, m in zip(keys, cfg.modalities)], rng_key


def _jax_run(name):
    """JAX's PP on the case: initial weights, the batches and ε of every
    step, each call's metrics and the final weights, all numpy."""
    import jax

    from vae_assoc_tpu import configs as jcfg
    from vae_assoc_tpu.parallel import mesh as jmesh
    from vae_assoc_tpu.parallel import pp as jpp

    s, kind, fields, n_micro, steps = CASES[name]
    cfg, tc = _cfg(jcfg, kind), jcfg.TrainConfig(learning_rate=1e-3, **fields)
    spc, b = tc.steps_per_call, tc.batch_size
    m = jpp.make_pp_mesh(s)
    state = jpp.init_pp_train_state(cfg, tc, m)
    init = jax.tree.map(np.asarray, jpp.gather_pp_train_state(state, cfg, tc, s).params)
    step_fn = jpp.make_pp_train_step(cfg, tc, m, n_micro=n_micro)
    rng, key, t = np.random.default_rng(sum(map(ord, name))), state.rng, 0
    calls, metrics = [], []
    for _ in range(steps):
        xs = _batches(rng, cfg, b, spc)
        eps = []
        for _ in range(spc):
            e, key = _jax_eps(key, t, cfg, b)
            eps.append(e)
            t += 1
        eps = eps[0] if spc == 1 else [np.stack(k) for k in zip(*eps)]
        state, mt = step_fn(state, jmesh.replicate(m, tuple(xs)))
        calls.append((xs, eps))
        metrics.append({k: np.asarray(v) for k, v in mt.items()})
    final = jax.tree.map(np.asarray, jpp.gather_pp_train_state(state, cfg, tc, s).params)
    return dict(init=init, calls=calls, metrics=metrics,
                final=dict(convert._flatten(final)))


def _jax_state():
    """A deep JAX train state two steps in with an EMA (moments and EMA
    nonzero): the state, and its fields as numpy (params, adam, ema, step)."""
    import jax
    import jax.numpy as jnp

    from vae_assoc_tpu import configs as jcfg
    from vae_assoc_tpu.train.step import init_train_state, make_train_step

    cfg, tc = _cfg(jcfg), jcfg.TrainConfig(batch_size=16, ema_decay=0.9)
    state = init_train_state(cfg, tc, jax.random.key(5))
    step = make_train_step(cfg, tc)
    rng = np.random.default_rng(6)
    for _ in range(2):
        state, _ = step(state, [jnp.asarray(x) for x in _batches(rng, cfg, 16)])
    adam, ema = state.opt_state[0][0], state.opt_state[1]
    tree = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    return state, dict(params=tree(state.params),
                       adam=(int(adam.count), tree(adam.mu), tree(adam.nu)),
                       ema=(int(ema.count), tree(ema.ema)), step=int(state.step))


def _port_start(cfg, tc, init):
    """The port's step-0 TrainState on the CPU from JAX's initial weights."""
    return tstep.init_train_state(cfg, tc, device="cpu",
                                  params=convert.from_jax_numpy(init, cfg, "cpu"))


def _port_run(step_fn, state, calls, shard):
    """(metrics per call, state) of ``step_fn`` over the calls with their ε."""
    ms = []
    for xs, eps in calls:
        state, mt = step_fn(state, shard(xs), eps=[torch.tensor(e) for e in eps])
        ms.append({k: v.numpy().copy() for k, v in mt.items()})
    return ms, state


def _named(state):
    return {k: v.detach().numpy().copy() for k, v in state.params.named_parameters()}


def _ring_case(rank, group, n):
    """The ring shift on this rank's x and the gradient of Σ c·shift(x)."""
    rng = np.random.default_rng(100 + rank)
    x = torch.from_numpy(rng.normal(size=(3, 5)).astype(np.float32)).requires_grad_()
    c = torch.from_numpy(rng.normal(size=(3, 5)).astype(np.float32))
    y = collectives.ring_shift(x, group, rank)
    (g,) = torch.autograd.grad((y * c).sum(), x)
    return y.detach().numpy(), g.numpy()


def _rejections(m, w):
    """Every refusal this world can show: {name: message or None}."""
    deep = _cfg(tcfg)
    bad_width = _arch(5, 24, 20)
    bad_width["n_hidden_recog_3"] = 16
    nonuniform = tcfg.AssocConfig([tcfg.ModalityConfig("image", bad_width, recon="bernoulli")])
    conv = tcfg.AssocConfig([
        tcfg.ModalityConfig("image", tcfg.default_image_arch(n_z=6), recon="bernoulli",
                            encoder="conv"),
        tcfg.ModalityConfig("trajectory", _arch(5, 24, 14), recon="gaussian")])
    b32 = tcfg.TrainConfig(batch_size=32)
    cases = {
        "use_pallas": lambda: pp.make_pp_train_step(deep, dataclasses.replace(b32, use_pallas=True),
                                                    m),
        "shallow": lambda: pp.make_pp_train_step(tcfg.AssocConfig(
            [tcfg.ModalityConfig("image", _arch(2, 24, 20), recon="bernoulli")]), b32, m),
        "nonuniform": lambda: pp.make_pp_train_step(nonuniform, b32, m),
        "conv": lambda: pp.make_pp_train_step(conv, b32, m),
        "micro_few": lambda: pp.make_pp_train_step(deep, b32, m, n_micro=w - 1),
        "micro_indivisible": lambda: pp.make_pp_train_step(
            deep, tcfg.TrainConfig(batch_size=30), m, n_micro=8),
        "flat_mesh": lambda: pp.make_pp_train_step(deep, b32, mesh.make_mesh(device_type="cpu")),
        "batch_axes": lambda: pp.shard_pp_batch(m, [np.zeros((4, 2))], batch_axes="data"),
    }
    if w == 4:
        depth6 = tcfg.AssocConfig([tcfg.ModalityConfig("image", _arch(6, 24, 20),
                                                       recon="bernoulli")])
        cases["indivisible_depth"] = lambda: pp.make_pp_train_step(depth6, b32, m)
        m22 = pp.make_pp_mesh(2, data_parallel=2, device_type="cpu")
        cases["dp_batch"] = lambda: pp.make_pp_train_step(
            deep, tcfg.TrainConfig(batch_size=31), m22)
        cases["dp_local_batch"] = lambda: pp.make_pp_train_step(
            deep, tcfg.TrainConfig(batch_size=12), m22)
        cases["dp_devices"] = lambda: pp.make_pp_mesh(4, data_parallel=4, device_type="cpu")
    else:
        cases["one_stage"] = lambda: pp.make_pp_train_step(
            deep, b32, pp.make_pp_mesh(1, data_parallel=2, device_type="cpu"))
    out = {}
    for name, fn in cases.items():
        try:
            fn()
            out[name] = None
        except ValueError as e:
            out[name] = str(e)
    return out


def _pp_worker(rank, inp):
    w = torch.distributed.get_world_size()
    m = pp.make_pp_mesh(device_type="cpu")
    out = {"mesh": (m.mesh_dim_names, tuple(m.shape))}
    # The cases of this world's stage count, from JAX's initial weights.
    for name, run in inp["jax"].items():
        s, kind, fields, n_micro, _ = CASES[name]
        if s != w:
            continue
        cfg, tc = _cfg(tcfg, kind), tcfg.TrainConfig(learning_rate=1e-3, **fields)
        state = pp.shard_pp_train_state(m, _port_start(cfg, tc, run["init"]), cfg, tc)
        ms, state = _port_run(pp.make_pp_train_step(cfg, tc, m, n_micro=n_micro), state,
                              run["calls"], lambda xs: pp.shard_pp_batch(m, xs))
        full = pp.gather_pp_train_state(state, cfg, tc, m)
        out[("case", name)] = (ms, _named(full), None if full.opt_state.ema is None else
                               [t.numpy().copy() for t in full.opt_state.ema])
    # The layout against JAX's shards, and the round trip bit for bit.
    cfg, tc = _cfg(tcfg), tcfg.TrainConfig(batch_size=16, ema_decay=0.9)
    js = inp["state"]
    whole = convert.train_state_from_jax_numpy(js["params"], js["adam"], js["step"], cfg, tc,
                                               "cpu", ema=js["ema"])
    ps = pp.shard_pp_train_state(m, whole, cfg, tc)
    keys = [k for k, _ in ps.params.named_parameters()]
    out["keys"] = keys
    out["slices"] = {(tag, k): t.detach().numpy().copy() for tag, lst in
                     (("p", list(ps.params.parameters())), ("mu", ps.opt_state.adam.mu),
                      ("nu", ps.opt_state.adam.nu), ("ema", ps.opt_state.ema))
                     for k, t in zip(keys, lst)}
    back = pp.gather_pp_train_state(ps, cfg, tc, m)
    out["roundtrip"] = [(a.detach().numpy(), b.detach().numpy()) for a, b in zip(
        [*whole.params.parameters(), *whole.opt_state.adam.mu, *whole.opt_state.adam.nu,
         *whole.opt_state.ema],
        [*back.params.parameters(), *back.opt_state.adam.mu, *back.opt_state.adam.nu,
         *back.opt_state.ema])]
    out["roundtrip_counts"] = (back.step, back.opt_state.adam.count, back.opt_state.ema_count)
    # The restored state trains on identically.
    xs = [torch.from_numpy(x) for x in _batches(np.random.default_rng(7), cfg, 16)]
    step = tstep.make_train_step(cfg, tc)
    m1, m2 = step(whole, xs)[1], step(back, xs)[1]
    out["resume"] = (float(m1["total"]), float(m2["total"]))
    # Pure DP on this world (the 2 × 2 DP × PP of the next world follows it).
    dmesh = mesh.make_mesh(device_type="cpu")
    dp_tc = tcfg.TrainConfig(batch_size=32, learning_rate=1e-3)
    dstate, dstep = dp.init_dp_train_state(cfg, dp_tc, dmesh), dp.make_dp_train_step(cfg, dp_tc,
                                                                                      dmesh)
    dms = []
    for xs in inp["dp_batches"]:
        dstate, dm = dstep(dstate, mesh.shard_batch(dmesh, xs))
        dms.append({k: float(v) for k, v in dm.items()})
    out["dp"] = (dms, _named(dstate))
    if w == 4:  # DP × PP: 2 stages × 2 data shards
        m22 = pp.make_pp_mesh(2, data_parallel=2, device_type="cpu")
        out["mesh22"] = (m22.mesh_dim_names, tuple(m22.shape))
        st, step, pms = pp.init_pp_train_state(cfg, dp_tc, m22), \
            pp.make_pp_train_step(cfg, dp_tc, m22), []
        for xs in inp["dp_batches"]:
            st, pm = step(st, pp.shard_pp_batch(m22, xs))
            pms.append({k: float(v) for k, v in pm.items()})
        out["dppp"] = (pms, _named(pp.gather_pp_train_state(st, cfg, dp_tc, m22)))
        spc_tc = dataclasses.replace(dp_tc, batch_size=16, steps_per_call=2)
        st = pp.init_pp_train_state(cfg, spc_tc, m22)
        out["dppp_mid_shape"] = tuple(st.params.modalities[0].recog.mid.w.shape)
        step, totals = pp.make_pp_train_step(cfg, spc_tc, m22), []
        rng = np.random.default_rng(9)
        for _ in range(2):
            st, pm = step(st, pp.shard_pp_batch(m22, _batches(rng, cfg, 16, spc=2),
                                                leading_scan_axis=True))
            totals.append(pm["total"].numpy().copy())
        out["dppp_spc"] = (totals, st.step)
        # The epoch loop learns.
        loop_tc = tcfg.TrainConfig(batch_size=16, learning_rate=1e-3, steps_per_call=2)
        _, hist = pp.pp_train_loop(cfg, loop_tc, _batches(np.random.default_rng(8), cfg, 64),
                                   m, epochs=4)
        out["loop"] = [h["total"] for h in hist]
    out["ring"] = _ring_case(rank, m.get_group(pp.STAGE_AXIS), w)
    out["errors"] = _rejections(m, w)
    return out


@pytest.fixture(scope="module")
def worlds():
    rng = np.random.default_rng(11)
    jstate, state = _jax_state()
    inp = dict(jax={name: _jax_run(name) for name in CASES}, state=state,
               dp_batches=[_batches(rng, _cfg(tcfg), 32) for _ in range(3)])
    return SimpleNamespace(inp=inp, jstate=jstate, runs={
        w: mesh.spawn(_pp_worker, w, (inp,), device_type="cpu", timeout_s=600)
        for w in WORLDS})


def _close_metrics(got, want, keys=None):
    for mg, mw in zip(got, want):
        for k in keys or mw:
            np.testing.assert_allclose(mg[k], mw[k], rtol=1e-5, err_msg=k)


def _single(name, run):
    """The port's single-device step on the case, from the same weights and ε."""
    _, kind, fields, _, _ = CASES[name]
    cfg, tc = _cfg(tcfg, kind), tcfg.TrainConfig(learning_rate=1e-3, **fields)
    ms, st = _port_run(tstep.make_train_step(cfg, tc), _port_start(cfg, tc, run["init"]),
                       run["calls"], lambda xs: [torch.tensor(x) for x in xs])
    return ms, _named(st), None if st.opt_state.ema is None else [
        t.numpy() for t in st.opt_state.ema]


@pytest.mark.parametrize("name", list(CASES))
def test_pp_step_matches_jax_and_the_single_device_step(worlds, name):
    run = worlds.inp["jax"][name]
    ranks = worlds.runs[CASES[name][0]]
    sms, sparams, sema = _single(name, run)
    for res in ranks:
        ms, params, ema = res[("case", name)]
        _close_metrics(ms, run["metrics"], keys=("total", "assoc"))
        _close_metrics(ms, sms)
        for k, want in run["final"].items():
            np.testing.assert_allclose(params[k], want, rtol=2e-4,
                                       atol=2e-4 * np.abs(want).max(), err_msg=k)
            np.testing.assert_allclose(params[k], sparams[k], rtol=3e-5, atol=1e-6, err_msg=k)
        if ema is not None:
            for a, b in zip(ema, sema):
                np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-6)
        np.testing.assert_array_equal(params["modalities.0.recog.h2.w"],
                                      ranks[0][("case", name)][1]["modalities.0.recog.h2.w"])
    if name == "spc":
        assert ranks[0][("case", name)][0][-1]["total"].shape == (3,)
    if name == "anneal":
        for mg, mw in zip(ranks[0][("case", name)][0], sms):
            np.testing.assert_allclose(mg["kl_beta_eff"], mw["kl_beta_eff"], rtol=1e-6)


@pytest.mark.parametrize("w", WORLDS)
def test_pp_middle_block_equals_jax_shard(worlds, w):
    """Stage s holds shard s of JAX's stacked [S, nper, W, W] middle, of the
    weights, both Adam moments and the EMA; h1 and the heads whole."""
    from vae_assoc_tpu import configs as jcfg
    from vae_assoc_tpu.parallel import pp as jpp

    cfg, tc = _cfg(jcfg), jcfg.TrainConfig(batch_size=16, ema_decay=0.9)
    ps = jpp.shard_pp_train_state(jpp.make_pp_mesh(w), worlds.jstate, cfg, tc)
    trees = {"p": ps.params, "mu": ps.opt_state[0][0].mu, "nu": ps.opt_state[0][0].nu,
             "ema": ps.opt_state[1].ema}
    for r, res in enumerate(worlds.runs[w]):
        assert res["mesh"] == (("stage",), (w,))
        for tag, tree in trees.items():
            flat = dict(convert._flatten(tree))
            assert sorted(flat) == sorted(res["keys"])
            for k, arr in flat.items():
                got = res["slices"][(tag, k)]
                if ".mid." in k:
                    (want,) = [np.asarray(s.data)[0] for s in arr.addressable_shards
                               if s.index[0].start == r]
                else:
                    want = np.asarray(arr)
                np.testing.assert_array_equal(got, want, err_msg=f"{r} {tag} {k}")


@pytest.mark.parametrize("w", WORLDS)
def test_pp_shard_gather_roundtrip_bitwise(worlds, w):
    for res in worlds.runs[w]:
        for a, b in res["roundtrip"]:
            np.testing.assert_array_equal(b, a)
        assert res["roundtrip_counts"] == (2, 2, 2)
        assert res["resume"][0] == res["resume"][1]


def test_dp_pp_equals_pure_dp(worlds):
    """DP × PP (2 stages × 2 data shards) follows pure DP on two ranks: the
    same rows per data shard, the same ε fold, the same gradient mean."""
    (dms, dparams) = worlds.runs[2][0]["dp"]
    for res in worlds.runs[4]:
        assert res["mesh22"] == (("stage", "data"), (2, 2))
        pms, params = res["dppp"]
        for pm, dm in zip(pms, dms):
            np.testing.assert_allclose(pm["total"], dm["total"], rtol=1e-5)
            np.testing.assert_allclose(pm["grad_norm"], dm["grad_norm"], rtol=1e-4)
        for k, v in dparams.items():
            np.testing.assert_allclose(params[k], v, rtol=3e-5, atol=1e-6, err_msg=k)


def test_dp_pp_steps_per_call_and_layout(worlds):
    for res in worlds.runs[4]:
        assert res["dppp_mid_shape"] == (2, 24, 24)  # 4 pipelined layers over 2 stages
        totals, step = res["dppp_spc"]
        assert totals[-1].shape == (2,) and np.isfinite(totals).all() and step == 4


def test_pp_train_loop_learns(worlds):
    for res in worlds.runs[4]:
        assert len(res["loop"]) == 4 and res["loop"][-1] < res["loop"][0], res["loop"]


@pytest.mark.parametrize("w", WORLDS)
def test_ring_shift_is_a_roll(worlds, w):
    """Forward: rank r gets rank r − 1's tensor (a roll by one over the
    ranks); backward: the cotangent rolls back, rank r gets rank r + 1's."""
    ranks = worlds.runs[w]
    xs = np.stack([np.random.default_rng(100 + r).normal(size=(3, 5)).astype(np.float32)
                   for r in range(w)])
    cs = np.stack([np.random.default_rng(100 + r).normal(size=(6, 5)).astype(np.float32)[3:]
                   for r in range(w)])
    ys, gs = np.roll(xs, 1, axis=0), np.roll(cs, -1, axis=0)
    for r, res in enumerate(ranks):
        y, g = res["ring"]
        np.testing.assert_array_equal(y, ys[r])
        np.testing.assert_array_equal(g, gs[r])


@pytest.mark.parametrize("w", WORLDS)
def test_pp_rejections(worlds, w):
    want = {"use_pallas": "use_pallas", "shallow": "depth", "nonuniform": "homogeneous",
            "conv": "MLP", "micro_few": "n_micro", "micro_indivisible": "divisible",
            "flat_mesh": "stage", "batch_axes": "batch placement"}
    if w == 4:
        want.update(indivisible_depth="not divisible", dp_batch="not divisible by the 2-way",
                    dp_local_batch="per-data-shard batch", dp_devices="devices")
    else:
        want.update(one_stage=">= 2 stages")
    for res in worlds.runs[w]:
        assert set(res["errors"]) == set(want)
        for name, pattern in want.items():
            assert res["errors"][name] and re.search(pattern, res["errors"][name]), (
                name, res["errors"][name])
