"""The port's tensor-parallel layout (vae_assoc_tpu_torch/parallel/tp.py)
against the JAX package's tp_shard and the port's single-device and DP
steps, Megatron's operators against the single-process product, and the
depth-0 stack that the column-split layers run on the MLP kernels. Under
the package's GSPMD names (``parallel.make_tp_train_step``) the layout
also splits a conv tower's channels and takes ``remat`` and
``parity_mode``: those runs are held against the JAX package's GSPMD
``make_tp_train_step`` from its initial weights with the ε its key draws
(JAX's run on a 4-way model mesh, the same function at any width), and
rank r's conv slices against JAX's shard r.

The ranks are gloo processes on the CPU, spawned once per world size (2
and 4) by a module fixture; each runs every case and hands back numpy
results (the JAX tests' 8-device mesh cut to 2 or 4 devices). JAX is
imported only here. Widths are 21 and the inputs 38 and 35 wide, which
neither world size divides, so every split leaf carries pads.

Tolerances: the trajectories rtol 2e-4 / atol 2e-5, as
tests/test_tp_shard.py (sums of partial products reassociate); against
JAX's GSPMD TP the losses rtol 1e-5 and each weight leaf rtol 2e-4 with an
atol of 2e-4 times the leaf's largest value (two frameworks' convs, as
tests/test_torch_train.py scales its atol per leaf); the operators and the
depth-0 stack fp32 rtol = atol = 1e-5 and bf16 2e-2, as
tests/test_torch_composable.py.
"""

import dataclasses
import re
from types import SimpleNamespace

import numpy as np
import pytest
import torch
import torch.distributed.nn.functional as dist_fn
from torch import nn

from vae_assoc_tpu_torch import configs as tcfg
from vae_assoc_tpu_torch import convert
from vae_assoc_tpu_torch import parallel
from vae_assoc_tpu_torch.kernels import mlp as kmlp
from vae_assoc_tpu_torch.models import networks
from vae_assoc_tpu_torch.parallel import dp, mesh, tp
from vae_assoc_tpu_torch.train import step as tstep

B = 16
WORLDS = (2, 4)
WIDTH = 21
TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def _arch(depth, n_input):
    a = dict(n_input=n_input, n_z=6)
    for i in range(1, depth + 1):
        a[f"n_hidden_recog_{i}"] = WIDTH
        a[f"n_hidden_gener_{i}"] = WIDTH
    return a


def _cfg(c, depth=2, **mod):
    return c.AssocConfig([c.ModalityConfig("image", _arch(depth, 38), recon="bernoulli", **mod),
                          c.ModalityConfig("trajectory", _arch(depth, 35), recon="gaussian",
                                           **mod)],
                         assoc_lambda=0.7)


def _data(rng, n=B):
    return [rng.uniform(0, 1, (n, 38)).astype(np.float32),
            rng.normal(size=(n, 35)).astype(np.float32)]


def _jax_state():
    import jax
    import jax.numpy as jnp

    from vae_assoc_tpu import configs as jcfg
    from vae_assoc_tpu.train.step import init_train_state, make_train_step

    cfg, tc = _cfg(jcfg), jcfg.TrainConfig(batch_size=B)
    state = init_train_state(cfg, tc, jax.random.key(4))
    step = make_train_step(cfg, tc)
    rng = np.random.default_rng(2)
    for _ in range(2):
        state, _ = step(state, [jnp.asarray(x) for x in _data(rng)])
    return state


def _conv_cfg(c, hidden=16):
    """Config 4's shape (tests/test_tp.py): a conv image tower and an MLP
    trajectory tower."""
    img = dict(n_input=784, n_z=4, n_hidden_recog_1=hidden, n_hidden_recog_2=hidden,
               n_hidden_gener_1=hidden, n_hidden_gener_2=hidden)
    return c.AssocConfig([c.ModalityConfig("image", img, recon="bernoulli", encoder="conv"),
                          c.ModalityConfig("trajectory", dict(img, n_input=24),
                                           recon="gaussian")],
                         assoc_lambda=0.5)


# The GSPMD names' cases on the conv config: TrainConfig fields.
CONV_CASES = {"plain": {}, "remat": dict(remat=True), "parity": dict(parity_mode=True)}


def _conv_data(rng, n=B):
    return [rng.uniform(0, 1, (n, 784)).astype(np.float32),
            rng.normal(size=(n, 24)).astype(np.float32)]


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


def _jax_conv_run(case):
    """Three steps of JAX's GSPMD TP on the conv config: its initial
    weights, each step's batch and ε, metrics and the final weights."""
    import jax

    from vae_assoc_tpu import configs as jcfg
    from vae_assoc_tpu.parallel import mesh as jmesh
    from vae_assoc_tpu.parallel import tp as jtp

    cfg, tc = _conv_cfg(jcfg), jcfg.TrainConfig(batch_size=B, **CONV_CASES[case])
    m = jmesh.make_mesh(4, model_axis="model", model_parallel=4)
    state = jtp.init_tp_train_state(cfg, tc, m)
    init = jax.tree.map(np.array, state.params)
    step = jtp.make_tp_train_step(cfg, tc, m)
    rng, key, calls, metrics = np.random.default_rng(21), state.rng, [], []
    for t in range(3):
        xs = _conv_data(rng)
        eps, key = _jax_eps(key, t, cfg, B)
        state, mt = step(state, jtp.shard_tp_batch(m, xs))
        calls.append((xs, eps))
        metrics.append({k: float(v) for k, v in mt.items()})
    return dict(init=init, calls=calls, metrics=metrics,
                final=dict(convert._flatten(jax.tree.map(np.array, state.params))))


def _inputs():
    import jax

    st = _jax_state()
    adam = st.opt_state[0]
    rng = np.random.default_rng(3)
    cond = np.eye(4, dtype=np.float32)[rng.integers(0, 4, B)]
    return dict(params=jax.tree.map(np.asarray, st.params),
                adam=(int(adam.count), jax.tree.map(np.asarray, adam.mu),
                      jax.tree.map(np.asarray, adam.nu)),
                step=int(st.step), xs=_data(rng), cond=cond, data=_data(rng, 64),
                ops=[rng.normal(size=s).astype(np.float32)
                     for s in ((8, 10), (10, 12), (12, 7), (8, 7), (8, 12))],
                conv={case: _jax_conv_run(case) for case in CONV_CASES},
                conv_xs=_conv_data(rng), conv_data=_conv_data(rng, 64))


def _params(state):
    return {k: v.detach().numpy().copy() for k, v in state.params.named_parameters()}


def _single(cfg, tc, xs, steps):
    """The single-device step's metrics and weights after ``steps``."""
    state = tstep.init_train_state(cfg, tc, device="cpu")
    step = tstep.make_train_step(cfg, tc)
    ms = []
    for _ in range(steps):
        state, m = step(state, [torch.from_numpy(x) for x in xs])
        ms.append({k: float(v) for k, v in m.items()})
    return ms, _params(state)


def _tp_run(m, cfg, tc, xs, steps, shard=tp.replicate_batch):
    state = tp.init_tp_train_state(cfg, tc, m)
    step = tp.make_tp_train_step(cfg, tc, m)
    ms = []
    for _ in range(steps):
        state, mt = step(state, shard(m, xs))
        ms.append({k: float(v) for k, v in mt.items()})
    return ms, state


def _pads_zero(state, cfg, m) -> bool:
    """Every pad column of a column-split leaf and pad row of a row-split
    weight is exactly zero on this rank."""
    n, _ = tp._mesh_info(m)
    r = m.get_local_rank(tp.AXIS)
    full = dict(tstep.init_train_state(cfg, tcfg.TrainConfig(), device="cpu")
                .params.named_parameters())
    for (k, d), t in zip(tp.tp_param_specs(cfg).items(), state.params.parameters()):
        if d is None:
            continue
        c = t.shape[d]
        keep = torch.arange(r * c, (r + 1) * c) < full[k].shape[d]
        if t.detach().movedim(d, 0)[~keep].abs().sum() != 0:
            return False
    return True


def _gspmd_conv(m, inp):
    """The GSPMD names on the conv config: JAX's runs continued from its
    initial weights with its ε, the conv slices, pads on a conv config whose
    dense widths the world does not divide, the loop and the refusals."""
    out = {}
    cfg = _conv_cfg(tcfg)
    for case, fields in CONV_CASES.items():
        run, tc = inp["conv"][case], tcfg.TrainConfig(batch_size=B, **fields)
        state = tp.init_tp_train_state(cfg, tc, m,
                                       params=convert.from_jax_numpy(run["init"], cfg, "cpu"))
        if case == "plain":
            out["conv_slices"] = _params(state)
        step, ms = parallel.make_tp_train_step(cfg, tc, m), []
        for xs, eps in run["calls"]:
            state, mt = step(state, tp.replicate_batch(m, xs),
                             eps=[torch.tensor(e) for e in eps])
            ms.append({k: float(v) for k, v in mt.items()})
        out[("conv", case)] = (ms, _params(tp.gather_tp_train_state(state, cfg, tc, m)))
    # Pads: dense widths of 21 over 2 or 4 ranks, against the single-device step.
    c21, tc = _conv_cfg(tcfg, hidden=21), tcfg.TrainConfig(batch_size=B)
    state, step, ms = tp.init_tp_train_state(c21, tc, m), parallel.make_tp_train_step(
        c21, tc, m), []
    for _ in range(3):
        state, mt = step(state, tp.replicate_batch(m, inp["conv_xs"]))
        ms.append({k: float(v) for k, v in mt.items()})
    out["conv_pads"] = (_single(c21, tc, inp["conv_xs"], 3),
                        (ms, _params(tp.gather_tp_train_state(state, c21, tc, m))))
    out["conv_pads_zero"] = _pads_zero(state, c21, m)
    _, hist = parallel.tp_train_loop(cfg, tcfg.TrainConfig(batch_size=8, learning_rate=3e-3),
                                     inp["conv_data"], m, epochs=3)
    out["conv_loop"] = [h["total"] for h in hist]
    pconv = tcfg.AssocConfig([tcfg.ModalityConfig("image", dict(_arch(2, 784)),
                                                  recon="bernoulli", encoder="conv_pallas")])
    tc = tcfg.TrainConfig(batch_size=B)
    errs = {}
    for name, fn in (
            ("conv_pallas", lambda: parallel.make_tp_train_step(pconv, tc, m)),
            ("conv_use_pallas", lambda: parallel.make_tp_train_step(
                cfg, dataclasses.replace(tc, use_pallas=True), m)),
            ("shard_conv", lambda: parallel.tp_shard.make_tp_train_step(cfg, tc, m)),
            ("shard_loop_conv", lambda: parallel.tp_shard.tp_train_loop(
                cfg, tc, inp["conv_data"], m)),
            ("shard_remat", lambda: parallel.tp_shard.make_tp_train_step(
                _cfg(tcfg), dataclasses.replace(tc, remat=True), m)),
            ("shard_parity", lambda: parallel.tp_shard.make_tp_train_step(
                _cfg(tcfg), dataclasses.replace(tc, parity_mode=True), m))):
        try:
            fn()
            errs[name] = None
        except ValueError as e:
            errs[name] = str(e)
    out["gspmd_errors"] = errs
    return out


def _operators(rank, inp, group, w):
    """Grads through g, f and the column gather on this rank's slices, and
    through the library's all_reduce in g's place."""
    x, w1, w2, c, d = (torch.from_numpy(a) for a in inp["ops"])
    h = -(-w1.shape[1] // w)
    w1r = nn.functional.pad(w1, (0, h * w - w1.shape[1]))[:, rank * h:(rank + 1) * h]
    w2r = nn.functional.pad(w2, (0, 0, 0, h * w - w2.shape[0]))[rank * h:(rank + 1) * h]
    out = {}
    for lib in (False, True):
        xr, a, b = (t.clone().requires_grad_() for t in (x, w1r, w2r))
        part = networks.softplus(tp.copy_to_model(xr, group) @ a) @ b
        y = (dist_fn.all_reduce(part, group=group) if lib
             else tp.reduce_from_model(part, group))
        gx, ga, gb = torch.autograd.grad((y * c).sum(), (xr, a, b))
        out["lib" if lib else "row"] = (y.detach().numpy(), gx.numpy(), ga.numpy(), gb.numpy())
    xr, a = x.clone().requires_grad_(), w1r.clone().requires_grad_()
    z = tp.gather_columns(tp.copy_to_model(xr, group) @ a, group, rank)[:, :w1.shape[1]]
    gx, ga = torch.autograd.grad((z * d).sum(), (xr, a))
    out["col"] = (z.detach().numpy(), gx.numpy(), ga.numpy())
    return out


def _tp_worker(rank, inp):
    w = torch.distributed.get_world_size()
    m = tp.make_tp_mesh(device_type="cpu")
    cfg = _cfg(tcfg)
    tc = tcfg.TrainConfig(batch_size=B)
    out = {}
    # The layout against JAX's, and the round trip.
    full = convert.train_state_from_jax_numpy(inp["params"], inp["adam"], inp["step"], cfg,
                                              tc, "cpu")
    ts = tp.shard_tp_train_state(m, full, cfg, tc)
    names = [k for k, _ in full.params.named_parameters()]
    out["slices"] = {**{("p", k): v for k, v in _params(ts).items()},
                     **{(tag, k): t.numpy().copy() for tag, lst in
                        (("mu", ts.opt_state.adam.mu), ("nu", ts.opt_state.adam.nu))
                        for k, t in zip(names, lst)}}
    back = tp.gather_tp_train_state(ts, cfg, tc, m)
    out["roundtrip"] = [(a.detach().numpy(), b.detach().numpy()) for a, b in zip(
        [*full.params.parameters(), *full.opt_state.adam.mu, *full.opt_state.adam.nu],
        [*back.params.parameters(), *back.opt_state.adam.mu, *back.opt_state.adam.nu])]
    # Trajectories against the single-device step (same seed, same ε).
    for depth in (1, 2, 3):
        c = _cfg(tcfg, depth)
        ref = _single(c, tc, inp["xs"], 4)
        ms, st = _tp_run(m, c, tc, inp["xs"], 4)
        out[("traj", depth)] = (ref, (ms, _params(tp.gather_tp_train_state(st, c, tc, m))))
    kern = dataclasses.replace(tc, use_pallas=True)
    ms, st = _tp_run(m, cfg, kern, inp["xs"], 5)
    out["kernel"] = (_single(cfg, tc, inp["xs"], 5),
                     (ms, _params(tp.gather_tp_train_state(st, cfg, kern, m))))
    out["pads_zero"] = _pads_zero(st, cfg, m)
    opts = dataclasses.replace(tc, grad_clip_norm=0.5, accum_steps=2, ema_decay=0.9)
    ms, st = _tp_run(m, cfg, opts, inp["xs"], 6)
    out["opts"] = (_single(cfg, opts, inp["xs"], 6),
                   (ms, _params(tp.gather_tp_train_state(st, cfg, opts, m))))
    cond = _cfg(tcfg, n_cond=4)
    xs_c = inp["xs"] + [inp["cond"]]
    ms, st = _tp_run(m, cond, tc, xs_c, 4)
    out["cond"] = (_single(cond, tc, xs_c, 4),
                   (ms, _params(tp.gather_tp_train_state(st, cond, tc, m))))
    tanh = _cfg(tcfg, transfer="tanh")
    ms, st = _tp_run(m, tanh, kern, inp["xs"], 4)
    out["tanh"] = (_single(tanh, kern, inp["xs"], 4),
                   (ms, _params(tp.gather_tp_train_state(st, tanh, kern, m))))
    # The epoch loop runs and gathers back to the whole shapes.
    spc = dataclasses.replace(tc, batch_size=8, steps_per_call=2)
    st, hist = tp.tp_train_loop(cfg, spc, inp["data"], m, epochs=2)
    out["loop"] = ([h["total"] for h in hist],
                   tuple(tp.gather_tp_train_state(st, cfg, spc, m)
                         .params.modalities[0].recog.h1.w.shape))
    # DP at this world size, for the 2-D mesh of the next world size.
    dmesh = mesh.make_mesh(device_type="cpu")
    for key, t in (("dp", tc), ("dp_opts", opts)):
        d_state, d_step, dms = dp.init_dp_train_state(cfg, t, dmesh), \
            dp.make_dp_train_step(cfg, t, dmesh), []
        for _ in range(4):
            d_state, dm = d_step(d_state, mesh.shard_batch(dmesh, inp["xs"]))
            dms.append({k: float(v) for k, v in dm.items()})
        out[key] = (dms, _params(d_state))
    if w == 4:  # DP × TP on a 2 × 2 mesh
        m2 = tp.make_tp_mesh(4, data_parallel=2, device_type="cpu")
        out["mesh2"] = (m2.mesh_dim_names, tuple(m2.shape))
        for key, t in (("dptp", tc), ("dptp_opts", opts)):
            ms, st = _tp_run(m2, cfg, t, inp["xs"], 4, shard=tp.shard_tp_batch)
            out[key] = (ms, _params(tp.gather_tp_train_state(st, cfg, t, m2)))
            out[key + "_pads"] = _pads_zero(st, cfg, m2)
        full2 = tp.gather_tp_train_state(st, cfg, opts, m2)
        back2 = tp.gather_tp_train_state(tp.shard_tp_train_state(m2, full2, cfg, opts), cfg,
                                         opts, m2)
        out["roundtrip2"] = [(a.detach().numpy(), b.detach().numpy()) for a, b in zip(
            [*full2.params.parameters(), *full2.opt_state.ema],
            [*back2.params.parameters(), *back2.opt_state.ema])]
        kc = dataclasses.replace(kern, learning_rate=3e-3)
        ms, _ = _tp_run(m2, cond, kc, xs_c, 8, shard=tp.shard_tp_batch)
        out["dptp_kernel_cond"] = [x["total"] for x in ms]
        st, hist = tp.tp_train_loop(cfg, spc, inp["data"], m2, epochs=2)
        out["loop2"] = [h["total"] for h in hist]
        try:
            tp.make_tp_mesh(4, data_parallel=3, device_type="cpu")
        except ValueError as e:
            out["err_divisible"] = str(e)
    # Rejections.
    errs = {}
    conv = tcfg.AssocConfig([tcfg.ModalityConfig("image", dict(_arch(2, 784)),
                                                 recon="bernoulli", encoder="conv")])
    pconv = tcfg.AssocConfig([tcfg.ModalityConfig("image", dict(_arch(2, 784)),
                                                  recon="bernoulli", encoder="conv_pallas")])
    for name, fn in (
            ("conv", lambda: tp.make_tp_train_step(conv, tc, m)),
            ("parity", lambda: tp.make_tp_train_step(
                cfg, dataclasses.replace(tc, parity_mode=True), m)),
            ("remat", lambda: tp.make_tp_train_step(cfg, dataclasses.replace(tc, remat=True),
                                                    m)),
            ("data_mesh", lambda: tp.make_tp_train_step(cfg, tc, dmesh)),
            ("init_data_mesh", lambda: tp.init_tp_train_state(cfg, tc, dmesh)),
            ("specs_conv_pallas", lambda: tp.tp_param_specs(pconv))):
        try:
            fn()
            errs[name] = None
        except ValueError as e:
            errs[name] = str(e)
    out["errors"] = errs
    out["ops"] = _operators(rank, inp, m.get_group(tp.AXIS), w)
    out.update(_gspmd_conv(m, inp))
    return out


@pytest.fixture(scope="module")
def worlds():
    inp = _inputs()
    return SimpleNamespace(inp=inp, runs={
        w: mesh.spawn(_tp_worker, w, (inp,), device_type="cpu", timeout_s=600)
        for w in WORLDS})


@pytest.fixture(params=WORLDS)
def world(request, worlds):
    return SimpleNamespace(w=request.param, ranks=worlds.runs[request.param], inp=worlds.inp)


def _close_run(ref, got, keys=None):
    (rms, rp), (gms, gp) = ref, got
    for mr, mg in zip(rms, gms):
        for k in keys or mr:
            np.testing.assert_allclose(mg[k], mr[k], rtol=2e-4, atol=2e-5, err_msg=k)
    for k, v in rp.items():
        np.testing.assert_allclose(gp[k], v, rtol=2e-4, atol=2e-5, err_msg=k)


def test_tp_slices_equal_jax_shards(world):
    from vae_assoc_tpu import configs as jcfg
    from vae_assoc_tpu.parallel import tp_shard as jtp

    st = _jax_state()
    cfg, tc = _cfg(jcfg), jcfg.TrainConfig(batch_size=B)
    ts = jtp.shard_tp_train_state(jtp.make_tp_mesh(world.w), st, cfg, tc)
    dims = tp.tp_param_specs(_cfg(tcfg))
    trees = {"p": ts.params, "mu": ts.opt_state[0].mu, "nu": ts.opt_state[0].nu}
    for tag, tree in trees.items():
        for i, mod in enumerate(tree["modalities"]):
            for net, layers in mod.items():
                for name, leaf in layers.items():
                    for k, arr in leaf.items():
                        key = f"modalities.{i}.{net}.{name}.{k}"
                        d = dims[key]
                        for r, res in enumerate(world.ranks):
                            got = res["slices"][(tag, key)]
                            if d is None:
                                want = np.asarray(arr)
                            else:
                                c = arr.shape[d] // world.w
                                (want,) = [np.asarray(s.data) for s in arr.addressable_shards
                                           if (s.index[d].start or 0) == r * c]
                            np.testing.assert_array_equal(got, want, err_msg=f"{r} {tag} {key}")


def test_tp_gather_shard_roundtrip_bitwise(world):
    for res in world.ranks:
        for a, b in res["roundtrip"] + res.get("roundtrip2", []):
            np.testing.assert_array_equal(b, a)


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_tp_trajectory_matches_single_device(world, depth):
    for res in world.ranks:
        _close_run(*res[("traj", depth)])


def test_tp_kernel_path_matches_single_device_and_pads_stay_zero(world):
    """use_pallas=True runs every block on decode_mlp_fused (its twin here),
    the column-split output layer on the depth-0 stack."""
    for res in world.ranks:
        _close_run(*res["kernel"])
        assert res["pads_zero"]


def test_tp_clip_accum_ema_compose(world):
    for res in world.ranks:
        _close_run(*res["opts"], keys=("grad_norm", "total"))


def test_tp_conditional_matches_single_device(world):
    for res in world.ranks:
        _close_run(*res["cond"])


def test_tp_nonsoftplus_transfer_matches_single_device(world):
    for res in world.ranks:
        _close_run(*res["tanh"], keys=("total",))


def test_tp_train_loop_runs(world):
    for res in world.ranks:
        totals, shape = res["loop"]
        assert len(totals) == 2 and np.isfinite(totals).all()
        assert shape == (38, WIDTH)


def test_tp_dp_trajectory_matches_plain_dp(worlds):
    """The 2 × 2 mesh at the same global batch follows DP on two ranks:
    the same rows per data shard, the same ε fold (the data rank)."""
    dp_ranks, ranks = worlds.runs[2], worlds.runs[4]
    for res in ranks:
        assert res["mesh2"] == (("data", "model"), (2, 2))
        _close_run(dp_ranks[0]["dp"], res["dptp"])
        assert res["dptp_pads"]


def test_tp_dp_clip_accum_ema_compose_and_pads_stay_zero(worlds):
    dp_ranks, ranks = worlds.runs[2], worlds.runs[4]
    for res in ranks:
        _close_run(dp_ranks[0]["dp_opts"], res["dptp_opts"], keys=("grad_norm", "total"))
        assert res["dptp_opts_pads"]


def test_tp_dp_kernel_path_conditional_learns(worlds):
    for res in worlds.runs[4]:
        totals = res["dptp_kernel_cond"]
        assert np.isfinite(totals).all() and totals[-1] < totals[0], totals
        assert np.isfinite(res["loop2"]).all()


def test_tp_rejections(worlds):
    for w, ranks in worlds.runs.items():
        for res in ranks:
            e = res["errors"]
            assert re.search("zero", e["conv"])
            assert re.search("parity", e["parity"])
            assert re.search("remat", e["remat"])
            assert re.search("mesh", e["data_mesh"])
            assert re.search("model", e["init_data_mesh"])
            assert re.search("conv", e["specs_conv_pallas"])
    for res in worlds.runs[4]:
        assert re.search("divisible", res["err_divisible"])


def _close_to_jax(ms, params, run):
    for mt, mj in zip(ms, run["metrics"]):
        for k in mj:
            np.testing.assert_allclose(mt[k], mj[k], rtol=1e-5, err_msg=k)
    for k, want in run["final"].items():
        np.testing.assert_allclose(params[k], want, rtol=2e-4, atol=2e-4 * np.abs(want).max(),
                                   err_msg=k)


@pytest.mark.parametrize("case", list(CONV_CASES))
def test_gspmd_tp_conv_tower_matches_jax(world, case):
    """The GSPMD names train config 4's shape, with remat and parity_mode,
    as the JAX package's GSPMD TP does, from its weights with its ε."""
    run = world.inp["conv"][case]
    for res in world.ranks:
        ms, params = res[("conv", case)]
        _close_to_jax(ms, params, run)
        assert params.keys() == world.ranks[0][("conv", case)][1].keys()


def test_gspmd_tp_conv_slices_equal_jax_shards(world):
    """The conv tower's leaves split as JAX's GSPMD conv pattern (conv1 and
    convt1 on cout, conv2 and convt2 on cin, the dense layers column and
    row): rank r's slice is JAX's shard r, tests/test_tp.py's shapes."""
    from vae_assoc_tpu import configs as jcfg
    from vae_assoc_tpu.parallel import mesh as jmesh
    from vae_assoc_tpu.parallel import tp as jtp

    cfg, w = _conv_cfg(jcfg), world.w
    params = jtp.shard_params(jmesh.make_mesh(w, model_axis="model", model_parallel=w),
                              world.inp["conv"]["plain"]["init"], cfg)
    specs = jtp.tp_param_specs(cfg)["modalities"][0]
    dims = tp.tp_param_specs(_conv_cfg(tcfg))
    for net, layers in params["modalities"][0].items():
        for name, leaf in layers.items():
            for k, arr in leaf.items():
                key = f"modalities.0.{net}.{name}.{k}"
                spec = tuple(specs[net][name][k])
                d = dims[key]
                assert d == (spec.index("model") if "model" in spec else None), key
                for r, res in enumerate(world.ranks):
                    got = res["conv_slices"][key]
                    if d is None:
                        want = np.asarray(arr)
                    else:
                        c = arr.shape[d] // w
                        (want,) = [np.asarray(s.data) for s in arr.addressable_shards
                                   if (s.index[d].start or 0) == r * c]
                    np.testing.assert_array_equal(got, want, err_msg=f"{r} {key}")
    shapes = {k: v.shape for k, v in world.ranks[0]["conv_slices"].items()}
    assert shapes["modalities.0.recog.conv1.w"] == (3, 3, 1, 32 // w)
    assert shapes["modalities.0.recog.conv2.w"] == (3, 3, 32 // w, 64)


def test_gspmd_tp_conv_pads_match_single_device(world):
    """Dense widths of 21 carry pads on both world sizes; the padded conv
    tower computes the unpadded function and its pads stay zero."""
    for res in world.ranks:
        _close_run(*res["conv_pads"])
        assert res["conv_pads_zero"]
        assert np.isfinite(res["conv_loop"]).all() and res["conv_loop"][-1] < res["conv_loop"][0]


def test_gspmd_tp_rejections_and_tp_shard_refusals(world):
    """The GSPMD names reject the conv kernels as JAX's GSPMD TP does; the
    tp_shard names keep refusing conv towers, remat and parity_mode."""
    for res in world.ranks:
        e = res["gspmd_errors"]
        assert re.search("conv", e["conv_pallas"])
        assert re.search("use_pallas", e["conv_use_pallas"])
        assert re.search("zero", e["shard_conv"]) and re.search("zero", e["shard_loop_conv"])
        assert re.search("remat", e["shard_remat"])
        assert re.search("parity", e["shard_parity"])


def test_megatron_operators_give_single_process_grads(world):
    """g (all-reduce forward, identity backward), f (identity forward,
    all-reduce backward) and the column gather give each rank the gradient
    of the single-process product: the whole dx, its slices of the weights.
    The library's all_reduce in g's place gives W times the weights'
    gradients (it all-reduces the cotangent of a loss every rank holds)."""
    x, w1, w2, c, d = (torch.from_numpy(a) for a in world.inp["ops"])
    w = world.w
    xs, a, b = (t.clone().requires_grad_() for t in (x, w1, w2))
    y = networks.softplus(xs @ a) @ b
    gx, ga, gb = torch.autograd.grad((y * c).sum(), (xs, a, b))
    xs2, a2 = x.clone().requires_grad_(), w1.clone().requires_grad_()
    z = xs2 @ a2
    gx2, ga2 = torch.autograd.grad((z * d).sum(), (xs2, a2))
    h = -(-w1.shape[1] // w)
    tol = dict(rtol=1e-5, atol=1e-5)
    for r, res in enumerate(world.ranks):
        cols = slice(r * h, min((r + 1) * h, w1.shape[1]))
        y_r, gx_r, ga_r, gb_r = res["ops"]["row"]
        np.testing.assert_allclose(y_r, y.detach().numpy(), **tol)
        np.testing.assert_allclose(gx_r, gx.numpy(), **tol)
        np.testing.assert_allclose(ga_r[:, :cols.stop - cols.start], ga[:, cols].numpy(), **tol)
        np.testing.assert_allclose(gb_r[:cols.stop - cols.start], gb[cols].numpy(), **tol)
        z_r, gx2_r, ga2_r = res["ops"]["col"]
        np.testing.assert_allclose(z_r, z.detach().numpy(), **tol)
        np.testing.assert_allclose(gx2_r, gx2.numpy(), **tol)
        np.testing.assert_allclose(ga2_r[:, :cols.stop - cols.start], ga2[:, cols].numpy(),
                                   **tol)
        _, _, ga_lib, _ = res["ops"]["lib"]
        np.testing.assert_allclose(ga_lib[:, :cols.stop - cols.start],
                                   w * ga[:, cols].numpy(), **tol)


# ---------------------------------------------------------------------------
# The depth-0 stack: a linear layer through decode_mlp_fused and its backward
# ---------------------------------------------------------------------------


class _Linear0(nn.Module):
    """A generator stack with no hidden layer, as decode_mlp_fused reads one."""

    def __init__(self, w, b):
        super().__init__()
        lin = networks.Linear(*w.shape, device="cpu")
        with torch.no_grad():
            lin.w.copy_(torch.from_numpy(w))
            lin.b.copy_(torch.from_numpy(b))
        self.gener = nn.ModuleDict({"out": lin})


@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
def test_depth0_stack_matches_jax(cd, rng):
    import jax
    import jax.numpy as jnp

    from vae_assoc_tpu.models import networks as jnet

    w = rng.normal(size=(21, 38)).astype(np.float32) * 0.3
    b = rng.normal(size=38).astype(np.float32)
    z = rng.normal(size=(13, 21)).astype(np.float32)
    ct = rng.normal(size=(13, 38)).astype(np.float32)
    jdt = jnp.float32 if cd == "float32" else jnp.bfloat16

    def f(p, z):
        return jnet.decode_mlp(p, z, compute_dtype=jdt)

    p = {"gener": {"out": {"w": jnp.asarray(w), "b": jnp.asarray(b)}}}
    want, vjp = jax.vjp(f, p, jnp.asarray(z))
    gp, gz = vjp(jnp.asarray(ct))
    model = _Linear0(w, b)
    zt = torch.from_numpy(z).requires_grad_()
    with torch.no_grad():
        np.testing.assert_allclose(kmlp.decode_mlp_fused(model, zt, compute_dtype=cd).numpy(),
                                   np.asarray(want), rtol=TOL[cd], atol=TOL[cd])
    got = kmlp.decode_mlp_fused(model, zt, compute_dtype=cd)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=TOL[cd], atol=TOL[cd])
    dz, dw, db = torch.autograd.grad(got, (zt, model.gener["out"].w, model.gener["out"].b),
                                     torch.from_numpy(ct))
    scale = float(np.abs(np.asarray(gp["gener"]["out"]["w"])).max())
    np.testing.assert_allclose(dz.numpy(), np.asarray(gz), rtol=TOL[cd], atol=TOL[cd])
    np.testing.assert_allclose(dw.numpy(), np.asarray(gp["gener"]["out"]["w"]), rtol=TOL[cd],
                               atol=TOL[cd] * scale)
    np.testing.assert_allclose(db.numpy(), np.asarray(gp["gener"]["out"]["b"]), rtol=TOL[cd],
                               atol=TOL[cd])
    # Without dz the twin computes the weight grads alone, the same bits.
    grads, none = kmlp.decode_bwd([], model.gener["out"], zt, torch.from_numpy(ct),
                                  compute_dtype=cd, want_dx=False)
    assert none is None
    torch.testing.assert_close(grads[0][0], dw, rtol=0, atol=0)


def test_depth0_stack_plans():
    """The stack kernels' plans take a stack with no hidden layer."""
    assert kmlp.stack_bwd_plan([], 1024, 132) == kmlp.stack_bwd_plan([500], 1024, 132)
    assert kmlp.stack_fwd_plan((784,), 64, 132)[0] == 16
    x = torch.zeros(4, 21)
    kmlp._check_stack(x, [], [SimpleNamespace(w=torch.zeros(21, 38), b=torch.zeros(38))])
    with pytest.raises(ValueError, match="chain from width 21"):
        kmlp._check_stack(x, [], [SimpleNamespace(w=torch.zeros(20, 38), b=torch.zeros(38))])
