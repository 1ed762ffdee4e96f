"""The port's TP × FSDP layout (vae_assoc_tpu_torch/parallel/tp_fsdp.py)
against the JAX package's parallel/tp_fsdp.py and the port's single-device
and DP × TP steps.

The ranks are gloo processes on the CPU, spawned once per world size by a
module fixture: 4 ranks on a 2 × 2 ("data", "model") mesh, 2 ranks on
1 × 2 and 2 × 1 meshes. Each runs every case and hands back numpy results
that the tests hold here against JAX (the JAX tests' 8-device mesh cut to
2 or 4 devices). JAX is imported only here. The latent width 3 and the
input widths 22 and 24 leave leaves that the data axis does not divide:
the port pads them into its flat slices, where JAX keeps such a leaf on
its TP placement.

- Rank (d, m)'s slices equal the rows that the layout's definition (model
  shard m padded over the model group, flattened, padded, slice d) takes
  from JAX's TP × FSDP state after two steps, exactly.
- Three steps from JAX's initial weights with the ε its key draws follow
  JAX's ``make_tp_fsdp_train_step`` (losses rtol 1e-5, each weight leaf
  rtol 2e-4 with an atol of 2e-4 times the leaf's largest value: two
  frameworks' products) and the port's single-device step, and the seeded
  steps follow the port's DP × TP on the same mesh (both at
  tests/test_torch_tp.py's rtol 2e-4 / atol 2e-5: sums of partial products
  reassociate), on the plain path, the kernel path's twins, a conv tower,
  and with clipping, accumulation and EMA.
"""

import dataclasses
import re
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from vae_assoc_tpu_torch import configs as tcfg
from vae_assoc_tpu_torch import convert
from vae_assoc_tpu_torch.parallel import mesh, tp, tp_fsdp
from vae_assoc_tpu_torch.train import step as tstep

B = 16
ARCH = dict(n_input=22, n_z=3, n_hidden_recog_1=16, n_hidden_recog_2=16,
            n_hidden_gener_1=16, n_hidden_gener_2=16)


def _cfg(c, conv=False):
    img = dict(ARCH, n_input=784) if conv else ARCH
    return c.AssocConfig(
        [c.ModalityConfig("image", img, recon="bernoulli", encoder="conv" if conv else "mlp"),
         c.ModalityConfig("trajectory", dict(ARCH, n_input=24), recon="gaussian")],
        assoc_lambda=0.5)


def _data(rng, cfg, n=B):
    return [rng.uniform(0, 1, (n, cfg.modalities[0].arch["n_input"])).astype(np.float32),
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


def _jax_run():
    """JAX's TP × FSDP on a 2 × 2 mesh: its initial weights, three steps'
    batches, ε and metrics, the final weights, and its state after two
    steps as numpy (params, Adam moments)."""
    import jax

    from vae_assoc_tpu import configs as jcfg
    from vae_assoc_tpu.parallel import mesh as jmesh
    from vae_assoc_tpu.parallel import tp_fsdp as jtf

    cfg, tc = _cfg(jcfg), jcfg.TrainConfig(batch_size=B)
    m = jmesh.make_mesh(4, model_axis="model", model_parallel=2)
    state = jtf.init_tp_fsdp_train_state(cfg, tc, m)
    init = jax.tree.map(np.array, state.params)
    step = jtf.make_tp_fsdp_train_step(cfg, tc, m)
    rng, key, calls, metrics = np.random.default_rng(5), state.rng, [], []
    two = None
    for t in range(3):
        if t == 2:
            adam = state.opt_state[0]
            two = (jax.tree.map(np.array, state.params),
                   (int(adam.count), jax.tree.map(np.array, adam.mu),
                    jax.tree.map(np.array, adam.nu)), int(state.step))
        xs = _data(rng, cfg)
        eps, key = _jax_eps(key, t, cfg, B)
        state, mt = step(state, jtf.shard_tp_batch(m, xs))
        calls.append((xs, eps))
        metrics.append({k: float(v) for k, v in mt.items()})
    return dict(init=init, calls=calls, metrics=metrics, two=two,
                final=dict(convert._flatten(jax.tree.map(np.array, state.params))))


def _params(state):
    return {k: v.detach().numpy().copy() for k, v in state.params.named_parameters()}


def _injected(m, cfg, tc, init, calls, make):
    """(metrics, whole weights) of ``make``'s step on ``m`` from the initial
    weights ``init`` with each call's global ε, this rank's rows of it."""
    model = convert.from_jax_numpy(init, cfg, "cpu")
    state = tp_fsdp.init_tp_fsdp_train_state(cfg, tc, m, params=model)
    step, ms = make(cfg, tc, m), []
    for xs, eps in calls:
        state, mt = step(state, tp.shard_tp_batch(m, xs), eps=list(tp.shard_tp_batch(m, eps)))
        ms.append({k: float(v) for k, v in mt.items()})
    return ms, _params(tp_fsdp.gather_tp_fsdp_train_state(state, cfg, tc, m))


def _seeded(m, cfg, tc, batches, init, make, gather):
    """(metrics, whole weights) of ``make``'s step from ``init`` on seeded ε."""
    state, step, ms = init(cfg, tc, m), make(cfg, tc, m), []
    for xs in batches:
        state, mt = step(state, tp.shard_tp_batch(m, xs))
        ms.append({k: float(v) for k, v in mt.items()})
    return ms, _params(gather(state, cfg, tc, m))


def _worker(rank, inp):
    w = torch.distributed.get_world_size()
    out = {}
    cfg, tc = _cfg(tcfg), tcfg.TrainConfig(batch_size=B)
    meshes = ({"2x2": tp.make_tp_mesh(4, data_parallel=2, device_type="cpu")} if w == 4 else
              {"1x2": mesh.make_mesh(2, model_axis="model", model_parallel=2, device_type="cpu"),
               "2x1": mesh.make_mesh(2, model_axis="model", model_parallel=1, device_type="cpu")})
    run = inp["jax"]
    for name, m in meshes.items():
        out[("mesh", name)] = (m.mesh_dim_names, tuple(m.shape))
        out[("jax", name)] = _injected(m, cfg, tc, run["init"], run["calls"],
                                       tp_fsdp.make_tp_fsdp_train_step)
    if w == 2:
        return out
    m = meshes["2x2"]
    # The slices of JAX's state two steps in, and the per-rank state size.
    params, adam, step = run["two"]
    whole = convert.train_state_from_jax_numpy(params, adam, step, cfg, tc, "cpu")
    fs = tp_fsdp.shard_tp_fsdp_train_state(m, whole, cfg, tc)
    keys = [k for k, _ in whole.params.named_parameters()]
    out["slices"] = {(tag, k): t.numpy().copy() for tag, lst in
                     (("p", fs.params), ("mu", fs.opt_state.adam.mu),
                      ("nu", fs.opt_state.adam.nu)) for k, t in zip(keys, lst)}
    out["coords"] = (m.get_local_rank("data"), m.get_local_rank("model"))
    # Against DP × TP on the same mesh, seeded: plain, the kernel twins,
    # a conv tower, and clipping with accumulation and EMA.
    rng = np.random.default_rng(8)
    batches = [_data(rng, cfg) for _ in range(4)]
    conv = _cfg(tcfg, conv=True)
    conv_batches = [_data(rng, conv) for _ in range(3)]
    opts = dataclasses.replace(tc, grad_clip_norm=0.05, accum_steps=2, ema_decay=0.9)
    for key, c, t, xs in (("plain", cfg, tc, batches),
                          ("kernel", cfg, dataclasses.replace(tc, use_pallas=True), batches),
                          ("conv", conv, tc, conv_batches), ("opts", cfg, opts, batches)):
        out[("vs_tp", key)] = (
            _seeded(m, c, t, xs, tp.init_tp_train_state, tp.make_gspmd_tp_train_step,
                    tp.gather_tp_train_state),
            _seeded(m, c, t, xs, tp_fsdp.init_tp_fsdp_train_state,
                    tp_fsdp.make_tp_fsdp_train_step, tp_fsdp.gather_tp_fsdp_train_state))
    # Round trips through gather and shard, with EMA and an accumulator mid-cycle.
    st = tp_fsdp.init_tp_fsdp_train_state(cfg, opts, m)
    step = tp_fsdp.make_tp_fsdp_train_step(cfg, opts, m)
    for xs in batches[:3]:
        st, _ = step(st, tp.shard_tp_batch(m, xs))
    full = tp_fsdp.gather_tp_fsdp_train_state(st, cfg, opts, m)
    again = tp_fsdp.shard_tp_fsdp_train_state(m, full, cfg, opts)
    out["roundtrip_slices"] = [(a.numpy(), b.numpy()) for a, b in zip(
        [*st.params, *st.opt_state.adam.mu, *st.opt_state.ema, *st.opt_state.acc],
        [*again.params, *again.opt_state.adam.mu, *again.opt_state.ema, *again.opt_state.acc])]
    back = tp_fsdp.gather_tp_fsdp_train_state(again, cfg, opts, m)
    out["roundtrip_whole"] = [(a.detach().numpy(), b.detach().numpy()) for a, b in zip(
        [*full.params.parameters(), *full.opt_state.adam.nu, *full.opt_state.acc],
        [*back.params.parameters(), *back.opt_state.adam.nu, *back.opt_state.acc])]
    out["roundtrip_counts"] = (back.step, back.opt_state.adam.count, back.opt_state.mini_step,
                               back.opt_state.ema_count)
    _, hist = tp_fsdp.tp_fsdp_train_loop(
        cfg, tcfg.TrainConfig(batch_size=8, steps_per_call=2, learning_rate=3e-3),
        _data(np.random.default_rng(9), cfg, 64), m, epochs=4)
    out["loop"] = [h["total"] for h in hist]
    errs = {}
    pconv = tcfg.AssocConfig([tcfg.ModalityConfig("image", dict(ARCH, n_input=784),
                                                  recon="bernoulli", encoder="conv_pallas")])
    for name, fn in (
            ("model_mesh", lambda: tp_fsdp.init_tp_fsdp_train_state(
                cfg, tc, tp.make_tp_mesh(device_type="cpu"))),
            ("data_mesh", lambda: tp_fsdp.make_tp_fsdp_train_step(
                cfg, tc, mesh.make_mesh(device_type="cpu"))),
            ("conv_pallas", lambda: tp_fsdp.make_tp_fsdp_train_step(pconv, tc, m)),
            ("conv_use_pallas", lambda: tp_fsdp.make_tp_fsdp_train_step(
                conv, dataclasses.replace(tc, use_pallas=True), m))):
        try:
            fn()
            errs[name] = None
        except ValueError as e:
            errs[name] = str(e)
    out["errors"] = errs
    return out


@pytest.fixture(scope="module")
def worlds():
    inp = dict(jax=_jax_run())
    return SimpleNamespace(inp=inp, runs={
        w: mesh.spawn(_worker, w, (inp,), device_type="cpu", timeout_s=600) for w in (2, 4)})


def _close(ref, got, rtol=2e-4, atol=2e-5, keys=None):
    (rms, rp), (gms, gp) = ref, got
    for mr, mg in zip(rms, gms):
        for k in keys or mr:
            np.testing.assert_allclose(mg[k], mr[k], rtol=rtol, atol=atol, err_msg=k)
    for k, v in rp.items():
        np.testing.assert_allclose(gp[k], v, rtol=rtol, atol=atol, err_msg=k)


def _single(run):
    """The port's single-device step from JAX's initial weights with its ε."""
    cfg, tc = _cfg(tcfg), tcfg.TrainConfig(batch_size=B)
    state = tstep.init_train_state(cfg, tc, device="cpu",
                                   params=convert.from_jax_numpy(run["init"], cfg, "cpu"))
    step, ms = tstep.make_train_step(cfg, tc), []
    for xs, eps in run["calls"]:
        state, mt = step(state, [torch.tensor(x) for x in xs], eps=[torch.tensor(e) for e in eps])
        ms.append({k: float(v) for k, v in mt.items()})
    return ms, _params(state)


@pytest.mark.parametrize("name", ["2x2", "1x2", "2x1"])
def test_tp_fsdp_step_matches_jax_and_single_device(worlds, name):
    run = worlds.inp["jax"]
    single = _single(run)
    ranks = worlds.runs[4 if name == "2x2" else 2]
    for res in ranks:
        d, m = map(int, name.split("x"))
        assert res[("mesh", name)] == (("data", "model"), (d, m))
        ms, params = res[("jax", name)]
        for mt, mj in zip(ms, run["metrics"]):
            for k in mj:
                np.testing.assert_allclose(mt[k], mj[k], rtol=1e-5, err_msg=k)
        for k, want in run["final"].items():
            np.testing.assert_allclose(params[k], want, rtol=2e-4,
                                       atol=2e-4 * np.abs(want).max(), err_msg=k)
        _close(single, res[("jax", name)])


def test_tp_fsdp_slices_equal_jax_rows(worlds):
    """Rank (d, m) holds slice d of model shard m: the layout's rows of JAX's
    TP × FSDP state (weights and Adam moments) after two steps, exactly;
    every leaf is cut, the ones the data axis does not divide padded."""
    params, (_, mu, nu), _ = worlds.inp["jax"]["two"]
    dims = tp.tp_param_specs(_cfg(tcfg))
    trees = {"p": params, "mu": mu, "nu": nu}
    for res in worlds.runs[4]:
        d, m = res["coords"]
        for tag, tree in trees.items():
            for key, arr in convert._flatten(tree):
                a, dim = np.asarray(arr), dims[key]
                if dim is not None:
                    c = -(-a.shape[dim] // 2)
                    pad = [(0, 0)] * a.ndim
                    pad[dim] = (0, 2 * c - a.shape[dim])
                    a = np.take(np.pad(a, pad), np.arange(m * c, (m + 1) * c), axis=dim)
                flat = a.reshape(-1)
                n = -(-flat.size // 2)
                want = np.pad(flat, (0, 2 * n - flat.size))[d * n:(d + 1) * n]
                np.testing.assert_array_equal(res["slices"][(tag, key)], want,
                                              err_msg=f"{d} {m} {tag} {key}")


def test_tp_fsdp_state_bytes_within_bound(worlds):
    """A rank stores 1/(D·M) of each split leaf and 1/D of each replicated
    one, plus pads: at most one row of the split dim per leaf for the
    model pad and one element per leaf for the data pad. The slices' sizes
    are the specs'."""
    cfg = _cfg(tcfg)
    specs = tp_fsdp.tp_fsdp_param_specs(cfg, 2, model_shards=2)
    whole = {k: tuple(p.shape) for k, p in
             tstep.init_train_state(cfg, tcfg.TrainConfig(), device="cpu")
             .params.named_parameters()}
    bound = 0.0
    for (d, _, _), s in zip(specs.values(), whole.values()):
        n = int(np.prod(s))
        bound += (n / 4 + n // s[d] + 1) if d is not None else n / 2 + 1
    total = sum(int(np.prod(s)) for s in whole.values())
    for res in worlds.runs[4]:
        got = {k: v.size for (tag, k), v in res["slices"].items() if tag == "p"}
        assert got == {k: n for k, (_, _, n) in specs.items()}
        assert sum(got.values()) <= bound, (sum(got.values()), bound)
        assert sum(got.values()) < total / 3, (sum(got.values()), total)


@pytest.mark.parametrize("key", ["plain", "kernel", "conv", "opts"])
def test_tp_fsdp_follows_dp_tp(worlds, key):
    """The same mesh, the same seeds: TP × FSDP's reduce-scatter and sliced
    Adam follow DP × TP's all-reduce and whole-shard Adam."""
    for res in worlds.runs[4]:
        ref, got = res[("vs_tp", key)]
        _close(ref, got, keys=("total", "grad_norm") if key == "opts" else None)


def test_tp_fsdp_checkpoint_roundtrips_bitwise(worlds):
    for res in worlds.runs[4]:
        for a, b in res["roundtrip_slices"] + res["roundtrip_whole"]:
            np.testing.assert_array_equal(b, a)
        assert res["roundtrip_counts"] == (3, 1, 1, 1)


def test_tp_fsdp_train_loop_learns(worlds):
    for res in worlds.runs[4]:
        assert np.isfinite(res["loop"]).all() and res["loop"][-1] < res["loop"][0], res["loop"]


def test_tp_fsdp_misuse_fails_loudly(worlds):
    for res in worlds.runs[4]:
        e = res["errors"]
        assert re.search("2-D.*mesh", e["model_mesh"]) and re.search("2-D.*mesh", e["data_mesh"])
        assert re.search("conv", e["conv_pallas"])
        assert re.search("use_pallas", e["conv_use_pallas"])
