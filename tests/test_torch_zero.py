"""The port's ZeRO layout, under its ZeRO and FSDP names
(vae_assoc_tpu_torch/parallel/zero.py, fsdp.py), and whole-state
checkpoints of sharded states, against the JAX package and the port's DP.

The ranks are gloo processes on the CPU, spawned once per world size
(2 and 4) by a module fixture; each runs every case and hands back numpy
results that the tests hold against the JAX package here (the JAX tests'
8-device mesh cut to 2 or 4 devices). JAX is imported only here.

- Rank r's flat padded slice of every parameter and Adam moment equals
  JAX ``shard_zero_train_state``'s shard r exactly, from the same numpy
  state loaded by ``convert.train_state_from_jax_numpy``.
- The trajectory equals DP's at tests/test_zero.py's tolerances (rtol
  2e-5 on the metrics, rtol 3e-5 / atol 1e-6 on the weights), on the plain
  path and the kernel paths' twins, with clipping and accumulation, and on
  a conv tower.
"""

import dataclasses
import os
import re
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from vae_assoc_tpu_torch import configs as tcfg
from vae_assoc_tpu_torch import convert
from vae_assoc_tpu_torch.parallel import dp, fsdp, mesh, tp, zero
from vae_assoc_tpu_torch.train import step as tstep
from vae_assoc_tpu_torch.utils import checkpoint as ckpt

B = 16
WORLDS = (2, 4)
# Widths the world sizes do not divide, so the slices carry pads.
ARCH = dict(n_input=22, n_z=3, n_hidden_recog_1=13, n_hidden_recog_2=13,
            n_hidden_gener_1=13, n_hidden_gener_2=13)


def _cfg(c):
    return c.AssocConfig([c.ModalityConfig("image", ARCH, recon="bernoulli"),
                          c.ModalityConfig("trajectory", dict(ARCH), recon="gaussian")],
                         assoc_lambda=0.5)


def _conv_cfg(c):
    return c.AssocConfig([c.ModalityConfig("image", dict(ARCH, n_input=784),
                                           recon="bernoulli", encoder="conv_pallas"),
                          c.ModalityConfig("trajectory", dict(ARCH), recon="gaussian")],
                         assoc_lambda=0.5)


def _batches(rng, n=B):
    return [rng.uniform(0, 1, (n, 22)).astype(np.float32),
            rng.normal(size=(n, 22)).astype(np.float32)]


def _jax_state():
    """A JAX train state two steps in (moments nonzero), as numpy."""
    import jax
    import jax.numpy as jnp

    from vae_assoc_tpu import configs as jcfg
    from vae_assoc_tpu.train.step import init_train_state, make_train_step

    cfg, tc = _cfg(jcfg), jcfg.TrainConfig(batch_size=B)
    state = init_train_state(cfg, tc, jax.random.key(3))
    step = make_train_step(cfg, tc)
    rng = np.random.default_rng(1)
    for _ in range(2):
        state, _ = step(state, [jnp.asarray(x) for x in _batches(rng)])
    return state


def _inputs():
    import jax

    st = _jax_state()
    adam = st.opt_state[0]
    rng = np.random.default_rng(5)
    return dict(params=jax.tree.map(np.asarray, st.params),
                adam=(int(adam.count), jax.tree.map(np.asarray, adam.mu),
                      jax.tree.map(np.asarray, adam.nu)),
                step=int(st.step), batches=[_batches(rng) for _ in range(4)],
                data=_batches(rng, 128), conv=[rng.uniform(0, 1, (8, 784)).astype(np.float32),
                                                rng.normal(size=(8, 22)).astype(np.float32)])


def _named(state):
    names = [k for k, _ in state.params.named_parameters()]
    opt = state.opt_state
    out = {("p", k): v.detach().numpy().copy() for k, v in state.params.named_parameters()}
    for tag, lst in (("mu", opt.adam.mu), ("nu", opt.adam.nu), ("ema", opt.ema),
                     ("acc", opt.acc)):
        if lst is not None:
            out.update({(tag, k): t.numpy().copy() for k, t in zip(names, lst)})
    return out


def _pair(m, cfg, tc, batches):
    """DP and ZeRO from one state on the same batches: (DP state, ZeRO
    state gathered, DP metrics, ZeRO metrics)."""
    d_state = dp.init_dp_train_state(cfg, tc, m)
    z_state = zero.init_zero_train_state(cfg, tc, m)
    d_step, z_step = dp.make_dp_train_step(cfg, tc, m), zero.make_zero_train_step(cfg, tc, m)
    dms, zms = [], []
    for xs in batches:
        b = mesh.shard_batch(m, xs)
        d_state, dm = d_step(d_state, b)
        z_state, zm = z_step(z_state, b)
        dms.append({k: float(v) for k, v in dm.items()})
        zms.append({k: float(v) for k, v in zm.items()})
    return (_named(d_state), _named(zero.gather_zero_train_state(z_state, cfg, tc, m)),
            dms, zms)


def _zero_worker(rank, inp, tmp):
    m = mesh.make_mesh(device_type="cpu")
    cfg = _cfg(tcfg)
    tc = tcfg.TrainConfig(batch_size=B, learning_rate=1e-3)
    out = {}
    # The layout against JAX's, and the round trip.
    full = convert.train_state_from_jax_numpy(inp["params"], inp["adam"], inp["step"], cfg,
                                              tcfg.TrainConfig(batch_size=B), "cpu")
    zs = zero.shard_zero_train_state(m, full, cfg, tc)
    names = [k for k, _ in full.params.named_parameters()]
    out["slices"] = {(tag, k): t.numpy().copy() for tag, lst in
                     (("p", zs.params), ("mu", zs.opt_state.adam.mu),
                      ("nu", zs.opt_state.adam.nu)) for k, t in zip(names, lst)}
    out["roundtrip"] = (_named(full), _named(zero.gather_zero_train_state(zs, cfg, tc, m)))
    out["counts"] = (zs.step, zs.opt_state.adam.count)
    # Trajectories against DP.
    for up in (False, True, "mega"):
        out[("pair", up)] = _pair(m, cfg, dataclasses.replace(tc, use_pallas=up),
                                  inp["batches"][:3])
    clip = dataclasses.replace(tc, grad_clip_norm=0.05, accum_steps=2)
    out["clip"] = _pair(m, cfg, clip, inp["batches"])
    out["ema"] = _pair(m, cfg, dataclasses.replace(tc, ema_decay=0.9), inp["batches"][:2])
    conv = _conv_cfg(tcfg)
    out["conv"] = _pair(m, conv, dataclasses.replace(tc, batch_size=8, use_pallas=True),
                        [inp["conv"]])
    zc = zero.init_zero_train_state(conv, tc, m)
    out["conv_slices"] = {k: tuple(t.shape) for k, t in
                          zip([k for k, _ in zero.gather_zero_train_state(zc, conv, tc, m)
                               .params.named_parameters()], zc.params)}
    # steps_per_call = 2 equals two single calls.
    tc2 = dataclasses.replace(tc, steps_per_call=2)
    s1, s2 = zero.init_zero_train_state(cfg, tc, m), zero.init_zero_train_state(cfg, tc2, m)
    step1 = zero.make_zero_train_step(cfg, tc, m)
    for xs in inp["batches"][:2]:
        s1, _ = step1(s1, mesh.shard_batch(m, xs))
    stacked = [np.stack([b[i] for b in inp["batches"][:2]]) for i in range(2)]
    s2, _ = zero.make_zero_train_step(cfg, tc2, m)(
        s2, mesh.shard_batch(m, stacked, leading_scan_axis=True))
    out["spc"] = (_named(zero.gather_zero_train_state(s1, cfg, tc, m)),
                  _named(zero.gather_zero_train_state(s2, cfg, tc2, m)))
    # Resume: gather → save → restore → shard continues the run exactly.
    step = zero.make_zero_train_step(cfg, tc, m)
    s = zero.init_zero_train_state(cfg, tc, m)
    for xs in inp["batches"]:
        s, _ = step(s, mesh.shard_batch(m, xs))
    want = _named(zero.gather_zero_train_state(s, cfg, tc, m))
    s = zero.init_zero_train_state(cfg, tc, m)
    for xs in inp["batches"][:2]:
        s, _ = step(s, mesh.shard_batch(m, xs))
    path = os.path.join(tmp, f"resume{rank}")
    ckpt.save(path, zero.gather_zero_train_state(s, cfg, tc, m))
    restored = ckpt.restore(path, tstep.init_train_state(cfg, tc, device="cpu"))
    s = fsdp.shard_fsdp_train_state(m, restored, cfg, tc)
    for xs in inp["batches"][2:]:
        s, _ = fsdp.make_fsdp_train_step(cfg, tc, m)(s, mesh.shard_batch(m, xs))
    out["resume"] = (want, _named(zero.gather_zero_train_state(s, cfg, tc, m)), s.step)
    # Sharded → single: the checkpoint of a ZeRO state restores on one
    # device bit for bit, and trains on.
    path = os.path.join(tmp, f"sharded{rank}")
    whole = zero.gather_zero_train_state(s, cfg, tc, m)
    ckpt.save(path, whole)
    single = ckpt.restore(path, tstep.init_train_state(cfg, tc, device="cpu"))
    restored = _named(single)  # before the step updates it in place
    _, sm = tstep.make_train_step(cfg, tc)(single, [torch.from_numpy(d[:B]) for d in inp["data"]])
    out["sharded_single"] = (_named(whole), restored, float(sm["total"]))
    # Single → TP and ZeRO: a single-device checkpoint restored into either
    # layout takes the single-device continuation's next step.
    path = os.path.join(tmp, f"single{rank}")
    single = tstep.init_train_state(cfg, tc, device="cpu")
    sstep = tstep.make_train_step(cfg, tc)
    for xs in inp["batches"][:2]:
        single, _ = sstep(single, [torch.from_numpy(x) for x in xs])
    ckpt.save(path, single)
    nxt = inp["batches"][2]
    _, ref = sstep(ckpt.restore(path, tstep.init_train_state(cfg, tc, device="cpu")),
                   [torch.from_numpy(x) for x in nxt])
    tm = tp.make_tp_mesh(device_type="cpu")
    ts = tp.shard_tp_train_state(
        tm, ckpt.restore(path, tstep.init_train_state(cfg, tc, device="cpu")), cfg, tc)
    _, tm_m = tp.make_tp_train_step(cfg, tc, tm)(ts, tp.shard_tp_batch(tm, nxt))
    # A one-rank ZeRO group sees the single device's batch and ε stream but
    # for the rank fold; compare on an injected ε instead.
    eps = [torch.from_numpy(np.random.default_rng(9).normal(size=(B, 3)).astype(np.float32))
           for _ in range(2)]
    _, ref_eps = tstep._one_step(ckpt.restore(path, tstep.init_train_state(
        cfg, tc, device="cpu")), [torch.from_numpy(x) for x in nxt], cfg, tc,
        tstep.make_optimizer(tc), eps=eps)
    zs = zero.shard_zero_train_state(
        m, ckpt.restore(path, tstep.init_train_state(cfg, tc, device="cpu")), cfg, tc)
    _, z_m = zero.make_zero_train_step(cfg, tc, m)(
        zs, mesh.shard_batch(m, nxt), eps=list(mesh.shard_batch(m, eps)))
    out["single_to"] = (float(ref["total"]), float(tm_m["total"]), float(ref_eps["total"]),
                        float(z_m["total"]))
    # The epoch loop learns.
    _, hist = zero.zero_train_loop(cfg, dataclasses.replace(tc, learning_rate=3e-3),
                                   inp["data"], m, epochs=6)
    out["loop"] = [h["total"] for h in hist]
    # Rejections: ZeRO (and FSDP, the same layout) need a 1-D data mesh.
    errs = {}
    for name, mk in (("zero_2d", lambda: zero.make_zero_train_step(
                         cfg, tc, mesh.make_mesh(model_axis="model", model_parallel=2,
                                                 device_type="cpu"))),
                     ("fsdp_2d", lambda: fsdp.make_fsdp_train_step(
                         cfg, tc, mesh.make_mesh(model_axis="model", model_parallel=2,
                                                 device_type="cpu"))),
                     ("fsdp_model", lambda: fsdp.init_fsdp_train_state(
                         cfg, tc, tp.make_tp_mesh(device_type="cpu")))):
        try:
            mk()
            errs[name] = None
        except ValueError as e:
            errs[name] = str(e)
    out["errors"] = errs
    return out


@pytest.fixture(scope="module", params=WORLDS)
def world(request, tmp_path_factory):
    inp = _inputs()
    tmp = str(tmp_path_factory.mktemp(f"zero{request.param}"))
    ranks = mesh.spawn(_zero_worker, request.param, (inp, tmp), device_type="cpu",
                       timeout_s=600)
    return SimpleNamespace(w=request.param, ranks=ranks, inp=inp)


def test_zero_slices_equal_jax_shards(world):
    from vae_assoc_tpu import configs as jcfg
    from vae_assoc_tpu.parallel import make_mesh as jax_make_mesh
    from vae_assoc_tpu.parallel import shard_zero_train_state as jax_shard

    st = _jax_state()
    cfg, tc = _cfg(jcfg), jcfg.TrainConfig(batch_size=B)
    zs = jax_shard(jax_make_mesh(world.w), st, cfg, tc)
    trees = {"p": zs.params, "mu": zs.opt_state[0].mu, "nu": zs.opt_state[0].nu}
    for tag, tree in trees.items():
        for i, mod in enumerate(tree["modalities"]):
            for net, layers in mod.items():
                for name, leaf in layers.items():
                    for k, arr in leaf.items():
                        key = (tag, f"modalities.{i}.{net}.{name}.{k}")
                        per = arr.shape[0] // world.w
                        shards = {s.index[0].start or 0: np.asarray(s.data)
                                  for s in arr.addressable_shards}
                        for r, res in enumerate(world.ranks):
                            np.testing.assert_array_equal(res["slices"][key], shards[r * per],
                                                          err_msg=f"rank {r} {key}")
    for res in world.ranks:
        assert res["counts"] == (int(st.step), int(st.opt_state[0].count))


def test_zero_gather_shard_roundtrip_bitwise(world):
    for res in world.ranks:
        full, back = res["roundtrip"]
        assert set(full) == set(back)
        for k, v in full.items():
            np.testing.assert_array_equal(back[k], v, err_msg=str(k))


def _assert_matches_dp(pair, rtol_m=2e-5, rtol=3e-5, atol=1e-6, keys=("total", "grad_norm")):
    d, z, dms, zms = pair
    for dm, zm in zip(dms, zms):
        for k in keys:
            np.testing.assert_allclose(zm[k], dm[k], rtol=rtol_m, err_msg=k)
    for k, v in d.items():
        if k[0] == "p":
            np.testing.assert_allclose(z[k], v, rtol=rtol, atol=atol, err_msg=str(k))


@pytest.mark.parametrize("up", [False, True, "mega"], ids=str)
def test_zero_matches_dp_trajectory(world, up):
    for res in world.ranks:
        _assert_matches_dp(res[("pair", up)])


def test_zero_clip_and_accum_match_dp(world):
    for res in world.ranks:
        _assert_matches_dp(res["clip"], keys=("grad_norm",))


def test_zero_ema_matches_dp(world):
    for res in world.ranks:
        d, z, _, _ = res["ema"]
        for k, v in d.items():
            if k[0] == "ema":
                np.testing.assert_allclose(z[k], v, rtol=3e-5, atol=1e-6, err_msg=str(k))


def test_zero_conv_tower(world):
    """Flat slices never look at a leaf's structure: the conv_pallas tower's
    HWIO kernels shard like any leaf, and the kernels' twins train on."""
    for res in world.ranks:
        _assert_matches_dp(res["conv"], keys=("total",))
        # conv1 [3, 3, 1, 32]: 288 values, 288 / W a rank.
        assert res["conv_slices"]["modalities.0.recog.conv1.w"] == (-(-288 // world.w),)


def test_zero_steps_per_call_equals_single_calls(world):
    for res in world.ranks:
        one, two = res["spc"]
        for k, v in one.items():
            if k[0] == "p":
                np.testing.assert_allclose(two[k], v, rtol=1e-6, atol=1e-7, err_msg=str(k))


def test_zero_checkpoint_resume_continuity(world):
    for res in world.ranks:
        want, got, step = res["resume"]
        assert step == 4
        for k, v in want.items():
            if k[0] == "p":
                np.testing.assert_allclose(got[k], v, rtol=1e-6, atol=1e-7, err_msg=str(k))


def test_save_sharded_restore_single(world):
    for res in world.ranks:
        whole, single, total = res["sharded_single"]
        for k, v in whole.items():
            np.testing.assert_array_equal(single[k], v, err_msg=str(k))
        assert np.isfinite(total)


def test_save_single_restore_into_tp_and_zero(world):
    for res in world.ranks:
        ref, tp_total, ref_eps, zero_total = res["single_to"]
        np.testing.assert_allclose(tp_total, ref, rtol=2e-5)
        np.testing.assert_allclose(zero_total, ref_eps, rtol=2e-5)


def test_zero_loop_learns(world):
    for res in world.ranks:
        assert res["loop"][-1] < res["loop"][0], res["loop"]


def test_zero_rejects_non_data_mesh(world):
    for res in world.ranks:
        assert re.search("1-D data mesh", res["errors"]["zero_2d"])


def test_fsdp_misuse_fails_loudly(world):
    """FSDP is the ZeRO layout in the port: the kernels and conv_pallas
    towers ride it (the JAX GSPMD layout rejects those), and a mesh
    without a lone data axis is refused."""
    for res in world.ranks:
        assert re.search("1-D data mesh", res["errors"]["fsdp_2d"])
        assert re.search("'data' axis", res["errors"]["fsdp_model"])


def test_fsdp_param_specs_pad_every_leaf():
    specs = fsdp.fsdp_param_specs(_cfg(tcfg), 4)
    assert specs["modalities.0.recog.h1.w"] == ((22, 13), 72)  # 286 → 288 / 4
    assert specs["modalities.0.recog.out_mean.b"] == ((3,), 1)
