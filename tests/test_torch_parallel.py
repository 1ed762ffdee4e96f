"""The port's mesh and data parallelism (vae_assoc_tpu_torch/parallel/mesh.py,
dp.py, and the group argument of train/step.py) against the JAX package.

Each world size's ranks are gloo processes on the CPU, spawned once per
module (``mesh.spawn``) with one thread each; they run every case and hand
back numpy results, which each test below holds against the JAX package in
this process: the counterpart of the JAX tests' 8-device CPU mesh, cut to 2
or 4 ranks. JAX is imported only here, never by the ranks.

The DP gradients, each rank with its rows of an injected ε, are compared
with ``jax.grad`` of JAX's ``assoc_loss_fn(eps=)`` on the global batch (the
``g_ref`` of tests/test_parallel.py) at its rtol 2e-5 / atol 1e-6, for
every ``use_pallas`` setting's CPU path (the kernels' twins; the same
function as JAX's plain path), ``mean_l2`` and InfoNCE with global
negatives; InfoNCE with local negatives against JAX's shard_map DP over a
mesh of as many devices.
"""

import dataclasses
import re
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from vae_assoc_tpu_torch import configs as tcfg
from vae_assoc_tpu_torch import convert
from vae_assoc_tpu_torch.models import assoc as tassoc
from vae_assoc_tpu_torch.parallel import dp, mesh, pp, tp, tp_fsdp, zero
from vae_assoc_tpu_torch.train import step as tstep

B = 16
WORLDS = (2, 4)
SETTINGS = (False, True, "mega")
FORMS = ("mean_l2", "infonce_global")


def _arch(n_input):
    return dict(n_input=n_input, n_z=4, n_hidden_recog_1=16, n_hidden_recog_2=16,
                n_hidden_gener_1=16, n_hidden_gener_2=16)


def _cfg(c, form="mean_l2", negatives="local"):
    return c.AssocConfig(
        [c.ModalityConfig("image", _arch(24), recon="bernoulli"),
         c.ModalityConfig("trajectory", _arch(20), recon="gaussian")],
        assoc_lambda=0.5, assoc_form=form, assoc_negatives=negatives)


def _form(name):
    return {"mean_l2": ("mean_l2", "local"), "infonce_global": ("infonce", "global"),
            "infonce_local": ("infonce", "local")}[name]


def _inputs():
    """Weights from JAX's initializer, a global batch and its ε, as numpy."""
    import jax

    from vae_assoc_tpu import configs as jcfg
    from vae_assoc_tpu.models import assoc as jassoc

    rng = np.random.default_rng(7)
    params = jax.tree.map(np.asarray, jassoc.init_assoc(jax.random.key(0), _cfg(jcfg)))
    xs = [rng.uniform(0, 1, (B, 24)).astype(np.float32),
          rng.normal(size=(B, 20)).astype(np.float32)]
    eps = [rng.normal(size=(B, 4)).astype(np.float32) for _ in range(2)]
    data = [rng.uniform(0, 1, (128, 24)).astype(np.float32),
            rng.normal(size=(128, 20)).astype(np.float32)]
    return dict(params=params, xs=xs, eps=eps, data=data)


def _named(model):
    return {k: v.detach().numpy().copy() for k, v in model.named_parameters()}


def _dp_worker(rank, inp):
    """Every DP case on one rank of a gloo group; numpy results."""
    m = mesh.make_mesh(device_type="cpu")
    group = m.get_group(mesh.DATA_AXIS)
    out = {"rows": mesh.shard_batch(m, [np.arange(B * 3, dtype=np.float32).reshape(B, 3)])[0]
           .numpy()}
    xs = list(mesh.shard_batch(m, inp["xs"]))
    eps = list(mesh.shard_batch(m, inp["eps"]))
    # The gradients of the global batch's mean loss: the rank's loss on its
    # rows, then the step's one all-reduce of the gradients.
    for form in FORMS + ("infonce_local",):
        cfg = _cfg(tcfg, *_form(form))
        for up in SETTINGS if form != "infonce_local" else (False,):
            model = convert.from_jax_numpy(inp["params"], cfg, "cpu")
            names = [k for k, _ in model.named_parameters()]
            total, _ = tassoc.assoc_loss_fn(model, xs, cfg, eps=eps, use_pallas=up,
                                            data_group=group)
            grads = tstep.all_reduce_mean(torch.autograd.grad(total, list(model.parameters())),
                                          group)
            out[("grad", form, up)] = {k: g.numpy().copy() for k, g in zip(names, grads)}
    # One DP step with the injected ε: its metrics are the global batch's.
    cfg = _cfg(tcfg)
    tc = tcfg.TrainConfig(batch_size=B, learning_rate=1e-3)
    state = dp.init_dp_train_state(cfg, tc, m,
                                   params=convert.from_jax_numpy(inp["params"], cfg, "cpu"))
    step = dp.make_dp_train_step(cfg, tc, m)
    _, metrics = step(state, xs, eps=eps)
    out["step_metrics"] = {k: float(v) for k, v in metrics.items()}
    # Three steps from the seed's ε (each rank its own): every rank holds
    # the same weights after them.
    state = dp.init_dp_train_state(cfg, tc, m)
    for _ in range(3):
        state, metrics = step(state, xs)
    out["after_3"] = _named(state.params)
    out["step"] = state.step
    # steps_per_call = 2 on a stack equals two single calls.
    tc2 = dataclasses.replace(tc, steps_per_call=2)
    s1, s2 = dp.init_dp_train_state(cfg, tc, m), dp.init_dp_train_state(cfg, tc2, m)
    two = [np.concatenate([x, x[::-1]]) for x in inp["xs"]]
    for i in range(2):
        s1, _ = step(s1, mesh.shard_batch(m, [x[i * B:(i + 1) * B] for x in two]))
    stacked = [x.reshape(2, B, -1) for x in two]
    s2, m2 = dp.make_dp_train_step(cfg, tc2, m)(
        s2, mesh.shard_batch(m, stacked, leading_scan_axis=True))
    out["spc_single"], out["spc_stacked"] = _named(s1.params), _named(s2.params)
    out["spc_shape"] = tuple(m2["total"].shape)
    # The epoch loop learns, on every rank alike.
    tc3 = tcfg.TrainConfig(batch_size=B, steps_per_call=2, learning_rate=3e-3)
    _, hist = dp.dp_train_loop(cfg, tc3, inp["data"], m, epochs=6)
    out["loop"] = [h["total"] for h in hist]
    out["loop_keys"] = sorted(hist[-1])
    # replicate broadcasts the first rank's tensors.
    t = torch.full((3,), float(rank))
    mesh.replicate(m, {"t": [t]})
    out["replicated"] = t.numpy()
    # The 2-D mesh hook and the multi-host mesh's shape.
    m2d = mesh.make_mesh(model_axis="model", model_parallel=2, device_type="cpu")
    out["mesh2d"] = (m2d.mesh_dim_names, tuple(m2d.shape))
    mh = mesh.make_multihost_mesh(device_type="cpu")
    out["multihost"] = (mh.mesh_dim_names, tuple(mh.shape))
    (rows2d,) = mesh.shard_batch(mh, [np.arange(B, dtype=np.float32)[:, None]],
                                 batch_axes=("replica", "data"))
    out["rows_multihost"] = rows2d.numpy()[:, 0]
    return out


@pytest.fixture(scope="module", params=WORLDS)
def world(request):
    inp = _inputs()
    ranks = mesh.spawn(_dp_worker, request.param, (inp,), device_type="cpu", timeout_s=400)
    return SimpleNamespace(w=request.param, ranks=ranks, inp=inp)


def _g_ref(inp, form, local_mesh=None):
    """JAX's gradient of the global batch's loss with the same ε; with
    ``local_mesh`` the shard_map DP gradient over it (local negatives)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from vae_assoc_tpu import configs as jcfg
    from vae_assoc_tpu.models import assoc as jassoc

    cfg = _cfg(jcfg, *_form(form))
    xs = [jnp.asarray(x) for x in inp["xs"]]
    eps = [jnp.asarray(e) for e in inp["eps"]]

    def loss(p, xs, eps):
        return jassoc.assoc_loss_fn(p, list(xs), cfg, eps=list(eps))[0]

    if local_mesh is None:
        return loss(inp["params"], xs, eps), jax.grad(loss)(inp["params"], xs, eps)
    g = jax.jit(jax.shard_map(
        lambda p, xs, eps: jax.grad(lambda p: jax.lax.pmean(loss(p, xs, eps), "data"))(p),
        mesh=local_mesh, in_specs=(P(), P("data"), P("data")), out_specs=P(),
    ))(inp["params"], xs, eps)
    return None, g


def _jax_named(tree) -> dict:
    out = {}
    for i, mod in enumerate(tree["modalities"]):
        for net, layers in mod.items():
            for name, leaf in layers.items():
                for k, v in leaf.items():
                    out[f"modalities.{i}.{net}.{name}.{k}"] = np.asarray(v)
    return out


@pytest.mark.parametrize("up", SETTINGS, ids=str)
@pytest.mark.parametrize("form", FORMS)
def test_dp_gradient_matches_jax_global_batch(world, form, up):
    _, g = _g_ref(world.inp, form)
    want = _jax_named(g)
    for r, res in enumerate(world.ranks):
        got = res[("grad", form, up)]
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=2e-5, atol=1e-6,
                                       err_msg=f"rank {r} {k}")


def test_dp_infonce_local_matches_jax_shard_map(world):
    from vae_assoc_tpu.parallel import make_mesh as jax_make_mesh

    _, g = _g_ref(world.inp, "infonce_local", jax_make_mesh(world.w))
    want = _jax_named(g)
    for res in world.ranks:
        got = res[("grad", "infonce_local", False)]
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=2e-5, atol=1e-6, err_msg=k)


def test_dp_step_metrics_are_the_global_batch_s(world):
    """One step with the injected ε logs the global batch's loss, and the
    norm of the averaged gradient: the all-reduce runs inside the step."""
    import optax

    loss, g = _g_ref(world.inp, "mean_l2")
    for res in world.ranks:
        m = res["step_metrics"]
        np.testing.assert_allclose(m["total"], float(loss), rtol=2e-5)
        np.testing.assert_allclose(m["grad_norm"], float(optax.global_norm(g)), rtol=2e-5)


def test_dp_ranks_stay_identical(world):
    first = world.ranks[0]["after_3"]
    assert world.ranks[0]["step"] == 3
    for res in world.ranks[1:]:
        for k, v in first.items():
            np.testing.assert_array_equal(res["after_3"][k], v, err_msg=k)
    init = convert.from_jax_numpy(world.inp["params"], _cfg(tcfg), "cpu")
    assert any(not np.array_equal(v, first[k]) for k, v in _named(init).items())


def test_dp_steps_per_call_equals_single_calls(world):
    for res in world.ranks:
        assert res["spc_shape"] == (2,)
        for k, v in res["spc_single"].items():
            np.testing.assert_allclose(res["spc_stacked"][k], v, rtol=1e-6, atol=1e-7)


def test_dp_train_loop_learns(world):
    for res in world.ranks:
        assert res["loop"][-1] < res["loop"][0], res["loop"]
        assert res["loop"] == world.ranks[0]["loop"]
        assert "samples_per_sec_per_chip" in res["loop_keys"]


def test_shard_batch_rows_and_meshes(world):
    """Rank r holds rows [r·B/W, (r+1)·B/W), JAX's P("data") order, on the
    1-D and the multi-host mesh; replicate broadcasts rank 0's values."""
    w = world.w
    full = np.arange(B * 3, dtype=np.float32).reshape(B, 3)
    for r, res in enumerate(world.ranks):
        np.testing.assert_array_equal(res["rows"], full[r * B // w:(r + 1) * B // w])
        np.testing.assert_array_equal(res["rows_multihost"],
                                      np.arange(B)[r * B // w:(r + 1) * B // w])
        np.testing.assert_array_equal(res["replicated"], np.zeros(3))
        assert res["mesh2d"] == (("data", "model"), (w // 2, 2))
        assert res["multihost"] == (("replica", "data"), (1, w))


def test_shard_rows_rejects_an_indivisible_batch():
    with pytest.raises(ValueError, match="not divisible by 4"):
        mesh.shard_rows(10, 0, 4)


@pytest.mark.parametrize("entry", ["make_mesh", "spawn", "init_dp_train_state",
                                   "init_zero_train_state", "init_tp_train_state",
                                   "make_pp_mesh", "init_pp_train_state",
                                   "init_tp_fsdp_train_state"])
def test_parallel_entry_points_default_to_the_card(entry, monkeypatch):
    """Without a GPU the card, the default, raises; nothing falls back to
    the CPU unless the caller names it."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg, tc = _cfg(tcfg), tcfg.TrainConfig(batch_size=B)
    names = {"init_tp_train_state": ("model",), "init_pp_train_state": ("stage",),
             "init_tp_fsdp_train_state": ("data", "model")}.get(entry, ("data",))
    like = SimpleNamespace(device_type="cuda", ndim=len(names), shape=(2,) * len(names),
                           size=lambda *a: 2, mesh_dim_names=names, get_local_rank=lambda *a: 0)
    fns = {"make_mesh": lambda: mesh.make_mesh(),
           "spawn": lambda: mesh.spawn(_dp_worker, 2),
           "init_dp_train_state": lambda: dp.init_dp_train_state(cfg, tc, like),
           "init_zero_train_state": lambda: zero.init_zero_train_state(cfg, tc, like),
           "init_tp_train_state": lambda: tp.init_tp_train_state(cfg, tc, like),
           "make_pp_mesh": lambda: pp.make_pp_mesh(),
           "init_pp_train_state": lambda: pp.init_pp_train_state(cfg, tc, like),
           "init_tp_fsdp_train_state": lambda: tp_fsdp.init_tp_fsdp_train_state(cfg, tc, like)}
    with pytest.raises(RuntimeError, match=re.escape(entry) + r"\(device='cuda'\).*no CUDA"):
        fns[entry]()
