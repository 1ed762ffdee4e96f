"""The conv-tower megakernel (kernels/conv_mega.py), the joint objective on a
config-4-shaped model and its training step, against the JAX package.

A config-4-shaped model is the conv image tower (28×28, 32 and 64
channels) with its dense widths cut to 40-48 and n_z 8, beside a small MLP
trajectory tower. Inputs and ε come from a numpy seed and go to both
packages. The JAX side runs its Pallas kernels in interpret mode under
jax.jit, the port its plain twins. Tolerances: fp32 values rtol 1e-5, atol
1e-4; gradients summed over the batch atol 1e-5 × max|want|; bf16 against
the JAX Pallas path, 2e-2.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from vae_assoc_tpu import configs as jcfg
from vae_assoc_tpu.kernels import conv_mega as jcm
from vae_assoc_tpu.models import assoc as jassoc
from vae_assoc_tpu.models import conv as jconv
from vae_assoc_tpu.train import step as jstep
from vae_assoc_tpu_torch import configs as tcfg
from vae_assoc_tpu_torch import convert
from vae_assoc_tpu_torch.kernels import _launches
from vae_assoc_tpu_torch.kernels import conv_mega as tcm
from vae_assoc_tpu_torch.models import assoc as tassoc
from vae_assoc_tpu_torch.models import conv as tconv
from vae_assoc_tpu_torch.ops.sampling import philox_normal
from vae_assoc_tpu_torch.train import loop as tloop
from vae_assoc_tpu_torch.train import step as tstep

ARCH = dict(n_input=784, n_z=8, n_hidden_recog_1=48, n_hidden_recog_2=48,
            n_hidden_gener_1=40, n_hidden_gener_2=48)
TRAJ = dict(n_input=24, n_z=8, n_hidden_recog_1=16, n_hidden_recog_2=16,
            n_hidden_gener_1=16, n_hidden_gener_2=16)
RTOL, ATOL = 1e-5, 1e-4
BF16 = 2e-2
OUTS = ("mu", "lv", "recon_term", "kl_term")


def _tower_pair(seed=0):
    jp = jconv.init_conv_vae_params(jax.random.PRNGKey(seed), ARCH)
    cfg = tcfg.AssocConfig([tcfg.ModalityConfig("image", ARCH, encoder="conv_pallas")])
    tp = convert.from_jax_numpy({"modalities": (jax.tree.map(np.asarray, jp),)}, cfg, "cpu")
    return jp, tp.modalities[0]


def _inputs(kind, batch, seed=1):
    r = np.random.default_rng(seed)
    x = (r.uniform(0, 1, (batch, 784)) if kind == "bernoulli"
         else r.normal(size=(batch, 784))).astype(np.float32)
    eps = r.normal(size=(batch, 8)).astype(np.float32)
    cts = [r.normal(size=(batch, 8)).astype(np.float32) for _ in range(2)]
    cts += [r.uniform(0.5, 1.5, batch).astype(np.float32) / batch for _ in range(2)]
    return x, eps, cts


def _close(got, want, rtol=RTOL, atol=ATOL, err_msg=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (err_msg, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol, err_msg=err_msg)


def _assert_trees(got: dict, want: dict, rtol):
    assert set(got) == set(want)
    for k in want:
        w = np.asarray(want[k])
        np.testing.assert_allclose(got[k], w, rtol=rtol,
                                   atol=rtol * max(float(np.abs(w).max()), 1e-30), err_msg=k)


def _jax_flat(tree):
    return dict(convert._flatten(jax.tree.map(np.asarray, tree)))


def _port_grads(model):
    return {k: p.grad.numpy().copy() for k, p in model.named_parameters()}


# --- the tower kernels' twins -------------------------------------------------------

TWIN_CASES = [(kind, b, "float32") for kind in ("bernoulli", "gaussian") for b in (16, 19)]
TWIN_CASES += [("bernoulli", 19, "bfloat16")]


@pytest.fixture(scope="module")
def tower_fwd_refs():
    """JAX's _conv_tower_fwd outputs and saved activations, per case."""
    jp, _ = _tower_pair()
    flat = jcm.transform_conv_params(jp)
    refs = {}
    for kind, b, cd in TWIN_CASES:
        x, eps, _ = _inputs(kind, b)
        fwd = jax.jit(lambda f, x3, e, kind=kind, cd=cd: jcm._conv_tower_fwd(kind, cd, f, x3, e))
        out, res = fwd(flat, jnp.asarray(x).reshape(b, 28, 28), jnp.asarray(eps))
        refs[(kind, b, cd)] = jax.tree.map(np.asarray, (out, res[3:]))
    return refs


@pytest.mark.parametrize("kind,batch,cd", TWIN_CASES)
@torch.no_grad()
def test_tower_kernel_twins_match_pallas(tower_fwd_refs, kind, batch, cd):
    # conv_enc_plain / conv_dec_plain against the Pallas _enc_kernel and
    # _dec_kernel: every output, the saved activations included (the JAX
    # kernels keep them as [B, h, w·c] rows, the same NHWC order).
    out, (mu, lv, a1, a2, h, g1, g2, d1p, r) = tower_fwd_refs[(kind, batch, cd)]
    _, tp = _tower_pair()
    x, eps, _ = _inputs(kind, batch)
    flat = tcm.flatten(tp)
    x3 = torch.from_numpy(x).reshape(batch, 28, 28)
    got_enc = tcm.conv_enc(flat[:10], x3, compute_dtype=cd)
    z = got_enc[0] + torch.exp(0.5 * got_enc[1]) * torch.from_numpy(eps)
    got_dec = tcm.conv_dec(flat[10:], z, x3, kind=kind, compute_dtype=cd)
    tol = (RTOL, ATOL) if cd == "float32" else (BF16, BF16)
    shapes = {"a1": (batch, 14, 14, 32), "a2": (batch, 7, 7, 64), "g2": (batch, 7, 7, 64),
              "d1p": (batch, 14, 14, 32), "r": (batch, 28, 28, 1)}
    for name, g, w in zip(("mu", "lv", "a1", "a2", "h"), got_enc, (mu, lv, a1, a2, h)):
        assert tuple(g.shape) == shapes.get(name, w.shape), name
        _close(g.reshape(w.shape), w, *tol, err_msg=name)
    for name, g, w in zip(("rec", "g1", "g2", "d1p", "r"), got_dec,
                          (out["recon_term"], g1, g2, d1p, r)):
        assert tuple(g.shape) == shapes.get(name, w.shape), name
        _close(g.reshape(w.shape), w, *tol, err_msg=name)


# --- conv_tower_fused ------------------------------------------------------------------

FUSED_CASES = [("bernoulli", "float32"), ("gaussian", "float32"), ("bernoulli", "bfloat16")]


@pytest.mark.parametrize("kind,cd", FUSED_CASES)
def test_conv_tower_fused_matches_jax(kind, cd):
    # Values and all 18 weight grads against jax.grad through the Pallas
    # tower, for the same ε and upstream cotangents.
    jp, tp = _tower_pair()
    x, eps, cts = _inputs(kind, 13)
    jdt = jnp.dtype(cd)

    def jloss(p):
        o = jcm.conv_tower_fused(p, jnp.asarray(x), kind=kind, eps=jnp.asarray(eps),
                                 compute_dtype=jdt)
        return sum(jnp.sum(o[k] * c) for k, c in zip(OUTS, cts)), o

    (_, jo), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(jp)
    to = tcm.conv_tower_fused(tp, torch.from_numpy(x), kind=kind, eps=torch.from_numpy(eps),
                              compute_dtype=cd)
    sum((to[k] * torch.from_numpy(c)).sum() for k, c in zip(OUTS, cts)).backward()
    tol = RTOL if cd == "float32" else BF16
    for k in OUTS:
        _close(to[k], jo[k], tol, ATOL if cd == "float32" else BF16, err_msg=k)
    got = _port_grads(tp)
    assert len(got) == len(tcm.flatten(tp)) == 18
    _assert_trees(got, _jax_flat(jg), tol)


@pytest.mark.parametrize("kind", ["bernoulli", "gaussian"])
def test_conv_tower_xla_is_the_plain_tower(kind):
    # Config 4's own path: the plain torch convs and the losses, as the
    # reference's conv_tower_xla computes them with XLA convs.
    jp, tp = _tower_pair(2)
    x, eps, cts = _inputs(kind, 9, seed=4)

    def jloss(p):
        o = jcm.conv_tower_xla(p, jnp.asarray(x), kind=kind, eps=jnp.asarray(eps))
        return sum(jnp.sum(o[k] * c) for k, c in zip(OUTS, cts)), o

    (_, jo), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(jp)
    to = tcm.conv_tower_xla(tp, torch.from_numpy(x), kind=kind, eps=torch.from_numpy(eps))
    sum((to[k] * torch.from_numpy(c)).sum() for k, c in zip(OUTS, cts)).backward()
    for k in OUTS:
        _close(to[k], jo[k], err_msg=k)
    _assert_trees(_port_grads(tp), _jax_flat(jg), RTOL)


@pytest.mark.parametrize("tower", ["conv_tower_xla", "conv_tower_fused"])
def test_zero_background_at_zero_bias_matches_jax(tower):
    # An image's zero background under conv1 at its zero initial bias gives
    # pre-activations of exactly 0, where softplus' = σ(0) = ½ (the
    # reference's jax.nn.softplus), not autograd's clamp derivative of 1.
    jp, tp = _tower_pair(3)
    x, eps, cts = _inputs("bernoulli", 6, seed=5)
    x[:, :392] = 0.0  # the top half of every image
    assert not np.asarray(jp["recog"]["conv1"]["b"]).any()

    def jloss(p):
        o = getattr(jcm, tower)(p, jnp.asarray(x), kind="bernoulli", eps=jnp.asarray(eps))
        return sum(jnp.sum(o[k] * c) for k, c in zip(OUTS, cts))

    jg = jax.jit(jax.grad(jloss))(jp)
    o = getattr(tcm, tower)(tp, torch.from_numpy(x), kind="bernoulli", eps=torch.from_numpy(eps))
    sum((o[k] * torch.from_numpy(c)).sum() for k, c in zip(OUTS, cts)).backward()
    _assert_trees(_port_grads(tp), _jax_flat(jg), RTOL)


def test_softplus_gradient_is_sigmoid_at_zero():
    from vae_assoc_tpu_torch.models import networks

    a = np.array([-30.0, -2.0, 0.0, 0.0, 1e-30, 3.0, 40.0], np.float32)
    ta = torch.from_numpy(a).requires_grad_()
    y = networks.softplus(ta)
    y.sum().backward()
    _close(y, jax.nn.softplus(jnp.asarray(a)), 1e-6, 1e-7)
    _close(ta.grad, jax.grad(lambda v: jnp.sum(jax.nn.softplus(v)))(jnp.asarray(a)), 1e-6, 1e-7)
    assert ta.grad[2].item() == 0.5


def test_conv_tower_fused_refuses_an_input_that_requires_grad():
    _, tp = _tower_pair()
    with pytest.raises(ValueError, match="weights only"):
        tcm.conv_tower_fused(tp, torch.rand(3, 784, requires_grad=True), kind="bernoulli", seed=0)
    with pytest.raises(ValueError, match="kind"):
        tcm.conv_tower_fused(tp, torch.rand(3, 784), kind="poisson", seed=0)
    with pytest.raises(ValueError, match="seed"):
        tcm.conv_tower_fused(tp, torch.rand(3, 784), kind="bernoulli")


@torch.no_grad()
def test_seeded_eps_is_the_counter_stream():
    _, tp = _tower_pair()
    x = torch.rand(6, 784)
    a = tcm.conv_tower_fused(tp, x, kind="bernoulli", seed=41)
    b = tcm.conv_tower_fused(tp, x, kind="bernoulli", eps=philox_normal(41, 6, 8, "cpu"))
    c = tcm.conv_tower_xla(tp, x, kind="bernoulli", seed=41)
    for k in OUTS:
        assert torch.equal(a[k], b[k])
        torch.testing.assert_close(c[k], a[k], rtol=1e-5, atol=1e-4)


def test_cpu_tower_path_launches_nothing():
    _, tp = _tower_pair()
    _launches.reset()
    out = tcm.conv_tower_fused(tp, torch.rand(5, 784), kind="gaussian", seed=2)
    (out["recon_term"].sum() + out["kl_term"].sum()).backward()
    assert _launches.snapshot() == {k: 0 for k in _launches.snapshot()}


def test_non_cpu_tensors_never_take_the_plain_path():
    m = tconv.ConvVAE(ARCH, device="meta")
    flat = [t.detach() for t in tcm.flatten(m)]
    x3 = torch.zeros(3, 28, 28, device="meta")
    with pytest.raises(ValueError, match="runs on CUDA"):
        tcm.conv_enc(flat[:10], x3)
    with pytest.raises(ValueError, match="runs on CUDA"):
        tcm.conv_dec(flat[10:], torch.zeros(3, 8, device="meta"), x3, kind="bernoulli")


@pytest.mark.parametrize("batch,cd,rows", [(16384, "float32", 64), (1024, "bfloat16", 16),
                                           (64, "float32", 16), (4096, "bfloat16", 32)])
def test_tower_tile_plans(batch, cd, rows):
    # The encoder: 16, 32 or 64 rows from the batch (the fewest that keep
    # it within one block per SM); shared memory as csrc/conv_mega.cu's
    # enc_smem: conv2's tiled class (fp32: a ring of three 256 × 36 slices,
    # the pixel rows twice and the 288 × 64 weight; bf16: 128-pixel slices,
    # the weight as [64][296] and two rounded 128 × 40 slices) or the dense
    # ring (three stages of a kd × 132 weight and a rows × (kd + 4) a2
    # slice, kd = 32 at 64 rows and 64 below; bf16: and two rounded kd ×
    # 136 + rows × (kd + 8) slices), whichever is larger.
    kd = 32 if rows == 64 else 64
    ring = 4 * 3 * (kd * 132 + rows * (kd + 4))
    if cd == "bfloat16":
        conv2 = 4 * 3 * 128 * 36 + 2 * 16 * 128 + 2 * 64 * 296 + 2 * 2 * 128 * 40
        ring += 2 * 2 * (kd * 136 + rows * (kd + 8))
    else:
        conv2 = 4 * 3 * 256 * 36 + 2 * 16 * 256 + 4 * 288 * 64
    assert tcm.enc_plan(batch, n_sm=132, compute_dtype=cd) == (rows, max(conv2, ring))
    # The decoder: 64 rows a block whatever the batch; its dense stages keep
    # z and g1 (fp32 rows of k + 4; bf16 rows of k + 8; k padded to 32) and
    # a ring of three 32 × 132 fp32 weight slices (bf16: and two rounded
    # 32 × 136 slices); convt1 (a ring of three slices of 256, bf16 128,
    # pixels × 36, the pixel rows twice and the class's weight, bf16 with
    # two rounded slices) fits in the same bytes.
    hg = 500
    kz, kg = 32, -(-hg // 32) * 32
    f32 = max(4 * 64 * (kz + 4 + kg + 4) + 4 * 3 * 32 * 132,
              4 * 3 * 256 * 36 + 2 * 16 * 256 + 4 * 256 * 32)
    b16 = max(2 * 64 * (kz + 8 + kg + 8) + 4 * 3 * 32 * 132 + 2 * 2 * 32 * 136,
              4 * 3 * 128 * 36 + 2 * 16 * 128 + 2 * 32 * 264 + 2 * 2 * 128 * 40)
    assert tcm.dec_plan(hg, 20, "float32") == (64, f32)
    assert tcm.dec_plan(hg, 20, "bfloat16") == (64, b16)


def test_tile_plans_raise_past_one_row():
    # The encoder keeps no per-row buffer in shared memory (a1, a2 and h go
    # through device memory): its plan depends on the batch only, and
    # raises on an empty one.
    assert tcm.enc_plan(1, n_sm=132) == (16, tcm.enc_plan(4096, n_sm=132)[1])
    with pytest.raises(ValueError, match="at least one row"):
        tcm.enc_plan(0, n_sm=132)
    # The decoder's 64-row tile: g1 up to 640 wide in fp32, 1216 in bf16.
    assert tcm.dec_plan(640, 20)[1] <= 232448 - 188
    assert tcm.dec_plan(1216, 20, "bfloat16")[1] <= 232448 - 188
    with pytest.raises(ValueError, match="shared memory"):
        tcm.dec_plan(672, 20)
    with pytest.raises(ValueError, match="shared memory"):
        tcm.dec_plan(1248, 20, "bfloat16")


# --- the joint objective on a config-4-shaped model --------------------------------------


def _configs(encoder, form="mean_l2"):
    out = []
    for c in (jcfg, tcfg):
        out.append(c.AssocConfig(
            [c.ModalityConfig("image", ARCH, recon="bernoulli", encoder=encoder),
             c.ModalityConfig("trajectory", TRAJ, recon="gaussian")],
            assoc_lambda=1.0, assoc_form=form))
    return out


def _models(jc, tc_, seed=0):
    jp = jassoc.init_assoc(jax.random.PRNGKey(seed), jc)
    return jp, convert.from_jax_numpy(jax.tree.map(np.asarray, jp), tc_, "cpu")


def _batch(batch=11, seed=1):
    r = np.random.default_rng(seed)
    xs = [r.uniform(0, 1, (batch, 784)).astype(np.float32),
          r.normal(size=(batch, 24)).astype(np.float32)]
    eps = [r.normal(size=(batch, 8)).astype(np.float32) for _ in range(2)]
    return xs, eps


LOSS_CASES = [(enc, up) for enc in ("conv", "conv_pallas") for up in (False, True, "mega")]


@pytest.mark.parametrize("encoder,use_pallas", LOSS_CASES)
def test_assoc_loss_fn_matches_jax(encoder, use_pallas):
    # Total, metrics and every weight grad; off the mega path (which is
    # differentiable with respect to the weights only) the inputs' grads too.
    jc, tc_ = _configs(encoder)
    jp, tm = _models(jc, tc_)
    xs, eps = _batch()
    jeps = [jnp.asarray(e) for e in eps]
    (jt, jm), (jg, jgx) = jax.jit(jax.value_and_grad(
        lambda p, x: jassoc.assoc_loss_fn(p, x, jc, eps=jeps, use_pallas=use_pallas),
        argnums=(0, 1), has_aux=True))(jp, [jnp.asarray(x) for x in xs])
    with_x = use_pallas != "mega"
    txs = [torch.from_numpy(x).requires_grad_(with_x) for x in xs]
    tt, tmets = tassoc.assoc_loss_fn(tm, txs, tc_, eps=[torch.from_numpy(e) for e in eps],
                                     use_pallas=use_pallas)
    tt.backward()
    assert set(tmets) == set(jm)
    for k in jm:
        np.testing.assert_allclose(tmets[k].item(), float(jm[k]), rtol=RTOL, atol=1e-6, err_msg=k)
    _assert_trees(_port_grads(tm), _jax_flat(jg), RTOL)
    if with_x:
        for tx, gx in zip(txs, jgx):
            _close(tx.grad, gx, RTOL, 1e-5 * float(np.abs(np.asarray(gx)).max()), err_msg="dx")


def test_sample_l2_with_a_conv_tower_falls_back_under_mega():
    # The conv towers do not surface ε, so sample_l2 under "mega" warns and
    # runs the composable kernels in both packages.
    jc, tc_ = _configs("conv_pallas", form="sample_l2")
    assert tassoc.mega_fallback_reason(tc_) == jassoc.mega_fallback_reason(jc) is not None
    jp, tm = _models(jc, tc_)
    xs, eps = _batch(seed=3)
    jeps = [jnp.asarray(e) for e in eps]
    with pytest.warns(jassoc.MegaFallbackWarning, match="composable"):
        (jt, jm), jg = jax.jit(jax.value_and_grad(
            lambda p: jassoc.assoc_loss_fn(p, [jnp.asarray(x) for x in xs], jc, eps=jeps,
                                           use_pallas="mega"), has_aux=True))(jp)
    with pytest.warns(tassoc.MegaFallbackWarning, match="composable"):
        tt, tmets = tassoc.assoc_loss_fn(tm, [torch.from_numpy(x) for x in xs], tc_,
                                         eps=[torch.from_numpy(e) for e in eps],
                                         use_pallas="mega")
    tt.backward()
    for k in jm:
        np.testing.assert_allclose(tmets[k].item(), float(jm[k]), rtol=RTOL, atol=1e-6, err_msg=k)
    _assert_trees(_port_grads(tm), _jax_flat(jg), RTOL)


@pytest.mark.parametrize("encoder", ["conv", "conv_pallas"])
def test_every_path_draws_the_same_eps_from_a_seed(encoder):
    _, tc_ = _configs(encoder)
    _, tm = _models(*_configs(encoder))
    xs = [torch.from_numpy(x) for x in _batch()[0]]
    with torch.no_grad():
        want = tassoc.assoc_loss_fn(tm, xs, tc_, seed=5, use_pallas=False)[1]
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            for up in (True, "mega"):
                got = tassoc.assoc_loss_fn(tm, xs, tc_, seed=5, use_pallas=up)[1]
                for k in want:
                    np.testing.assert_allclose(got[k].item(), want[k].item(), rtol=1e-5,
                                               err_msg=f"{up} {k}")


# --- training ------------------------------------------------------------------------------


def test_training_state_continues_a_jax_run():
    # Three JAX steps of a config-4-shaped model on the mega path with
    # encoder="conv_pallas" (the conv-tower megakernel), the state carried
    # into the port, then three more steps on both sides with the same ε.
    jc, tc_ = _configs("conv_pallas")
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

    batches = [_batch(batch=8, seed=20 + t) for t in range(6)]
    for xs, eps in batches[:3]:
        js, _ = jax_step(js, [jnp.asarray(x) for x in xs], [jnp.asarray(e) for e in eps])
    adam = js.opt_state[0]
    ts = convert.train_state_from_jax_numpy(
        jax.tree.map(np.asarray, js.params),
        (np.asarray(adam.count), jax.tree.map(np.asarray, adam.mu),
         jax.tree.map(np.asarray, adam.nu)),
        np.asarray(js.step), tc_, ttc, "cpu")
    topt = tstep.make_optimizer(ttc)
    for xs, eps in batches[3:]:
        js, jm = jax_step(js, [jnp.asarray(x) for x in xs], [jnp.asarray(e) for e in eps])
        ts, tm = tstep._one_step(ts, [torch.from_numpy(x) for x in xs], tc_,
                                 tcfg.TrainConfig(learning_rate=0.01, use_pallas="mega"), topt,
                                 eps=[torch.from_numpy(e) for e in eps])
        for k in jm:
            np.testing.assert_allclose(tm[k].item(), float(jm[k]), rtol=RTOL, err_msg=k)
    params, (count, mu, nu), step = convert.train_state_to_jax_numpy(ts)
    adam = js.opt_state[0]
    assert int(step) == int(js.step) == 6 and int(count) == int(adam.count) == 6
    for got, want in ((params, js.params), (mu, adam.mu), (nu, adam.nu)):
        _assert_trees(dict(convert._flatten(got)), _jax_flat(want), RTOL)


@pytest.mark.parametrize("encoder,use_pallas", [("conv_pallas", "mega"), ("conv_pallas", True),
                                                ("conv", "mega")])
def test_train_loop_fused_learns_on_a_conv_tower(encoder, use_pallas):
    _, tc_ = _configs(encoder)
    xs = [torch.from_numpy(x) for x in _batch(batch=48)[0]]
    ttc = tcfg.TrainConfig(batch_size=16, steps_per_call=3, use_pallas=use_pallas, seed=4,
                           learning_rate=3e-3)
    s1, h1 = tloop.train_loop_fused(tc_, ttc, xs, epochs=3, device="cpu")
    s2, h2 = tloop.train_loop_fused(tc_, ttc, xs, epochs=3, device="cpu")
    assert s1.step == 9 and [h["total"] for h in h1] == [h["total"] for h in h2]
    assert h1[-1]["total"] < h1[0]["total"]
