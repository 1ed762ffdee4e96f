"""The composable training path (use_pallas=True) against the JAX package on
the CPU: the fused joint loss (kernels/loss.py), the decoder backward
(kernels/mlp.py), the fused sampler (kernels/sampling.py) and the slice
through assoc_loss_fn and the train step.

On the CPU the port's wrappers run their plain twins; the JAX side runs its
Pallas kernels in interpret mode, as its own tests do. Both sides get the
same weights (convert.py), inputs made with numpy, and the same ε
(injected: the two packages' random streams differ by design). Tolerances:
fp32 rtol = atol = 1e-5 (another summation order; gradients summed over the
batch take atol = 1e-5 × max|want|); bf16 2e-2 (an activation rounded to
bf16 between layers can land on the other side of a rounding boundary).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from vae_assoc_tpu import configs as jcfg
from vae_assoc_tpu.kernels import loss as jloss
from vae_assoc_tpu.kernels import mlp as jmlp
from vae_assoc_tpu.kernels import sampling as jsampling
from vae_assoc_tpu.models import assoc as jassoc
from vae_assoc_tpu.models import networks as jnet
from vae_assoc_tpu.train import step as jstep
from vae_assoc_tpu_torch import configs as tcfg
from vae_assoc_tpu_torch import convert
from vae_assoc_tpu_torch.kernels import _launches
from vae_assoc_tpu_torch.kernels import loss as tloss
from vae_assoc_tpu_torch.kernels import megakernel as tmk
from vae_assoc_tpu_torch.kernels import mlp as tmlp
from vae_assoc_tpu_torch.kernels import sampling as tsampling
from vae_assoc_tpu_torch.models import assoc as tassoc
from vae_assoc_tpu_torch.models import networks as tnet
from vae_assoc_tpu_torch.ops.sampling import philox_normal
from vae_assoc_tpu_torch.train import step as tstep

TOL = {"float32": 1e-5, "bfloat16": 2e-2}
N_Z = 4
WIDTHS = {"bernoulli": 24, "gaussian": 12}


def _close(got, want, tol, summed=False):
    want = np.asarray(want)
    atol = tol * max(np.abs(want).max(), 1e-30) if summed else tol
    np.testing.assert_allclose(np.asarray(got), want, rtol=tol, atol=atol)


# ---------------------------------------------------------------------------
# The joint loss (rows 6 and 7)
# ---------------------------------------------------------------------------

KIND_SETS = {"b": ("bernoulli",), "g": ("gaussian",), "bg": ("bernoulli", "gaussian"),
             "bgg": ("bernoulli", "gaussian", "gaussian")}


def _loss_inputs(kinds, batch, seed=0):
    r = np.random.default_rng(seed)
    xs = [(r.uniform(0, 1, (batch, WIDTHS[k])) if k == "bernoulli"
           else r.normal(size=(batch, WIDTHS[k]))).astype(np.float32) for k in kinds]
    recons = [(3 * r.normal(size=x.shape)).astype(np.float32) for x in xs]
    mus = [r.normal(size=(batch, N_Z)).astype(np.float32) for _ in kinds]
    lvs = [(0.5 * r.normal(size=(batch, N_Z))).astype(np.float32) for _ in kinds]
    return xs, recons, mus, lvs


@pytest.mark.parametrize("batch", [1, 7, 64, 513])
@pytest.mark.parametrize("with_assoc", [True, False])
@pytest.mark.parametrize("kset", sorted(KIND_SETS))
def test_joint_loss_and_its_vjp_match_pallas(kset, with_assoc, batch):
    kinds = KIND_SETS[kset]
    k = len(kinds)
    args = _loss_inputs(kinds, batch)
    ncols = 2 * k + int(with_assoc)
    g = np.random.default_rng(1).normal(size=(batch, ncols)).astype(np.float32)

    def jfn(*flat):
        parts = [tuple(flat[i * k:(i + 1) * k]) for i in range(4)]
        return jloss.joint_loss_terms_fused(kinds, *parts, with_assoc=with_assoc)

    want, vjp = jax.vjp(jfn, *[jnp.asarray(a) for part in args for a in part])
    want_grads = vjp(jnp.asarray(g))
    ts = [torch.from_numpy(a).requires_grad_() for part in args for a in part]
    got = tloss.joint_loss_terms_fused(kinds, *[ts[i * k:(i + 1) * k] for i in range(4)],
                                       with_assoc=with_assoc)
    assert tuple(got.shape) == (batch, ncols) and got.dtype == torch.float32
    _close(got.detach().numpy(), want, 1e-5)
    got.backward(torch.from_numpy(g))
    for i, (t, w) in enumerate(zip(ts, want_grads)):
        _close(t.grad.numpy(), w, 1e-5)


def test_loss_data_gradient_only_when_asked():
    kinds = ("bernoulli", "gaussian")
    xs, recons, mus, lvs = ([torch.from_numpy(a) for a in part]
                            for part in _loss_inputs(kinds, 9))
    recons = [r.requires_grad_() for r in recons]
    terms = tloss.joint_loss_terms_fused(kinds, xs, recons, mus, lvs)
    terms.sum().backward()
    assert all(x.grad is None for x in xs) and all(r.grad is not None for r in recons)
    # The plain twins are the formulas the kernels compute.
    g = torch.rand(9, 5)
    dr, dm, dl = tloss.loss_terms_bwd_plain(kinds, g, xs, [r.detach() for r in recons],
                                            mus, lvs)
    torch.testing.assert_close(dr[0], (torch.sigmoid(recons[0].detach()) - xs[0]) * g[:, :1])
    torch.testing.assert_close(dm[1], mus[1] * g[:, 3:4] + 2 * (mus[1] - mus[0]) * g[:, 4:])
    torch.testing.assert_close(dl[0], 0.5 * (torch.exp(lvs[0]) - 1) * g[:, 2:3])


# ---------------------------------------------------------------------------
# The decoder backward (row 4)
# ---------------------------------------------------------------------------


def _pair(arch, n_cond=0, seed=0):
    jp = jnet.init_mlp_vae_params(jax.random.PRNGKey(seed), arch, n_cond=n_cond)
    cfg = tcfg.AssocConfig([tcfg.ModalityConfig("m", arch, n_cond=n_cond)])
    model = convert.from_jax_numpy({"modalities": (jax.tree.map(np.asarray, jp),)}, cfg, "cpu")
    return jp, model.modalities[0]


@pytest.mark.parametrize("depth,n_cond,cd", [
    (1, 0, "float32"), (2, 10, "float32"), (3, 10, "float32"),
    (2, 10, "bfloat16"), (3, 0, "bfloat16"),
])
def test_decoder_backward_matches_jax_vjp(depth, n_cond, cd):
    arch = dict(n_input=24, n_z=N_Z, **{f"n_hidden_{n}_{k}": 12 + 4 * k
                                        for n in ("recog", "gener") for k in range(1, depth + 1)})
    jp, tp = _pair(arch, n_cond)
    r = np.random.default_rng(depth)
    z = r.normal(size=(21, N_Z + n_cond)).astype(np.float32)
    dout = r.normal(size=(21, 24)).astype(np.float32)
    want_out, vjp = jax.vjp(
        lambda p, zz: jmlp.decode_mlp_fused(p, zz, compute_dtype=jnp.dtype(cd)), jp, jnp.asarray(z))
    jg, jdz = vjp(jnp.asarray(dout))
    g = tp.gener
    hidden = tnet.hidden_layers(g)
    names = [f"h{i + 1}" for i in range(depth)] + ["out"]
    want = [np.asarray(jg["gener"][n][w]) for n in names for w in ("w", "b")]
    grads, dz = tmlp.decode_bwd_plain(hidden, g["out"], torch.from_numpy(z),
                                      torch.from_numpy(dout), compute_dtype=cd)
    for got, w in zip([t for pair in grads for t in pair], want):
        _close(got.numpy(), w, TOL[cd], summed=True)
    _close(dz.numpy(), jdz, TOL[cd])
    # The same through decode_mlp_fused's autograd Function.
    zt = torch.from_numpy(z).requires_grad_()
    out = tmlp.decode_mlp_fused(tp, zt, compute_dtype=cd)
    _close(out.detach().numpy(), want_out, TOL[cd])
    (out * torch.from_numpy(dout)).sum().backward()
    _close(zt.grad.numpy(), jdz, TOL[cd])
    got = [t.grad.numpy() for l in hidden + [g["out"]] for t in (l.w, l.b)]
    for gt, w in zip(got, want):
        _close(gt, w, TOL[cd], summed=True)


def _ring(rows, bf16):
    # csrc/mlp_bwd.cu's stack_smem: three stages, each a 128 × kd slice of W
    # (read as Wᵀ; rows of kd + 4) and a rows × kd slice of the streamed A,
    # kd = 32 at 64 rows and 64 below; bf16 also two rounded slices (rows of
    # kd + 8).
    kd = 32 if rows == 64 else 64
    return 4 * 3 * (128 + rows) * (kd + 4) + (2 * 2 * (128 + rows) * (kd + 8) if bf16 else 0)


def test_decoder_backward_tile_plan():
    # Rows from the batch, shared memory as the .cu computes it, and two
    # blocks per 16-row tile where half the SMs would idle. The image
    # decoder's 784-wide output cotangent no longer bounds the tile: every
    # operand streams from device memory.
    assert tmlp.stack_bwd_plan([500, 500], 16384, 132) == (64, _ring(64, False), 1)
    assert tmlp.stack_bwd_plan([500, 500], 1024, 132) == (16, _ring(16, False), 2)
    assert tmlp.stack_bwd_plan([500, 500], 7, 132, "bfloat16") == (16, _ring(16, True), 2)
    assert max(_ring(r, True) for r in (16, 32, 64)) <= tmlp.SMEM_BYTES


# ---------------------------------------------------------------------------
# The fused sampler (row 5)
# ---------------------------------------------------------------------------


def test_sampler_draws_the_philox_stream_of_the_other_paths():
    r = np.random.default_rng(3)
    mu = torch.from_numpy(r.normal(size=(37, N_Z)).astype(np.float32))
    lv = torch.from_numpy(r.normal(size=(37, N_Z)).astype(np.float32))
    z, eps = tsampling.reparameterize_plain(mu, lv, 99)
    assert torch.equal(eps, philox_normal(99, 37, N_Z, "cpu"))
    torch.testing.assert_close(z, mu + torch.exp(0.5 * lv) * eps, rtol=0, atol=0)
    # The tower megakernel's twin draws the same ε from the same seed.
    _, tp = _pair(dict(n_input=24, n_z=N_Z, n_hidden_recog_1=8, n_hidden_recog_2=8,
                       n_hidden_gener_1=8, n_hidden_gener_2=8))
    with torch.no_grad():
        out = tmk.vae_tower_fused(tp, torch.rand(37, 24), kind="bernoulli", seed=99)
    assert torch.equal(out["eps"], eps)
    assert torch.equal(tsampling.reparameterize_fused(mu, lv, 99), z)


def test_sampler_backward_matches_jax():
    r = np.random.default_rng(4)
    mu, lv, g = (r.normal(size=(13, N_Z)).astype(np.float32) for _ in range(3))
    mut, lvt = (torch.from_numpy(a).requires_grad_() for a in (mu, lv))
    z = tsampling.reparameterize_fused(mut, lvt, 5)
    z.backward(torch.from_numpy(g))
    eps = philox_normal(5, 13, N_Z, "cpu").numpy()
    dmu, dlv, _ = jsampling._reparam_bwd((jnp.asarray(lv), jnp.asarray(eps)), jnp.asarray(g))
    _close(mut.grad.numpy(), dmu, 1e-6)
    _close(lvt.grad.numpy(), dlv, 1e-6)


def test_sampler_is_standard_normal():
    # 2^16 draws: mean and variance within 4σ of N(0, 1). The JAX stream is
    # another stream by design, so its distribution is all it shares.
    n = 1 << 16
    zero = torch.zeros(n // 16, 16)
    z, eps = tsampling.reparameterize_plain(zero, zero, 2024)
    assert torch.equal(z, eps)
    e = eps.double()
    assert abs(float(e.mean())) < 4 / np.sqrt(n)
    assert abs(float(e.var()) - 1) < 4 * np.sqrt(2 / n)


# ---------------------------------------------------------------------------
# The slice: assoc_loss_fn(use_pallas=True) and the train step
# ---------------------------------------------------------------------------


def _archs(depth=2):
    def arch(n_in):
        return dict(n_input=n_in, n_z=N_Z, **{f"n_hidden_{n}_{k}": 16
                                              for n in ("recog", "gener")
                                              for k in range(1, depth + 1)})
    return arch(24), arch(12)


def _configs(form="mean_l2", n_cond=0):
    a, b = _archs()
    return [c.AssocConfig(
        [c.ModalityConfig("image", a, recon="bernoulli", n_cond=n_cond),
         c.ModalityConfig("trajectory", b, recon="gaussian", n_cond=n_cond)],
        assoc_lambda=0.7, assoc_form=form) for c in (jcfg, tcfg)]


def _models(jc, tc_, seed=0):
    jp = jassoc.init_assoc(jax.random.PRNGKey(seed), jc)
    return jp, convert.from_jax_numpy(jax.tree.map(np.asarray, jp), tc_, "cpu")


def _batch(n_cond=0, batch=19, seed=1):
    r = np.random.default_rng(seed)
    xs = [r.uniform(0, 1, (batch, 24)).astype(np.float32),
          r.normal(size=(batch, 12)).astype(np.float32)]
    cond = r.integers(0, n_cond, batch).astype(np.int32) if n_cond else None
    eps = [r.normal(size=(batch, N_Z)).astype(np.float32) for _ in range(2)]
    return xs, cond, eps


def _jax_flat(tree):
    return dict(convert._flatten(jax.tree.map(np.asarray, tree)))


@pytest.mark.parametrize("form,remat,n_cond", [
    ("mean_l2", False, 0), ("mean_l2", True, 3), ("sample_l2", False, 0),
    ("sample_l2", True, 0), ("sym_kl", False, 3), ("sym_kl", True, 0),
    ("infonce", False, 0), ("infonce", True, 3),
])
def test_composable_loss_matches_jax(form, remat, n_cond):
    jc, tc_ = _configs(form, n_cond)
    jp, tm = _models(jc, tc_)
    xs, cond, eps = _batch(n_cond)
    jcond = None if cond is None else jnp.asarray(cond)
    (jt, jm), (jg, jdx) = jax.value_and_grad(
        lambda p, x: jassoc.assoc_loss_fn(p, x, jc, eps=[jnp.asarray(e) for e in eps],
                                          use_pallas=True, remat=remat, cond=jcond),
        argnums=(0, 1), has_aux=True)(jp, [jnp.asarray(x) for x in xs])
    tx = [torch.from_numpy(x).requires_grad_() for x in xs]
    tt, tmets = tassoc.assoc_loss_fn(
        tm, tx, tc_, eps=[torch.from_numpy(e) for e in eps], use_pallas=True, remat=remat,
        cond=None if cond is None else torch.from_numpy(cond))
    tt.backward()
    assert set(tmets) == set(jm)
    for k in jm:
        np.testing.assert_allclose(tmets[k].item(), float(jm[k]), rtol=1e-5, atol=1e-6, err_msg=k)
    got = {k: p.grad.numpy() for k, p in tm.named_parameters()}
    want = _jax_flat(jg)
    assert set(got) == set(want)
    for k in want:
        _close(got[k], want[k], 1e-5, summed=True)
    for t, w in zip(tx, jdx):
        _close(t.grad.numpy(), w, 1e-5, summed=True)


def test_three_paths_draw_the_same_eps_from_a_seed():
    jc, tc_ = _configs()
    xs = [torch.from_numpy(x) for x in _batch()[0]]
    res = {}
    for path in (False, True, "mega"):
        _, tm = _models(jc, tc_)
        total, metrics = tassoc.assoc_loss_fn(tm, xs, tc_, seed=11, use_pallas=path)
        total.backward()
        res[path] = (metrics, {k: p.grad.numpy() for k, p in tm.named_parameters()})
    for path in (True, "mega"):
        for k, v in res[False][0].items():
            np.testing.assert_allclose(res[path][0][k].item(), v.item(), rtol=1e-5, err_msg=k)
        for k, w in res[False][1].items():
            _close(res[path][1][k], w, 1e-5, summed=True)


def test_cpu_composable_path_launches_nothing():
    jc, tc_ = _configs()
    _, tm = _models(jc, tc_)
    tmlp.reset_launches()
    total, _ = tassoc.assoc_loss_fn(tm, [torch.from_numpy(x) for x in _batch()[0]], tc_,
                                    seed=1, use_pallas=True)
    total.backward()
    assert _launches.snapshot() == {k: 0 for k in _launches.snapshot()}
    assert {"dec_bwd", "reparam", "loss_fwd", "loss_bwd"} <= set(_launches.TRAINING)


def test_composable_training_continues_a_jax_run():
    # Three JAX steps on use_pallas=True, the state carried into the port,
    # then three more steps on both sides with the same ε.
    jc, tc_ = _configs()
    jtc = jcfg.TrainConfig(learning_rate=0.01, use_pallas=True)
    ttc = tcfg.TrainConfig(learning_rate=0.01, use_pallas=True)
    jp, _ = _models(jc, tc_)
    opt = jstep.make_optimizer(jtc)
    js = jstep.TrainState(jnp.int32(0), jp, opt.init(jp), jax.random.key(0))

    @jax.jit
    def jax_step(state, xs, eps):
        (_, m), g = jax.value_and_grad(
            lambda p: jassoc.assoc_loss_fn(p, xs, jc, eps=eps, use_pallas=True),
            has_aux=True)(state.params)
        u, os_ = opt.update(g, state.opt_state, state.params)
        return state._replace(step=state.step + 1, params=optax.apply_updates(state.params, u),
                              opt_state=os_), m

    batches = [_batch(seed=10 + t) for t in range(6)]
    for xs, _, eps in batches[:3]:
        js, _ = jax_step(js, [jnp.asarray(x) for x in xs], [jnp.asarray(e) for e in eps])
    adam = js.opt_state[0]
    ts = convert.train_state_from_jax_numpy(
        jax.tree.map(np.asarray, js.params),
        (np.asarray(adam.count), jax.tree.map(np.asarray, adam.mu), jax.tree.map(np.asarray, adam.nu)),
        np.asarray(js.step), tc_, ttc, "cpu")
    topt = tstep.make_optimizer(ttc)
    for xs, _, eps in batches[3:]:
        js, jm = jax_step(js, [jnp.asarray(x) for x in xs], [jnp.asarray(e) for e in eps])
        ts, tm = tstep._one_step(ts, [torch.from_numpy(x) for x in xs], tc_, ttc, topt,
                                 eps=[torch.from_numpy(e) for e in eps])
        for k in jm:
            np.testing.assert_allclose(tm[k].item(), float(jm[k]), rtol=1e-5, err_msg=k)
    params, (count, mu, nu), step = convert.train_state_to_jax_numpy(ts)
    adam = js.opt_state[0]
    assert int(step) == int(js.step) == 6 and int(count) == int(adam.count) == 6
    for got, want in ((params, js.params), (mu, adam.mu), (nu, adam.nu)):
        g, w = dict(convert._flatten(got)), _jax_flat(want)
        assert set(g) == set(w)
        for k in w:
            _close(g[k], w[k], 1e-5, summed=True)


def test_non_cpu_tensors_never_take_the_plain_path():
    # A tensor that is not on the CPU launches the kernel or raises; a meta
    # tensor can do neither, so every new wrapper must raise.
    m = tnet.MLPVAE(dict(n_input=24, n_z=N_Z, n_hidden_recog_1=8, n_hidden_recog_2=8,
                         n_hidden_gener_1=8, n_hidden_gener_2=8), device="meta")
    g = m.gener
    z = torch.zeros(3, N_Z, device="meta")
    with pytest.raises(ValueError, match="runs on CUDA"):
        tmlp.decode_bwd(tnet.hidden_layers(g), g["out"], z, torch.zeros(3, 24, device="meta"))
    with pytest.raises(ValueError, match="runs on CUDA"):
        tsampling.reparameterize_kernel(z, z, 0)
    x = [torch.zeros(3, 24, device="meta")]
    with pytest.raises(ValueError, match="runs on CUDA"):
        tloss.loss_terms(("bernoulli",), x, x, [z], [z])
    with pytest.raises(ValueError, match="runs on CUDA"):
        tloss.loss_terms_bwd(("bernoulli",), torch.zeros(3, 3, device="meta"), x, x, [z], [z])
