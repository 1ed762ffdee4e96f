"""The tower megakernel (kernels/megakernel.py) and the encoder backward
(kernels/mlp.py) against the JAX package's Pallas kernels, and the pieces of
their CUDA route that run without a card.

On the CPU the port's wrappers run their plain twins; the JAX side runs its
Pallas kernels in interpret mode, as its own tests do, with the same ε
injected. Tolerances: fp32 rtol = atol = 1e-5 (gradients summed over the
batch: atol = 1e-5 × max|want|); bf16 2e-2 (an activation rounded to bf16
between layers can land on the other side of a rounding boundary).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from vae_assoc_tpu.kernels import megakernel as jmk
from vae_assoc_tpu.kernels import mlp as jmlp
from vae_assoc_tpu.models import networks as jnet
from vae_assoc_tpu_torch import configs as tcfg
from vae_assoc_tpu_torch import convert
from vae_assoc_tpu_torch.kernels import _launches
from vae_assoc_tpu_torch.kernels import megakernel as tmk
from vae_assoc_tpu_torch.kernels import mlp as tmlp
from vae_assoc_tpu_torch.models import networks as tnet
from vae_assoc_tpu_torch.ops.sampling import philox_normal

TOL = {"float32": 1e-5, "bfloat16": 2e-2}
ARCH = dict(n_input=24, n_z=4, n_hidden_recog_1=16, n_hidden_recog_2=12,
            n_hidden_gener_1=12, n_hidden_gener_2=16)
CASES = [(kind, n_cond, cd) for kind in ("bernoulli", "gaussian")
         for n_cond in (0, 3) for cd in sorted(TOL)]


def _pair(arch=ARCH, n_cond=0, seed=0):
    jp = jnet.init_mlp_vae_params(jax.random.PRNGKey(seed), arch, n_cond=n_cond)
    cfg = tcfg.AssocConfig([tcfg.ModalityConfig("m", arch, n_cond=n_cond)])
    model = convert.from_jax_numpy({"modalities": (jax.tree.map(np.asarray, jp),)}, cfg, "cpu")
    return jp, model.modalities[0]


def _inputs(kind, n_cond, batch, seed=1):
    r = np.random.default_rng(seed)
    x = (r.uniform(0, 1, (batch, ARCH["n_input"])) if kind == "bernoulli"
         else r.normal(size=(batch, ARCH["n_input"]))).astype(np.float32)
    cond = (np.eye(n_cond, dtype=np.float32)[r.integers(0, n_cond, batch)]
            if n_cond else None)
    eps = r.normal(size=(batch, ARCH["n_z"])).astype(np.float32)
    cts = [r.normal(size=(batch, ARCH["n_z"])).astype(np.float32) for _ in range(2)]
    cts += [r.uniform(0.5, 1.5, batch).astype(np.float32) / batch for _ in range(2)]
    return x, cond, eps, cts


def _j(a):
    return None if a is None else jnp.asarray(a)


def _t(a):
    return None if a is None else torch.from_numpy(a)


def _assert_grads(got, want, tol):
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g, w, rtol=tol, atol=tol * max(np.abs(w).max(), 1e-30))


@pytest.mark.parametrize("kind,n_cond,cd", CASES)
@torch.no_grad()
def test_tower_forward_matches_pallas(kind, n_cond, cd):
    jp, tp = _pair(n_cond=n_cond)
    x, cond, eps, _ = _inputs(kind, n_cond, 37)
    want = jmk.vae_tower_fused(jp, _j(x), kind=kind, eps=_j(eps), compute_dtype=jnp.dtype(cd),
                               cond=_j(cond))
    got = tmk.vae_tower_fused(tp, _t(x), kind=kind, eps=_t(eps), compute_dtype=cd, cond=_t(cond))
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == torch.float32 and tuple(got[k].shape) == want[k].shape
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=TOL[cd], atol=TOL[cd])


def _loss_jax(jp, x, cond, eps, cts, kind, cd):
    o = jmk.vae_tower_fused(jp, _j(x), kind=kind, eps=_j(eps), compute_dtype=jnp.dtype(cd),
                            cond=_j(cond))
    return sum(jnp.sum(o[k] * c) for k, c in zip(("mu", "lv", "recon_term", "kl_term"), cts))


def _loss_port(tp, x, cond, eps, cts, kind, cd, forward=tmk.vae_tower_fused):
    o = forward(tp, _t(x), kind=kind, eps=_t(eps), compute_dtype=cd, cond=_t(cond))
    return sum((o[k] * torch.from_numpy(c)).sum()
               for k, c in zip(("mu", "lv", "recon_term", "kl_term"), cts))


def _port_grads(tp):
    return [p.grad.numpy().copy() for p in tmk.flatten(tp)]


@pytest.mark.parametrize("kind,n_cond,cd", CASES)
def test_tower_grads_match_jax(kind, n_cond, cd):
    # The 14 weight grads of rows 9 + stage 2 + row 3 against jax.grad
    # through the Pallas tower, for the same upstream cotangents.
    jp, tp = _pair(n_cond=n_cond)
    x, cond, eps, cts = _inputs(kind, n_cond, 37)
    jg = jax.grad(_loss_jax)(jp, x, cond, eps, cts, kind, cd)
    _loss_port(tp, x, cond, eps, cts, kind, cd).backward()
    want = [np.asarray(g) for g in jmk._flatten(jg)]
    want = [w[0] if i % 2 else w for i, w in enumerate(want)]  # biases [1, n] → [n]
    _assert_grads(_port_grads(tp), want, TOL[cd])


def _autograd_forward(tp, x, *, kind, eps, compute_dtype, cond):
    """Autograd of the forward twin: the plain path's rounding."""
    x = x if cond is None else torch.cat([x, cond], 1)
    mu, lv, e, rec, kl = tmk.tower_fwd_plain(tmk.flatten(tp), x, eps, kind=kind,
                                             compute_dtype=compute_dtype)
    return {"mu": mu, "lv": lv, "eps": e, "recon_term": rec, "kl_term": kl}


@pytest.mark.parametrize("cd", sorted(TOL))
def test_explicit_bf16_backward_is_not_autograd_of_the_twin(cd):
    # The reference rounds both operands of each backward product; autograd
    # through .bfloat16().float() rounds each product's result instead. In
    # fp32 the two are the same function.
    kind = "bernoulli"
    jp, tp = _pair()
    x, cond, eps, cts = _inputs(kind, 0, 37)
    _loss_port(tp, x, cond, eps, cts, kind, cd).backward()
    explicit = _port_grads(tp)
    tp.zero_grad()
    _loss_port(tp, x, cond, eps, cts, kind, cd, forward=_autograd_forward).backward()
    auto = _port_grads(tp)
    rel = max(np.abs(a - b).max() / np.abs(b).max() for a, b in zip(explicit, auto))
    if cd == "float32":
        assert rel < 1e-5
    else:
        assert rel > 1e-4


def _pallas_dec_loss_bwd(jp, x, z, grec, kind, cd, n_cond):
    """The Pallas _dec_loss_bwd_kernel alone, one grid step over the batch
    in interpret mode: (dz, [dd1, dc1, dd2, dc2, ddo, dco])."""
    dec = jmk._flatten(jp)[8:]
    b, n_in = x.shape
    n_z = z.shape[1]
    shapes = [jax.ShapeDtypeStruct(w.shape, jnp.float32) for w in dec]
    full = [pl.BlockSpec(s.shape, lambda i: (0, 0), memory_space=pltpu.VMEM) for s in shapes]
    out = pl.pallas_call(
        functools.partial(jmk._dec_loss_bwd_kernel, jnp.dtype(cd), kind, b, n_cond),
        grid=(1,),
        in_specs=[jmk._row_spec(b, n_in), jmk._row_spec(b, n_z)] + jmk._full_specs(6)
        + [jmk._row_spec(b, 1)],
        out_specs=tuple([jmk._row_spec(b, n_z)] + full),
        out_shape=tuple([jax.ShapeDtypeStruct((b, n_z), jnp.float32)] + shapes),
        interpret=True,
    )(jnp.asarray(x), jnp.asarray(z), *dec, jnp.asarray(grec)[:, None])
    dz, *grads = (np.asarray(o) for o in out)
    return dz, [g[0] if i % 2 else g for i, g in enumerate(grads)]  # biases [1, n] → [n]


@pytest.mark.parametrize("kind,n_cond,cd", CASES)
def test_dec_loss_bwd_mirror_matches_pallas(kind, n_cond, cd):
    # The backward kernel's arithmetic (σ of each hidden pre-activation
    # recovered from the saved post-activation as −expm1(−g)) against the
    # Pallas kernel, which takes σ of the pre-activation: dz and the six
    # decoder weight grads, fp32 1e-5 and bf16 2e-2.
    jp, tp = _pair(n_cond=n_cond)
    x, cond, eps, cts = _inputs(kind, n_cond, 37)
    xin = x if cond is None else np.concatenate([x, cond], 1)
    z = (0.7 * eps).astype(np.float32)
    grec = cts[2]
    want_dz, want = _pallas_dec_loss_bwd(jp, xin, z, grec, kind, cd, n_cond)
    got_dz, got = tmk.dec_loss_bwd_mirror(torch.from_numpy(xin), torch.from_numpy(z),
                                          tmk.flatten(tp)[8:], torch.from_numpy(grec),
                                          kind=kind, compute_dtype=cd)
    tol = TOL[cd]
    np.testing.assert_allclose(got_dz.numpy(), want_dz, rtol=tol, atol=tol)
    _assert_grads([g.detach().numpy() for g in got], want, tol)


def _pallas_stack_bwd(kernel, flat, x, cts, cd, tile):
    """The Pallas _enc_bwd_kernel or _dec_bwd_kernel alone in interpret mode
    over row tiles of ``tile`` (the last one ragged where the batch is), as
    mlp.py::_encode_fused_bwd calls it: (dx, [dw, db per layer])."""
    b, n_in = x.shape
    nh = (len(flat) - 2 * len(cts)) // 2
    n_g = cts[0].shape[1]
    shapes = [jax.ShapeDtypeStruct(w.shape, jnp.float32) for w in flat]
    full = [pl.BlockSpec(s.shape, lambda i: (0, 0), memory_space=pltpu.VMEM) for s in shapes]
    out = pl.pallas_call(
        functools.partial(kernel, cd, nh, b),
        grid=(pl.cdiv(b, tile),),
        in_specs=[jmlp._tile_spec(tile, n_in)] + jmlp._full_specs(len(flat))
        + [jmlp._tile_spec(tile, n_g)] * len(cts),
        out_specs=tuple([jmlp._tile_spec(tile, n_in)] + full),
        out_shape=tuple([jax.ShapeDtypeStruct((b, n_in), jnp.float32)] + shapes),
        interpret=True,
    )(jnp.asarray(x), *flat, *(jnp.asarray(c) for c in cts))
    dx, *grads = (np.asarray(o) for o in out)
    return dx, [g[0] if i % 2 else g for i, g in enumerate(grads)]  # biases [1, n] → [n]


def _stack_arch(depth):
    return dict(n_input=24, n_z=4, **{f"n_hidden_{n}_{k}": 12 + 4 * k
                                      for n in ("recog", "gener") for k in range(1, depth + 1)})


def _stack_inputs(tp, net, n_cond, batch, seed):
    """(hidden, heads, x, cotangents) of the encoder ("recog") or decoder
    ("gener") stack of ``tp``, inputs made with numpy."""
    r = np.random.default_rng(seed)
    m = tp.recog if net == "recog" else tp.gener
    if net == "recog":
        heads = [m["out_mean"], m["out_logvar"]]
        x = r.uniform(0, 1, (batch, 24 + n_cond))
        cts = [r.normal(size=(batch, 4)) for _ in heads]
    else:
        heads = [m["out"]]
        x = r.normal(size=(batch, 4 + n_cond))
        cts = [r.normal(size=(batch, 24))]
    return (tnet.hidden_layers(m), heads, x.astype(np.float32),
            [c.astype(np.float32) for c in cts])


@pytest.mark.parametrize("net", ["recog", "gener"])
@pytest.mark.parametrize("depth,n_cond,cd", [
    (1, 0, "float32"), (2, 3, "float32"), (3, 0, "float32"),
    (1, 3, "bfloat16"), (2, 0, "bfloat16"), (3, 3, "bfloat16"),
])
def test_stack_bwd_mirror_matches_pallas(net, depth, n_cond, cd):
    # The stack-backward kernel's arithmetic (σ of each hidden pre-activation
    # recovered from the saved post-activation as −expm1(−h); the encoder's
    # two head products summed in order) against the Pallas _enc_bwd_kernel
    # or _dec_bwd_kernel over 16-row tiles, the last of the 37 rows ragged:
    # the input gradient and every weight grad, fp32 1e-5, bf16 2e-2.
    jp, tp = _pair(_stack_arch(depth), n_cond)
    hidden, heads, x, cts = _stack_inputs(tp, net, n_cond, 37, depth + 10 * n_cond)
    flat, kernel = ((jmlp._enc_flat(jp), jmlp._enc_bwd_kernel) if net == "recog"
                    else (jmlp._dec_flat(jp), jmlp._dec_bwd_kernel))
    want_dx, want = _pallas_stack_bwd(kernel, flat, x, cts, cd, tile=16)
    grads, dx = tmlp.stack_bwd_mirror(hidden, heads, torch.from_numpy(x),
                                      [torch.from_numpy(c) for c in cts], compute_dtype=cd)
    tol = TOL[cd]
    np.testing.assert_allclose(dx.numpy(), want_dx, rtol=tol, atol=tol)
    assert len(grads) == depth + len(heads)
    _assert_grads([t.detach().numpy() for pair in grads for t in pair], want, tol)


@pytest.mark.parametrize("net", ["recog", "gener"])
@pytest.mark.parametrize("cd", sorted(TOL))
def test_stack_backward_without_dx_gives_the_same_grads(net, cd):
    # want_dx=False returns None for the input gradient and the very same
    # weight grads, on the twin and on the mirror.
    _, tp = _pair(_stack_arch(2), 3)
    hidden, heads, x, cts = _stack_inputs(tp, net, 3, 19, 5)
    x, cts = torch.from_numpy(x), [torch.from_numpy(c) for c in cts]
    if net == "recog":
        twin = functools.partial(tmlp.encode_bwd, hidden, heads, x, *cts, compute_dtype=cd)
    else:
        twin = functools.partial(tmlp.decode_bwd, hidden, heads[0], x, *cts, compute_dtype=cd)
    mirror = functools.partial(tmlp.stack_bwd_mirror, hidden, heads, x, cts, compute_dtype=cd)
    for fn in (twin, mirror):
        (grads, dx), (grads_n, dx_n) = fn(), fn(want_dx=False)
        assert dx.shape == x.shape and dx_n is None
        for g, gn in zip(grads, grads_n):
            assert torch.equal(g[0], gn[0]) and torch.equal(g[1], gn[1])


def test_training_paths_skip_the_encoder_input_gradient(monkeypatch):
    # The mega path's backward and encode_mlp_fused on data that needs no
    # gradient ask the encoder backward for no dx; an x that requires grad
    # still gets one.
    asked, real = [], tmlp.encode_bwd

    def spy(*args, **kw):
        asked.append(kw["want_dx"])
        return real(*args, **kw)

    monkeypatch.setattr(tmlp, "encode_bwd", spy)
    _, tp = _pair()
    out = tmk.vae_tower_fused(tp, torch.rand(5, 24), kind="bernoulli", seed=1)
    (out["recon_term"].sum() + out["mu"].sum()).backward()
    for x in (torch.rand(5, 24), torch.rand(5, 24, requires_grad=True)):
        mu, lv = tmlp.encode_mlp_fused(tp, x)
        (mu.sum() + lv.sum()).backward()
    assert asked == [False, False, True] and x.grad is not None


@pytest.mark.parametrize("depth,n_cond,cd", [(1, 0, "float32"), (2, 3, "float32"),
                                             (3, 0, "bfloat16"), (2, 0, "bfloat16")])
def test_encoder_backward_twin_matches_jax_vjp(depth, n_cond, cd):
    arch = dict(n_input=24, n_z=4, **{f"n_hidden_{n}_{k}": 12 + 4 * k
                                      for n in ("recog", "gener") for k in range(1, depth + 1)})
    jp, tp = _pair(arch, n_cond)
    r = np.random.default_rng(depth)
    x = r.uniform(0, 1, (21, 24 + n_cond)).astype(np.float32)
    dmu, dlv = (r.normal(size=(21, 4)).astype(np.float32) for _ in range(2))
    (_, vjp) = jax.vjp(lambda p, xx: jmlp.encode_mlp_fused(p, xx, compute_dtype=jnp.dtype(cd)),
                       jp, jnp.asarray(x))
    jg, jdx = vjp((jnp.asarray(dmu), jnp.asarray(dlv)))
    r_ = tp.recog
    hidden = tnet.hidden_layers(r_)
    grads, dx = tmlp.encode_bwd_plain(hidden, [r_["out_mean"], r_["out_logvar"]],
                                      torch.from_numpy(x), torch.from_numpy(dmu),
                                      torch.from_numpy(dlv), compute_dtype=cd)
    want, got = [], []
    names = [f"h{i + 1}" for i in range(depth)] + ["out_mean", "out_logvar"]
    for name, (dw, db) in zip(names, grads):
        want += [jg["recog"][name]["w"], jg["recog"][name]["b"]]
        got += [dw.numpy(), db.numpy()]
    _assert_grads(got, want, TOL[cd])
    np.testing.assert_allclose(dx.numpy(), np.asarray(jdx), rtol=TOL[cd], atol=TOL[cd])
    # The same through encode_mlp_fused's autograd Function.
    xt = torch.from_numpy(x).requires_grad_()
    mu, lv = tmlp.encode_mlp_fused(tp, xt, compute_dtype=cd)
    ((mu * torch.from_numpy(dmu)).sum() + (lv * torch.from_numpy(dlv)).sum()).backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jdx), rtol=TOL[cd], atol=TOL[cd])
    _assert_grads([p.grad.numpy() for p in hidden[0].parameters()],
                  [jg["recog"]["h1"]["w"], jg["recog"]["h1"]["b"]], TOL[cd])


@pytest.mark.parametrize("cd", sorted(TOL))
def test_weight_grads_twin(cd):
    r = np.random.default_rng(0)
    a, d = r.normal(size=(9, 5)).astype(np.float32), r.normal(size=(9, 3)).astype(np.float32)
    dw, db = tmlp.weight_grads(torch.from_numpy(a), torch.from_numpy(d), compute_dtype=cd)
    rnd = (lambda v: v) if cd == "float32" else (
        lambda v: torch.from_numpy(v).bfloat16().float().numpy())
    np.testing.assert_allclose(dw.numpy(), rnd(a).T @ rnd(d), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(db.numpy(), d.sum(0), rtol=1e-6, atol=1e-6)


@torch.no_grad()
def test_seeded_eps_is_the_counter_stream():
    _, tp = _pair()
    x = torch.rand(13, 24)
    out = tmk.vae_tower_fused(tp, x, kind="bernoulli", seed=77)
    assert torch.equal(out["eps"], philox_normal(77, 13, 4, "cpu"))
    again = tmk.vae_tower_fused(tp, x, kind="bernoulli", seed=77)
    assert torch.equal(again["recon_term"], out["recon_term"])
    with pytest.raises(ValueError, match="seed"):
        tmk.vae_tower_fused(tp, x, kind="bernoulli")


def test_tower_refuses_an_input_that_requires_grad():
    _, tp = _pair()
    with pytest.raises(ValueError, match="weights only"):
        tmk.vae_tower_fused(tp, torch.rand(3, 24, requires_grad=True), kind="gaussian", seed=0)


def test_cpu_training_path_launches_nothing():
    _, tp = _pair()
    tmlp.reset_launches()
    out = tmk.vae_tower_fused(tp, torch.rand(5, 24), kind="bernoulli", seed=1)
    (out["recon_term"].sum() + out["mu"].sum()).backward()
    assert _launches.snapshot() == {k: 0 for k in _launches.snapshot()}


def test_non_cpu_tensors_never_take_the_plain_path():
    # A tensor that is not on the CPU launches the kernel or raises; a meta
    # tensor can do neither, so every training wrapper must raise.
    m = tnet.MLPVAE(ARCH, device="meta")
    flat = [t.detach() for t in tmk.flatten(m)]
    x = torch.zeros(3, 24, device="meta")
    with pytest.raises(ValueError, match="runs on CUDA"):
        tmk.tower_fwd(flat, x, kind="bernoulli", seed=0)
    with pytest.raises(ValueError, match="runs on CUDA"):
        tmk.dec_loss_bwd(x, torch.zeros(3, 4, device="meta"), flat[8:],
                         torch.zeros(3, device="meta"), kind="bernoulli")
    layers = tmlp._pairs(flat[:8])
    with pytest.raises(ValueError, match="runs on CUDA"):
        tmlp.encode_bwd(layers[:2], layers[2:], x, torch.zeros(3, 4, device="meta"),
                        torch.zeros(3, 4, device="meta"))
    with pytest.raises(ValueError, match="runs on CUDA"):
        tmlp.weight_grads(x, x)


def test_unflatten_grads_mirrors_the_module_tree():
    _, tp = _pair()
    flat = tmk.flatten(tp)
    tree = tmk.unflatten_grads(flat)
    assert tree["recog"]["out_logvar"]["b"] is tp.recog["out_logvar"].b
    assert tree["gener"]["out"]["w"] is tp.gener["out"].w
    assert len(flat) == 14


IMAGE_DIMS = (784, 500, 500, 20, 0, 500, 500, 784)


@pytest.mark.parametrize("dims,batch,cd,rows,parts", [
    (IMAGE_DIMS, 16384, "float32", 64, 1), (IMAGE_DIMS, 16384, "bfloat16", 64, 1),
    ((794, 500, 500, 20, 10, 500, 500, 784), 4096, "bfloat16", 32, 1),
    (IMAGE_DIMS, 7, "float32", 16, 8),        # 784 wide: 7 column tiles, 8 blocks
    ((200, 500, 500, 20, 0, 500, 500, 200), 7, "float32", 16, 4),  # 500 wide: 4
])
def test_forward_plan(dims, batch, cd, rows, parts):
    # The stack forward's rows and blocks per tile over the tower's
    # products; shared memory as csrc/mega.cu's fwd_smem: the stack
    # forward's ring (W as stored, A streamed), then the loss partials, 32
    # floats a row.
    ring = tmlp.dense_ring_bytes(rows, False, True, cd == "bfloat16")
    assert tmk.fwd_plan(dims, batch, 132, cd) == (rows, ring + 4 * 32 * rows, parts)
    assert ring + 4 * 32 * rows <= tmlp.SMEM_BYTES


@pytest.mark.parametrize("batch,cd,rows", [(16384, "float32", 64), (1024, "bfloat16", 16),
                                           (4096, "float32", 32), (64, "bfloat16", 16)])
def test_backward_tile_plan(batch, cd, rows):
    # 16, 32 or 64 rows from the batch; shared memory as csrc/mega.cu's
    # bwd_smem: a ring of three stages, each a 128 × kd slice of W (read as
    # W^T; rows of kd + 4) and a rows × kd slice of the streamed A, kd = 32
    # at 64 rows and 64 below; bf16 also two rounded slices (rows of kd +
    # 8). No width enters it.
    kd = 32 if rows == 64 else 64
    smem = 4 * 3 * (128 + rows) * (kd + 4)
    if cd == "bfloat16":
        smem += 2 * 2 * (128 + rows) * (kd + 8)
    assert tmk.dec_bwd_plan(batch, n_sm=132, compute_dtype=cd) == (rows, smem)
    assert smem <= tmlp.SMEM_BYTES


def test_tile_plans_lower_the_rows_and_raise_only_past_one_row():
    # The backward's rows fall with the batch, 64 down to 16 (the fewest
    # that keep it within one block per SM), and no width bounds them: every
    # operand streams from device memory. An empty batch raises.
    assert [tmk.dec_bwd_plan(b, 132)[0] for b in (16384, 4225, 4224, 2113, 2112, 1)] == [
        64, 64, 32, 32, 16, 16]
    with pytest.raises(ValueError, match="at least one row"):
        tmk.dec_bwd_plan(0, 132)
    # The stack backward's plan is the same (rows, bytes, blocks per tile)
    # and, with no width in it, a width that used to overflow shared memory
    # (29057) plans; more hidden layers than its layer table holds raise.
    for b, cd in ((16384, "float32"), (4096, "bfloat16"), (64, "float32")):
        rows, smem = tmk.dec_bwd_plan(b, 132, cd)
        assert tmlp.stack_bwd_plan([500, 500], b, 132, cd) == (
            rows, smem, tmk.dec_bwd_parts(b, rows, 132))
    assert tmlp.stack_bwd_plan([29056], 4096, 132) == (32, tmk.dec_bwd_plan(4096, 132)[1], 1)
    assert tmlp.stack_bwd_plan([29057], 64, 132) == (16, tmk.dec_bwd_plan(64, 132)[1], 2)
    assert tmlp.stack_bwd_plan([500] * 16, 1, 132)[0] == 16
    with pytest.raises(ValueError, match="hidden layers"):
        tmlp.stack_bwd_plan([500] * 17, 64, 132)
    with pytest.raises(ValueError, match="at least one row"):
        tmlp.stack_bwd_plan([500, 500], 0, 132)


@pytest.mark.parametrize("batch,n_sm,want", [(1024, 132, 2), (2112, 132, 1), (1056, 132, 2),
                                           (16384, 132, 1)])
def test_backward_splits_columns_only_where_sms_idle(batch, n_sm, want):
    # Two blocks share a 16-row tile (each every other column tile) where
    # the tiles leave at least half the SMs idle; 32- and 64-row tiles never
    # split.
    rows, _ = tmk.dec_bwd_plan(batch, n_sm)
    assert tmk.dec_bwd_parts(batch, rows, n_sm) == want


@pytest.mark.parametrize("batch,m,n,want", [
    (16384, 500, 784, (1184, 14)),  # 28 tiles of 128 × 128: 392 blocks, 3 full waves
    (64, 500, 784, (64, 1)),         # too few rows to split
    (16384, 500, 20, (512, 32)),     # 4 tiles: chunks of the minimum rows
    (16383, 784, 500, (1184, 14)),   # a ragged batch: the last chunk is short
])
def test_wgrad_plan(batch, m, n, want):
    rows, chunks = tmlp.wgrad_plan(batch, m, n, n_sm=132)
    assert (rows, chunks) == want
    assert rows % tmlp.WGRAD_SLICE == 0 and rows * chunks >= batch > rows * (chunks - 1)


def test_sm_count_is_queried_once_per_device(monkeypatch):
    # The wrappers' tile plans read the SM count on every launch; the
    # device query runs once per device and process.
    calls = []

    class _Props:
        multi_processor_count = 132

    monkeypatch.setattr(tmlp, "_sm_counts", {})
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda i: calls.append(i) or _Props())
    assert [tmlp.sm_count(torch.device("cuda", 0)) for _ in range(3)] == [132] * 3
    assert tmlp.sm_count("cuda:1") == 132 and calls == [0, 1]
