"""The VAE tower megakernel for training: hand-written CUDA kernels and their plain twins.

Counterpart of vae_assoc_tpu/kernels/megakernel.py. ``vae_tower_fused``
runs one modality's whole depth-2 softplus tower — encoder → ε → z →
decoder → per-row reconstruction and KL terms — in one forward launch
(``csrc/mega.cu::mega_fwd``, replacing the Pallas ``_fwd_kernel``); the
decoder output is never stored. Its backward, a
``torch.autograd.Function``, runs in three stages as the reference does:

1. the fused decoder+loss backward (``mega_dec_loss_bwd``, replacing the
   Pallas ``_dec_loss_bwd_kernel``): dz and the decoder's weight grads;
2. the reparameterization and KL glue into (dμ, dlogσ²), elementwise
   torch on [B, n_z] (XLA elementwise in the reference);
3. the encoder-stack backward (kernels/mlp.py::encode_bwd, replacing the
   Pallas ``_enc_bwd_kernel``).

Both kernels of this module run on the block-tiled product
(``csrc/dense_tile.cuh``) over 16, 32 or 64 rows a block: per row the image
tower does about 1.3 M multiply-adds each way on weights read from L2, and
each weight byte a block reads serves all its rows (fp32 on register
tiles, bf16 on tensor cores). Each product's input streams back from
device memory (the forward's hidden activations from a workspace the
wrapper allocates per call), so no width bounds a tile; where a small
batch leaves SMs idle, blocks that share a row tile split its column
tiles. The forward's per-row loss is summed in one fixed order, so a
second call gives the same bits.

The weight grads of stages 1 and 3 are sums over all rows, which the TPU
kernels accumulate tile after tile; here the per-row kernels write their
operands to scratch and ``mlp.weight_grads`` adds them deterministically.

This is the training step's engine (``use_pallas="mega"``), differentiable
with respect to the weights only: the reference returns a zero cotangent
for x (its closed-world invariant), and the port refuses an x that
requires grad instead of returning a silent zero. ε is the draw the
in-kernel decoder consumed — from ``seed`` by a counter-based Philox
indexed by (row, column), so it does not depend on the tile height, or
injected — and carries no gradient.

Dispatch is by the device of the input, and only by it: a CPU tensor goes
to the plain twins in this module (the CPU tests' path); a CUDA tensor
launches the kernels or raises.
"""

from __future__ import annotations

import ctypes

import torch

from vae_assoc_tpu_torch.kernels import _build, _launches
from vae_assoc_tpu_torch.kernels import mlp as kmlp
from vae_assoc_tpu_torch.kernels.sampling import seed_arg
from vae_assoc_tpu_torch.models import networks
from vae_assoc_tpu_torch.ops.sampling import philox_normal

LAUNCHES = _launches.TRAINING
"""Launches of the training kernels (``mega_fwd``, ``mega_dec_loss_bwd``,
``enc_bwd``, ``wgrad``) since the last ``kernels.reset_launches()``."""

KINDS = ("bernoulli", "gaussian")


def flatten(params) -> list:
    """The 14 weight tensors of one modality's towers, in the reference's
    order: w1 b1 w2 b2 wm bm wl bl (encoder), d1 c1 d2 c2 do co (decoder)."""
    r, g = params.recog, params.gener
    layers = (r["h1"], r["h2"], r["out_mean"], r["out_logvar"],
              g["h1"], g["h2"], g["out"])
    return [t for l in layers for t in (l.w, l.b)]


def unflatten_grads(flat_grads) -> dict:
    """Inverse of :func:`flatten` for the 14 gradients: a nested dict with
    the module tree's names (``["recog"]["h1"]["w"]``)."""
    names = (("recog", "h1"), ("recog", "h2"), ("recog", "out_mean"),
             ("recog", "out_logvar"), ("gener", "h1"), ("gener", "h2"),
             ("gener", "out"))
    out: dict = {"recog": {}, "gener": {}}
    for i, (net, layer) in enumerate(names):
        out[net][layer] = {"w": flat_grads[2 * i], "b": flat_grads[2 * i + 1]}
    return out


def _dims(flat, x):
    """(n_in, h1e, h2e, n_z, n_cond, h1d, h2d, n_x) of a tower on x."""
    n_in = x.shape[1]
    n_z = flat[4].shape[1]
    n_cond = flat[8].shape[0] - n_z
    n_x = flat[12].shape[1]
    if n_in != n_x + n_cond:
        raise ValueError(
            f"x has {n_in} columns; the tower takes {n_x} data columns and "
            f"{n_cond} cond columns"
        )
    return (n_in, flat[0].shape[1], flat[2].shape[1], n_z, n_cond,
            flat[8].shape[1], flat[10].shape[1], n_x)


def _mm(a, w, cd):
    return networks.round_operand(a, cd) @ networks.round_operand(w, cd)


# ---------------------------------------------------------------------------
# Plain twins
# ---------------------------------------------------------------------------


def tower_fwd_plain(flat, x, eps, *, kind, compute_dtype="float32"):
    """Plain twin of the forward kernel: (μ, logσ², ε, recon [B], kl [B])."""
    cd = networks.dtype_name(compute_dtype)
    w1, b1, w2, b2, wm, bm, wl, bl, d1, c1, d2, c2, do, co = flat
    _, _, _, n_z, n_cond, _, _, n_x = _dims(flat, x)
    sp = networks.softplus
    h1 = sp(_mm(x, w1, cd) + b1)
    h2 = sp(_mm(h1, w2, cd) + b2)
    mu = _mm(h2, wm, cd) + bm
    lv = _mm(h2, wl, cd) + bl
    z = mu + torch.exp(0.5 * lv) * eps
    z_in = torch.cat([z, x[:, n_x:]], dim=1) if n_cond else z
    g1 = sp(_mm(z_in, d1, cd) + c1)
    g2 = sp(_mm(g1, d2, cd) + c2)
    r = _mm(g2, do, cd) + co
    xd = x[:, :n_x]
    if kind == "bernoulli":
        rec = (torch.clamp_min(r, 0.0) - r * xd + torch.log1p(torch.exp(-torch.abs(r)))).sum(-1)
    else:
        rec = ((xd - r) ** 2).sum(-1)
    kl = -0.5 * (1.0 + lv - mu * mu - torch.exp(lv)).sum(-1)
    return mu, lv, eps, rec, kl


def _dec_loss_bwd(x, z, dec_flat, grec, kind, cd, dsoftplus):
    """The decoder+loss backward's formulas; ``dsoftplus(pre, post)`` is
    softplus'(pre) = σ(pre), from the pre- or the post-activation."""
    d1, c1, d2, c2, do, co = (t.detach() for t in dec_flat)
    n_z = z.shape[1]
    n_cond = d1.shape[0] - n_z
    if n_cond:
        n_x = x.shape[1] - n_cond
        z = torch.cat([z, x[:, n_x:]], dim=1)
        x = x[:, :n_x]
    b1d = _mm(z, d1, cd) + c1
    g1 = networks.softplus(b1d)
    b2d = _mm(g1, d2, cd) + c2
    g2 = networks.softplus(b2d)
    r = _mm(g2, do, cd) + co
    if kind == "bernoulli":
        dr = (torch.sigmoid(r) - x) * grec[:, None]
    else:
        dr = 2.0 * (r - x) * grec[:, None]
    db2d = _mm(dr, do.T, cd) * dsoftplus(b2d, g2)
    db1d = _mm(db2d, d2.T, cd) * dsoftplus(b1d, g1)
    dz = _mm(db1d, d1.T, cd)[:, :n_z]
    grads = []
    for a, d in ((z, db1d), (g1, db2d), (g2, dr)):
        grads += list(kmlp.weight_grads_plain(a, d, compute_dtype=cd))
    return dz, grads


def dec_loss_bwd_plain(x, z, dec_flat, grec, *, kind, compute_dtype="float32"):
    """Plain twin of the decoder+loss backward and its weight grads:
    (dz [B, n_z], [dd1, dc1, dd2, dc2, ddo, dco]). Explicit formulas with
    each product's operands rounded under the bf16 policy, as
    megakernel.py::_dec_loss_bwd_kernel (autograd of the forward twin would
    round each product's result instead)."""
    return _dec_loss_bwd(x, z, dec_flat, grec, kind, networks.dtype_name(compute_dtype),
                         lambda pre, post: torch.sigmoid(pre))


def dec_loss_bwd_mirror(x, z, dec_flat, grec, *, kind, compute_dtype="float32"):
    """The kernel's arithmetic in plain torch: the twin's formulas with
    σ(pre) recovered from the saved post-activation g as −expm1(−g), as
    csrc/mega.cu's backward does (it keeps no pre-activation)."""
    return _dec_loss_bwd(x, z, dec_flat, grec, kind, networks.dtype_name(compute_dtype),
                         lambda pre, post: -torch.expm1(-post))


# ---------------------------------------------------------------------------
# Kernels
# ---------------------------------------------------------------------------


def fwd_plan(dims, batch: int, n_sm: int, compute_dtype="float32"):
    """(rows per block, dynamic shared memory in bytes, blocks per row tile)
    for the forward kernel on a tower of ``dims`` (:func:`_dims`);
    csrc/mega.cu computes the same bytes and refuses a launch that
    disagrees. Rows and blocks as the stack forward's over the tower's
    products (:func:`kmlp.stack_fwd_plan`); shared memory: that ring, then
    the loss partials, 32 floats a row. Every row's operands stream from
    device memory, so no width bounds the tile. Raises on an empty batch."""
    _, h1e, h2e, n_z, _, h1d, h2d, n_x = dims
    rows, ring, parts = kmlp.stack_fwd_plan((h1e, h2e, n_z, h1d, h2d, n_x), batch, n_sm,
                                            compute_dtype)
    return rows, ring + 4 * 32 * rows, parts


def dec_bwd_plan(batch: int, n_sm: int, compute_dtype="float32"):
    """(rows per block, dynamic shared memory in bytes) for the decoder+loss
    backward kernel; csrc/mega.cu computes the same bytes and refuses a
    launch that disagrees. Rows: 16, 32 or 64 from the batch
    (:func:`kmlp.dense_tile_rows`). Shared memory: the ring of its largest
    product, W^T with A streamed; every row's operands stream from device
    memory, so no width bounds the tile."""
    rows = kmlp.dense_tile_rows(batch, n_sm)
    bf16 = networks.dtype_name(compute_dtype) == "bfloat16"
    return rows, kmlp.dense_ring_bytes(rows, True, True, bf16)


dec_bwd_parts = kmlp.dense_parts
"""Blocks that share each row tile of the backward kernel: the rule of
every kernel on the block-tiled product."""


def _ptrs(tensors):
    return (ctypes.c_void_p * len(tensors))(*[t.data_ptr() for t in tensors])


def _check_flat(flat, x):
    for i, t in enumerate(flat):
        kmlp._check_f32(t, x.device, f"tower weight {i}")


def _launch_fwd(flat, x, eps, seed, kind, cd):
    dev = x.device
    dims = _dims(flat, x)
    batch, (_, h1e, h2e, n_z, n_cond, h1d, h2d, _) = x.shape[0], dims
    kmlp._check_f32(x, dev, "x")
    _check_flat(flat, x)
    if eps is not None:
        kmlp._check_f32(eps, dev, "eps", (batch, n_z))
    outs = [torch.empty(batch, n_z, dtype=torch.float32, device=dev) for _ in range(3)]
    outs += [torch.empty(batch, dtype=torch.float32, device=dev) for _ in range(2)]
    if batch == 0:
        return outs
    lib = _build.load()
    rows, smem, parts = fwd_plan(dims, batch, kmlp.sm_count(dev), cd)
    ldh = kmlp._pad4(max(h1e, h2e, n_z + n_cond, h1d, h2d))
    ws = torch.empty(2, batch, ldh, dtype=torch.float32, device=dev)
    rec_parts = (torch.empty(parts - 1, batch, dtype=torch.float32, device=dev)
                 if parts > 1 else None)
    with torch.cuda.device(dev):
        err = lib.vae_mega_fwd(
            x.data_ptr(), batch, _ptrs(flat), (ctypes.c_int * 8)(*dims),
            int(kind == "bernoulli"), eps.data_ptr() if eps is not None else None,
            *seed_arg(0 if seed is None else seed, dev), *(o.data_ptr() for o in outs),
            ws.data_ptr(), ldh,
            rec_parts.data_ptr() if rec_parts is not None else None, rows, smem, parts,
            int(cd == "bfloat16"), kmlp._stream(x),
        )
    _build.check(lib, err, "tower forward kernel launch")
    _launches.count(LAUNCHES, "mega_fwd")
    return outs


def _dec_loss_bwd_kernel(x, z, dec_flat, grec, kind, cd):
    """The backward kernel alone: dz and the weight grads' (A, D) operand
    pairs, ([z, cond], db1d), (g1, db2d), (g2, dr), from its scratch."""
    dev = x.device
    n_z = z.shape[1]
    d1, c1, d2, c2, do, co = weights = [t.detach() for t in dec_flat]
    batch, n_in = x.shape
    n_cond = d1.shape[0] - n_z
    n_x, h1d, h2d = do.shape[1], d1.shape[1], d2.shape[1]
    if n_in != n_x + n_cond:
        raise ValueError(f"x has {n_in} columns, the decoder {n_x} + {n_cond}")
    kmlp._check_f32(x, dev, "x")
    kmlp._check_f32(z, dev, "z", (batch, n_z))
    kmlp._check_f32(grec, dev, "grec", (batch,))
    for i, t in enumerate(weights):
        kmlp._check_f32(t, dev, f"decoder weight {i}")

    def buf(n):
        return torch.empty(batch, n, dtype=torch.float32, device=dev)

    zin, g1, g2, dr, db2d, db1d = (buf(n) for n in (n_z + n_cond, h1d, h2d, n_x, h2d, h1d))
    dz = buf(n_z)
    if batch:
        lib = _build.load()
        n_sm = kmlp.sm_count(dev)
        rows, smem = dec_bwd_plan(batch, n_sm, cd)
        with torch.cuda.device(dev):
            err = lib.vae_mega_dec_loss_bwd(
                x.data_ptr(), z.data_ptr(), grec.data_ptr(), batch, _ptrs(weights),
                _ptrs([zin, g1, g2, dr, db2d, db1d]),
                (ctypes.c_int * 6)(n_in, n_z, n_cond, h1d, h2d, n_x),
                int(kind == "bernoulli"), dz.data_ptr(), rows, smem,
                dec_bwd_parts(batch, rows, n_sm), int(cd == "bfloat16"), kmlp._stream(x),
            )
        _build.check(lib, err, "decoder+loss backward kernel launch")
        _launches.count(LAUNCHES, "mega_dec_loss_bwd")
    return dz, ((zin, db1d), (g1, db2d), (g2, dr))


def _launch_dec_loss_bwd(x, z, dec_flat, grec, kind, cd):
    dz, pairs = _dec_loss_bwd_kernel(x, z, dec_flat, grec, kind, cd)
    grads = []
    for a, d in pairs:
        grads += list(kmlp.weight_grads(a, d, compute_dtype=cd))
    return dz, grads


def tower_fwd(flat, x, *, kind, eps=None, seed=None, compute_dtype="float32"):
    """The forward kernel on a CUDA tensor, its twin on the CPU:
    (μ, logσ², ε, recon [B], kl [B]) with ε injected or drawn from ``seed``."""
    cd = networks.dtype_name(compute_dtype)
    if kind not in KINDS:
        raise ValueError(f"kind must be one of {KINDS}, got {kind!r}")
    if eps is None and seed is None:
        raise ValueError("vae_tower_fused needs `seed` or `eps`")
    if x.device.type == "cpu":
        if eps is None:
            eps = philox_normal(seed, x.shape[0], flat[4].shape[1], x.device)
        return tower_fwd_plain(flat, x, eps.float(), kind=kind, compute_dtype=cd)
    if x.device.type != "cuda":
        raise ValueError(f"the tower kernel runs on CUDA, got {x.device}")
    return _launch_fwd(flat, x, eps, seed, kind, cd)


def dec_loss_bwd(x, z, dec_flat, grec, *, kind, compute_dtype="float32"):
    """The decoder+loss backward kernel and its weight grads on a CUDA
    tensor, the twin on the CPU; result as :func:`dec_loss_bwd_plain`."""
    cd = networks.dtype_name(compute_dtype)
    if x.device.type == "cpu":
        return dec_loss_bwd_plain(x, z, dec_flat, grec, kind=kind, compute_dtype=cd)
    if x.device.type != "cuda":
        raise ValueError(f"the tower kernel runs on CUDA, got {x.device}")
    return _launch_dec_loss_bwd(x, z.contiguous(), dec_flat, grec.contiguous(), kind, cd)


class _Tower(torch.autograd.Function):
    """Inputs: kind, compute dtype, seed, x, ε (or None), the 14 weights."""

    @staticmethod
    def forward(ctx, kind, cd, seed, x, eps, *flat):
        if ctx.needs_input_grad[3] or ctx.needs_input_grad[4]:
            raise ValueError(
                "vae_tower_fused is differentiable with respect to the weights "
                "only; x and eps must not require grad (the reference returns a "
                "zero input gradient here)"
            )
        mu, lv, eps_out, rec, kl = tower_fwd(flat, x, kind=kind, eps=eps, seed=seed,
                                             compute_dtype=cd)
        ctx.kind, ctx.cd = kind, cd
        ctx.save_for_backward(x, mu, lv, eps_out, *flat)
        ctx.mark_non_differentiable(eps_out)
        return mu, lv, eps_out, rec, kl

    @staticmethod
    def backward(ctx, g_mu, g_lv, g_eps, g_rec, g_kl):
        # g_eps is unused: ε is the noise draw itself and depends on no
        # weight; consumers' z = μ + σ·ε reach the weights through g_mu, g_lv.
        x, mu, lv, eps, *flat = ctx.saved_tensors
        sig = torch.exp(0.5 * lv)
        z = mu + sig * eps
        # Stage 1: decoder + loss.
        dz, dec_grads = dec_loss_bwd(x, z, flat[8:], g_rec, kind=ctx.kind,
                                     compute_dtype=ctx.cd)
        # Stage 2: reparameterization and KL, elementwise.
        gkl = g_kl[:, None]
        dmu = dz + g_mu + mu * gkl
        dlv = g_lv + 0.5 * (torch.exp(lv) - 1.0) * gkl + 0.5 * dz * sig * eps
        # Stage 3: the encoder stack, weights only: the kernel skips dx,
        # which the reference computes and drops.
        layers = kmlp._pairs(flat[:8])
        enc_grads, _ = kmlp.encode_bwd(layers[:2], layers[2:], x, dmu, dlv,
                                       compute_dtype=ctx.cd, want_dx=False)
        return (None, None, None, None, None,
                *(g for pair in enc_grads for g in pair), *dec_grads)


def vae_tower_fused(params, x, *, kind, seed=None, eps=None,
                    compute_dtype="float32", cond=None):
    """Whole VAE tower and its per-sample loss terms in one forward launch.

    Returns dict(mu [B, n_z], lv [B, n_z], eps [B, n_z], recon_term [B],
    kl_term [B]). ε is drawn from ``seed`` (an int, or a 0-dim int64 tensor
    on the device that the kernel reads when it runs) or injected as ``eps``;
    the returned ε is exactly the draw the decoder consumed, so
    ``mu + exp(0.5·lv)·eps`` is the decoder's z. ``cond`` [B, n_cond]
    (already encoded, models/vae.prepare_cond) widens the encoder input;
    the kernel re-reads its columns at the decoder's input and compares the
    loss against the data columns only."""
    x = x.float()
    if cond is not None:
        x = torch.cat([x, cond.float()], dim=1)
    x = x.contiguous()
    if eps is not None:
        eps = eps.float().contiguous()
    mu, lv, eps_out, rec, kl = _Tower.apply(
        kind, networks.dtype_name(compute_dtype), seed, x, eps, *flatten(params)
    )
    return {"mu": mu, "lv": lv, "eps": eps_out, "recon_term": rec, "kl_term": kl}
