"""The conv-tower megakernel for training: hand-written CUDA kernels and their plain twins.

Counterpart of vae_assoc_tpu/kernels/conv_mega.py. ``conv_tower_fused``
runs one conv modality's whole tower in one forward launch per direction:
``csrc/conv_mega.cu::conv_enc`` (replacing the Pallas ``_enc_kernel``:
conv1 → softplus → conv2 → softplus → dense → softplus → μ, logσ² heads,
16–64 rows a block: :func:`enc_plan`), then z = μ + e^{½logσ²}·ε in torch,
then ``conv_dec`` (replacing ``_dec_kernel``: dense1 → dense2 → convt1 →
softplus → convt2 → per-row Bernoulli or Gaussian loss, 64 rows a block:
:func:`dec_plan`). Each kernel writes the post-activations the backward
needs, in NHWC.

The backward, a ``torch.autograd.Function``, is the reference's
``_conv_tower_bwd`` formula by formula: σ(pre) recovered from the saved
post-activation as 1 − e^{−post}; the input gradients of convt2, convt1 and
conv2 through kernels/conv.py's ``conv_fwd`` (conv1's is never computed:
its input is the data); all four conv weight grads through ``conv_dw``; the
dense layers' grads with ``torch.matmul``, as the reference leaves them to
XLA.

This is the training step's engine for ``encoder="conv_pallas"`` under
``use_pallas="mega"``, differentiable with respect to the weights only: the
reference returns a zero cotangent for x, and the port refuses an x that
requires grad. ε is ``models/vae.draw_eps(seed)``, the Philox stream of
every other path, or injected. KL is computed in torch outside the Function,
as the reference does. ``conv_tower_xla`` is config 4's own tower
(``encoder="conv"``), the plain torch convs of models/conv.py plus the
losses, under the reference's name.

Dispatch is by the device of the input, and only by it: a CPU tensor goes to
the plain twins in this module; a CUDA tensor launches the kernels or raises.
"""

from __future__ import annotations

import ctypes

import torch

from vae_assoc_tpu_torch.kernels import _build, _launches
from vae_assoc_tpu_torch.kernels import conv as kconv
from vae_assoc_tpu_torch.kernels import mlp as kmlp
from vae_assoc_tpu_torch.models import conv as conv_mod
from vae_assoc_tpu_torch.models import networks
from vae_assoc_tpu_torch.ops import losses
from vae_assoc_tpu_torch.ops.sampling import philox_normal

KINDS = ("bernoulli", "gaussian")
DEC_TILE_ROWS = 64
"""Rows per block of the decoder kernel (``kDecTM`` in csrc/conv_mega.cu)."""
_CONV_STAGES = 3
"""Slices in the cp.async ring of the kernels' tiled convs (``kCStages``)."""
IMG, MID, SMALL = conv_mod.IMG_SIZE, conv_mod.MID, conv_mod.SMALL
C1, C2, FLAT = conv_mod.C1, conv_mod.C2, conv_mod.FLAT
_ENC_LAYERS = (("recog", "conv1"), ("recog", "conv2"), ("recog", "dense"),
               ("recog", "out_mean"), ("recog", "out_logvar"))
_DEC_LAYERS = (("gener", "dense1"), ("gener", "dense2"), ("gener", "convt1"),
               ("gener", "convt2"))


def flatten(params) -> list:
    """The 18 weight tensors of a conv tower in the reference's order:
    conv1, conv2, dense, out_mean, out_logvar (encoder: 10), then dense1,
    dense2, convt1, convt2 (decoder: 8), each (w, b)."""
    out = []
    for net, name in _ENC_LAYERS + _DEC_LAYERS:
        layer = getattr(params, net)[name]
        out += [layer.w, layer.b]
    return out


def _mm(a, w, cd):
    return networks.round_operand(a, cd) @ networks.round_operand(w, cd)


_sp = networks.softplus


def _dsp(post):
    """softplus'(pre) = σ(pre) from the post-activation: 1 − e^{−post}."""
    return 1.0 - torch.exp(-post)


# ---------------------------------------------------------------------------
# Plain twins
# ---------------------------------------------------------------------------


def conv_enc_plain(enc_flat, x3, *, compute_dtype="float32"):
    """Plain twin of the encoder kernel: x3 [B, 28, 28] → (μ, logσ² [B, n_z],
    a1 [B, 14, 14, 32], a2 [B, 7, 7, 64], h [B, hr])."""
    cd = networks.dtype_name(compute_dtype)
    w1, b1, w2, b2, wd, bd, wm, bm, wl, bl = enc_flat
    a1 = _sp(conv_mod.conv3x3_s2(x3.float()[..., None], w1, b1, compute_dtype=cd))
    a2 = _sp(conv_mod.conv3x3_s2(a1, w2, b2, compute_dtype=cd))
    h = _sp(_mm(a2.reshape(a2.shape[0], FLAT), wd, cd) + bd)
    return _mm(h, wm, cd) + bm, _mm(h, wl, cd) + bl, a1, a2, h


def _recon(r, x, kind):
    """Per-row loss of logits r against x, both [B, 784]: the kernel's sum."""
    return (losses.bernoulli_recon(x, logits=r) if kind == "bernoulli"
            else losses.gaussian_recon(x, r))


def conv_dec_plain(dec_flat, z, x3, *, kind, compute_dtype="float32"):
    """Plain twin of the decoder kernel: z [B, n_z], x3 [B, 28, 28] →
    (recon [B], g1 [B, hg], g2 [B, 7, 7, 64], d1p [B, 14, 14, 32],
    r [B, 28, 28, 1] the logits)."""
    cd = networks.dtype_name(compute_dtype)
    d1, c1, d2, c2, wt1, bt1, wt2, bt2 = dec_flat
    g1 = _sp(_mm(z, d1, cd) + c1)
    g2 = _sp(_mm(g1, d2, cd) + c2).reshape(-1, SMALL, SMALL, C2)
    d1p = _sp(conv_mod.convt3x3_s2(g2, wt1, bt1, compute_dtype=cd))
    r = conv_mod.convt3x3_s2(d1p, wt2, bt2, compute_dtype=cd)
    return _recon(r.reshape(-1, IMG * IMG), x3.float().reshape(-1, IMG * IMG), kind), g1, g2, d1p, r


# ---------------------------------------------------------------------------
# Kernels
# ---------------------------------------------------------------------------


def _pad32(n: int) -> int:
    return -(-n // 32) * 32


def _conv_class_smem(bf16: bool, k: int, cout: int) -> int:
    """Shared memory of the kernels' tiled conv over one parity class of k
    patch columns into cout channels (csrc/conv_mega.cu::conv_class_smem): a
    ring of 3 slices of the tile's pixels × 32 channels (fp32, rows of 36),
    the tile's pixel rows twice, the class's weight rows (bf16: [cout][k +
    8], and two rounded slices)."""
    if bf16:
        tile = kconv.MMA_TILE
        weight = 2 * cout * (k + 8) + 2 * 2 * tile * (kconv.STAGE_K + 8)
    else:
        tile = kconv.FFMA_TILE
        weight = 4 * k * cout
    return 4 * _CONV_STAGES * tile * (kconv.STAGE_K + 4) + 2 * 16 * tile + weight


def enc_plan(batch: int, n_sm: int, compute_dtype="float32"):
    """(rows per block, dynamic shared memory in bytes) of the encoder
    kernel; csrc/conv_mega.cu computes the same bytes and refuses a launch
    that disagrees. Rows: 16, 32 or 64 from the batch
    (:func:`kmlp.dense_tile_rows`). Shared memory: conv2's tiled class (9
    taps × 32 channels into 64) or the dense layer's ring with a2 streamed,
    whichever is larger; a1, a2 and h go through device memory, so hr does
    not bound the tile."""
    bf16 = networks.dtype_name(compute_dtype) == "bfloat16"
    rows = kmlp.dense_tile_rows(batch, n_sm)
    return rows, max(_conv_class_smem(bf16, 9 * C1, C2),
                     kmlp.dense_ring_bytes(rows, False, True, bf16))


def dec_plan(hg: int, n_z: int, compute_dtype="float32"):
    """(rows per block, dynamic shared memory in bytes) of the decoder
    kernel; csrc/conv_mega.cu computes the same bytes and refuses a launch
    that disagrees. Its dense stages keep the 64 rows' z and g1 (fp32 rows
    of k + 4, bf16 rows of k + 8, k padded to 32) and the product's weight
    ring; the transposed convs reuse it (convt1: the tiled class of at most
    4 taps × 64 channels into 32). Raises when that does not fit a block's
    shared memory."""
    bf16 = networks.dtype_name(compute_dtype) == "bfloat16"
    pad = 8 if bf16 else 4
    dense = ((2 if bf16 else 4) * DEC_TILE_ROWS * (_pad32(n_z) + pad + _pad32(hg) + pad)
             + kmlp.dense_ring_bytes(DEC_TILE_ROWS, False, False, bf16))
    smem = max(dense, _conv_class_smem(bf16, 4 * C2, C1))
    if smem + kconv.PLAN_BYTES > kmlp.SMEM_BYTES:
        raise ValueError(f"the conv decoder kernel keeps {DEC_TILE_ROWS} rows of z and g1 "
                         f"(n_z {n_z}, hg {hg}) and its weight ring in {smem} bytes of shared "
                         f"memory, more than a block has")
    return DEC_TILE_ROWS, smem


def _ptrs(tensors):
    return (ctypes.c_void_p * len(tensors))(*[t.data_ptr() for t in tensors])


def _weights(flat, dev):
    flat = [t.detach() for t in flat]
    for i, t in enumerate(flat):
        kmlp._check_f32(t, dev, f"conv tower weight {i}")
    return flat


def _launch_enc(enc_flat, x3, cd):
    dev = x3.device
    flat = _weights(enc_flat, dev)
    b = x3.shape[0]
    kmlp._check_f32(x3, dev, "x", (b, IMG, IMG))
    hr, n_z = flat[4].shape[1], flat[6].shape[1]

    def buf(*shape):
        return torch.empty(b, *shape, dtype=torch.float32, device=dev)

    mu, lv, a1, a2, h = buf(n_z), buf(n_z), buf(MID, MID, C1), buf(SMALL, SMALL, C2), buf(hr)
    if b:
        lib = _build.load()
        rows, smem = enc_plan(b, kmlp.sm_count(dev), cd)
        plan = kconv._plan_table(kconv.phase_plan(2, False, 0, SMALL))
        with torch.cuda.device(dev):
            err = lib.vae_conv_enc(x3.data_ptr(), b, _ptrs(flat), hr, n_z,
                                   *(t.data_ptr() for t in (mu, lv, a1, a2, h)), plan, rows,
                                   smem, int(cd == "bfloat16"), kmlp._stream(x3))
        _build.check(lib, err, "conv encoder kernel launch")
        _launches.count(_launches.TRAINING, "conv_enc")
    return mu, lv, a1, a2, h


def _launch_dec(dec_flat, z, x3, kind, cd):
    dev = x3.device
    flat = _weights(dec_flat, dev)
    b, n_z = z.shape
    hg = flat[0].shape[1]
    kmlp._check_f32(x3, dev, "x", (b, IMG, IMG))
    kmlp._check_f32(z, dev, "z", (b, flat[0].shape[0]))

    def buf(*shape):
        return torch.empty(b, *shape, dtype=torch.float32, device=dev)

    rec, g1, g2, d1p, r = buf(), buf(hg), buf(SMALL, SMALL, C2), buf(MID, MID, C1), buf(IMG, IMG, 1)
    if b:
        lib = _build.load()
        _, smem = dec_plan(hg, n_z, cd)
        plans = [kconv._plan_table(kconv.phase_plan(1, True, 2, out)) for out in (MID, IMG)]
        with torch.cuda.device(dev):
            err = lib.vae_conv_dec(z.data_ptr(), x3.data_ptr(), b, _ptrs(flat), hg, n_z,
                                   int(kind == "bernoulli"),
                                   *(t.data_ptr() for t in (rec, g1, g2, d1p, r)), *plans,
                                   smem, int(cd == "bfloat16"), kmlp._stream(x3))
        _build.check(lib, err, "conv decoder kernel launch")
        _launches.count(_launches.TRAINING, "conv_dec")
    return rec, g1, g2, d1p, r


def conv_enc(enc_flat, x3, *, compute_dtype="float32"):
    """The encoder kernel on a CUDA tensor, its twin on the CPU; result as
    :func:`conv_enc_plain`."""
    cd = networks.dtype_name(compute_dtype)
    if x3.device.type == "cpu":
        return conv_enc_plain(enc_flat, x3, compute_dtype=cd)
    if x3.device.type != "cuda":
        raise ValueError(f"the conv encoder kernel runs on CUDA, got {x3.device}")
    return _launch_enc(enc_flat, x3.float().contiguous(), cd)


def conv_dec(dec_flat, z, x3, *, kind, compute_dtype="float32"):
    """The decoder kernel on a CUDA tensor, its twin on the CPU; result as
    :func:`conv_dec_plain`."""
    cd = networks.dtype_name(compute_dtype)
    if kind not in KINDS:
        raise ValueError(f"kind must be one of {KINDS}, got {kind!r}")
    if x3.device.type == "cpu":
        return conv_dec_plain(dec_flat, z, x3, kind=kind, compute_dtype=cd)
    if x3.device.type != "cuda":
        raise ValueError(f"the conv decoder kernel runs on CUDA, got {x3.device}")
    return _launch_dec(dec_flat, z.detach().float().contiguous(), x3.float().contiguous(),
                       kind, cd)


# ---------------------------------------------------------------------------
# The tower
# ---------------------------------------------------------------------------


def _bias_grad(d):
    return d.reshape(-1, d.shape[-1]).sum(0)


class _ConvTower(torch.autograd.Function):
    """Inputs: kind, compute dtype, x3 [B, 28, 28], ε [B, n_z], the 18
    weights. Outputs: μ, logσ², recon [B]."""

    @staticmethod
    def forward(ctx, kind, cd, x3, eps, *flat):
        if ctx.needs_input_grad[2] or ctx.needs_input_grad[3]:
            raise ValueError(
                "conv_tower_fused is differentiable with respect to the weights only; "
                "x and eps must not require grad (the reference returns a zero input "
                "gradient here)")
        mu, lv, a1, a2, h = conv_enc(flat[:10], x3, compute_dtype=cd)
        z = mu + torch.exp(0.5 * lv) * eps
        rec, g1, g2, d1p, r = conv_dec(flat[10:], z, x3, kind=kind, compute_dtype=cd)
        ctx.kind, ctx.cd = kind, cd
        ctx.save_for_backward(x3, eps, mu, lv, a1, a2, h, g1, g2, d1p, r, *flat)
        return mu, lv, rec

    @staticmethod
    def backward(ctx, g_mu, g_lv, g_rec):
        x3, eps, mu, lv, a1, a2, h, g1, g2, d1p, r, *flat = ctx.saved_tensors
        (w1, _, w2, _, wd, _, wm, _, wl, _, d1, _, d2, _, wt1, _, wt2, _) = (
            t.detach() for t in flat)
        cd = ctx.cd
        b = x3.shape[0]

        def dx(dy, w, stride, dilate, pads, in_hw):
            return kconv.conv_dx(dy, w.reshape(-1, w.shape[-1]), w.shape[2], stride,
                                 dilate, pads, in_hw, compute_dtype=cd)

        def dw(x, dy, stride, dilate, pads, out_hw, w):
            return kconv.conv_dw(x, dy, stride, dilate, pads, out_hw,
                                 compute_dtype=cd).reshape(w.shape)

        # Loss → logits.
        grec = g_rec[:, None, None, None]
        xt = x3[..., None]
        dr = ((torch.sigmoid(r) - xt) * grec if ctx.kind == "bernoulli"
              else 2.0 * (r - xt) * grec).contiguous()
        # convt2 (input d1p), convt1 (input g2).
        dd1p = dx(dr, wt2, 1, True, (2, 1), MID)
        dwt2 = dw(d1p, dr, 1, True, (2, 1), IMG, wt2)
        dpre_d1p = (dd1p * _dsp(d1p)).contiguous()
        dg2 = dx(dpre_d1p, wt1, 1, True, (2, 1), SMALL)
        dwt1 = dw(g2, dpre_d1p, 1, True, (2, 1), MID, wt1)
        dpre_g2 = (dg2 * _dsp(g2)).reshape(b, FLAT)
        # dense2, dense1.
        dd2 = _mm(g1.T, dpre_g2, cd)
        dpre_g1 = _mm(dpre_g2, d2.T, cd) * _dsp(g1)
        sig = torch.exp(0.5 * lv)
        z = mu + sig * eps
        dd1 = _mm(z.T, dpre_g1, cd)
        dz = _mm(dpre_g1, d1.T, cd)
        # Reparameterization (g_mu, g_lv carry the KL's cotangents).
        dmu = dz + g_mu
        dlv = g_lv + 0.5 * dz * sig * eps
        # Heads and dense.
        dwm, dwl = _mm(h.T, dmu, cd), _mm(h.T, dlv, cd)
        dpre_h = (_mm(dmu, wm.T, cd) + _mm(dlv, wl.T, cd)) * _dsp(h)
        a2f = a2.reshape(b, FLAT)
        dwd = _mm(a2f.T, dpre_h, cd)
        dpre_a2 = (_mm(dpre_h, wd.T, cd).reshape(a2.shape) * _dsp(a2)).contiguous()
        # conv2 (input a1), conv1 (input the data: no dx).
        da1 = dx(dpre_a2, w2, 2, False, (0, 1), MID)
        dw2 = dw(a1, dpre_a2, 2, False, (0, 1), SMALL, w2)
        dpre_a1 = (da1 * _dsp(a1)).contiguous()
        dw1 = dw(x3[..., None].contiguous(), dpre_a1, 2, False, (0, 1), MID, w1)
        grads = (dw1, _bias_grad(dpre_a1), dw2, _bias_grad(dpre_a2),
                 dwd, dpre_h.sum(0), dwm, dmu.sum(0), dwl, dlv.sum(0),
                 dd1, dpre_g1.sum(0), dd2, dpre_g2.sum(0),
                 dwt1, _bias_grad(dpre_d1p), dwt2, _bias_grad(dr))
        return (None, None, None, None, *grads)


def _eps(params, x, kind, seed, eps, what):
    """The tower's ε [B, n_z], fp32: injected, or drawn from ``seed`` (the
    Philox stream of models/vae.draw_eps)."""
    if kind not in KINDS:
        raise ValueError(f"kind must be one of {KINDS}, got {kind!r}")
    if eps is None:
        if seed is None:
            raise ValueError(f"{what} needs `seed` or `eps`")
        eps = philox_normal(seed, x.shape[0], params.recog["out_mean"].w.shape[1], x.device)
    return eps.float().contiguous()


def conv_tower_fused(params, x, *, kind, seed=None, eps=None, compute_dtype="float32"):
    """Whole conv VAE tower and its per-sample loss terms, one forward kernel
    per direction. Returns dict(mu, lv [B, n_z], recon_term, kl_term [B]);
    ε from ``seed`` or injected as ``eps``."""
    eps = _eps(params, x, kind, seed, eps, "conv_tower_fused")
    x3 = x.float().reshape(x.shape[0], IMG, IMG).contiguous()
    mu, lv, rec = _ConvTower.apply(kind, networks.dtype_name(compute_dtype), x3, eps,
                                   *flatten(params))
    return {"mu": mu, "lv": lv, "recon_term": rec, "kl_term": losses.kl_divergence(mu, lv)}


def conv_tower_xla(params, x, *, kind, seed=None, eps=None, compute_dtype="float32"):
    """Config 4's tower (``encoder="conv"``): the plain torch convs of
    models/conv.py and the losses, with the return of
    :func:`conv_tower_fused`. Named after the reference's XLA tower."""
    eps = _eps(params, x, kind, seed, eps, "conv_tower_xla")
    x = x.float()
    mu, lv = conv_mod.encode_conv(params, x, compute_dtype=compute_dtype)
    z = mu + torch.exp(0.5 * lv) * eps
    r = conv_mod.decode_conv(params, z, compute_dtype=compute_dtype)
    return {"mu": mu, "lv": lv, "recon_term": _recon(r, x, kind),
            "kl_term": losses.kl_divergence(mu, lv)}
