"""The conv tower's linear primitive and its weight gradient: hand-written CUDA kernels and their plain twins.

Counterpart of vae_assoc_tpu/kernels/conv.py (the im2col kernels) and of
vae_assoc_tpu/kernels/conv_banded.py (the banded kernels), which compute the
same two layer functions. One kernel backs both: the banded formulation's
band matrices and row-parity plans exist for the TPU's 128-lane layout,
which Hopper does not have, so it is not ported as a module.

    conv_fwd(x, w2d; stride, dilate, pads, out_hw)   csrc/conv.cu::conv_fwd
      stride 2, no dilation, pads (0, 1)  the SAME stride-2 conv
      stride 1, dilated ×2, pads (2, 1)   the SAME stride-2 transposed conv
                                          (kernel not flipped)
    conv_dw(x, dy; same geometry)         csrc/conv.cu::conv_dw

``conv3x3_s2`` and ``convt3x3_s2`` call one ``torch.autograd.Function``
(the reference's ``_conv_im2col`` custom VJP) whose backward is the kernels
again: dx is ``conv_fwd`` on the flipped, channel-transposed weight with the
mapped stride and pads, computed only when the input asks for a gradient
(conv1's input is the data, so its dx is never launched), and dw is
``conv_dw``. Bias add and activation stay in torch. ``encode_conv_fused`` /
``decode_conv_fused`` are the tower (models/conv.make_conv_tower) over these
ops; models/vae.py routes ``encoder="conv_pallas"`` here whatever
``use_pallas`` says, as the reference does.

Dispatch is by the device of the input, and only by it: a CPU tensor goes to
the plain twins in this module (the CPU tests' path); a CUDA tensor launches
the kernel or raises.
"""

from __future__ import annotations

import torch

from vae_assoc_tpu_torch.kernels import _build, _launches
from vae_assoc_tpu_torch.kernels import mlp as kmlp
from vae_assoc_tpu_torch.models import conv as conv_mod
from vae_assoc_tpu_torch.models import networks

K = conv_mod.K
DW_SLICE = 16
DW_MIN_ROWS = 512
MAX_COUT = 64
"""Output channels the kernels take (``kMaxCout`` in csrc/conv.cu)."""

# The input gradient of each layer geometry: (stride, dilate, pads) of the
# forward → those of the conv that computes dx from dy (the reference's
# _conv_vjp_bwd). s2 conv: dx(i) = Σ_k wf[k]·dyd(i − 2 + k), a stride-1
# conv of the ×2-dilated dy padded (2, 2), clipped to the input size.
# Transposed conv: dx(i) = Σ_k wf[k]·dy(2i + k), a stride-2 conv padded (0, 1).
DX_GEOMETRY = {(2, False, (0, 1)): (1, True, (2, 2)), (1, True, (2, 1)): (2, False, (0, 1))}


def _taps(xp, stride, out_hw):
    """(tap index, [B, out_hw, out_hw, c] slice of x̃) for the 9 kernel taps."""
    span = stride * (out_hw - 1) + 1
    if xp.shape[1] < span + K - 1 or xp.shape[2] < span + K - 1:
        raise ValueError(f"a padded input of {tuple(xp.shape[1:3])} cannot give "
                         f"{out_hw} outputs at stride {stride}")
    for ky in range(K):
        for kx in range(K):
            yield ky * K + kx, xp[:, ky:ky + span:stride, kx:kx + span:stride]


def conv_im2col_plain(x, w2d, stride, dilate, pads, out_hw, compute_dtype="float32"):
    """Plain twin of the conv kernel: x [B, h, w, cin] (NHWC) and w2d
    [9·cin, cout] → [B, out_hw, out_hw, cout] fp32, the reference's
    _fwd_kernel: models/conv.conv_general on the HWIO view of w2d."""
    cin, cout = x.shape[3], w2d.shape[1]
    return conv_mod.conv_general(x, w2d.float().reshape(K, K, cin, cout), stride, dilate,
                                 pads, out_hw, compute_dtype)


def conv_dw_plain(x, dy, stride, dilate, pads, out_hw, compute_dtype="float32"):
    """Plain twin of the weight-gradient kernel: [9·cin, cout], tap by tap
    Σ over every output pixel of tap[pixel, cin]ᵀ · dy[pixel, cout] (the
    reference's _dw_kernel)."""
    cd = networks.dtype_name(compute_dtype)
    cin, cout = x.shape[3], dy.shape[3]
    d = networks.round_operand(dy.float(), cd).reshape(-1, cout)
    parts = [tap.reshape(-1, cin).T @ d
             for _, tap in _taps(conv_mod.pad_input(x, dilate, pads, cd), stride, out_hw)]
    return torch.cat(parts)


def flip_w2d(w2d, cin: int, cout: int):
    """[9·cin, cout] → the spatially flipped, channel-transposed
    [9·cout, cin]: the weight of the conv that computes dx."""
    w = w2d.reshape(K, K, cin, cout).flip(0, 1).transpose(2, 3)
    return w.reshape(K * K * cout, cin).contiguous()


def _chan_threads(cout: int) -> int:
    """Threads across the channels (csrc/conv.cu::chan_threads)."""
    rc = min(4, cout)
    need = -(-cout // rc)
    ct = 1
    while ct < need:
        ct *= 2
    return ct


def dw_plan(rows: int, k: int, cout: int, n_sm: int):
    """(rows_per_chunk, chunks) for conv_dw over ``rows`` output pixels: the
    kernel has one block per tile of 4·(256 / channel threads) patch
    columns; when those cannot fill two waves of ``n_sm`` blocks, the pixels
    split into chunks of at least ``DW_MIN_ROWS`` (a multiple of the 16-row
    slice) whose partials a second launch adds in order."""
    tk = 4 * (256 // _chan_threads(cout))
    tiles = -(-k // tk)
    chunks = max(1, min(-(-2 * n_sm // tiles), rows // DW_MIN_ROWS))
    per = -(-rows // chunks)
    per = -(-per // DW_SLICE) * DW_SLICE
    return per, -(-rows // per)


def _geometry(x, cout, stride, dilate, pads, out_hw):
    if x.ndim != 4:
        raise ValueError(f"expected an NHWC [batch, h, w, c] input, got {tuple(x.shape)}")
    if stride not in (1, 2) or not 1 <= cout <= MAX_COUT:
        raise ValueError(f"the conv kernels take stride 1 or 2 and 1..{MAX_COUT} "
                         f"output channels, got stride {stride}, cout {cout}")
    b, h, w, cin = x.shape
    lo, hi = pads
    return (b, h, w, cin, cout, stride, int(bool(dilate)), lo, hi, out_hw)


def _launch_fwd(x, w2d, stride, dilate, pads, out_hw, cd):
    dev = x.device
    x = x.detach().float().contiguous()
    w2d = w2d.detach().float().contiguous()
    cin, cout = x.shape[-1], w2d.shape[1]
    kmlp._check_f32(w2d, dev, "w2d", (K * K * cin, cout))
    geom = _geometry(x, cout, stride, dilate, pads, out_hw)
    y = torch.empty(x.shape[0], out_hw, out_hw, cout, dtype=torch.float32, device=dev)
    if x.shape[0] == 0:
        return y
    lib = _build.load()
    b, h, w, cin, cout, s, dil, lo, hi, ohw = geom
    with torch.cuda.device(dev):
        err = lib.vae_conv_fwd(x.data_ptr(), b, h, w, cin, w2d.data_ptr(), cout, s, dil,
                               lo, hi, ohw, y.data_ptr(), int(cd == "bfloat16"),
                               kmlp._stream(x))
    _build.check(lib, err, "conv kernel launch")
    _launches.count(_launches.SERVING, "conv_fwd")
    return y


def _launch_dw(x, dy, stride, dilate, pads, out_hw, cd):
    dev = x.device
    x = x.detach().float().contiguous()
    dy = dy.detach().float().contiguous()
    b, cin, cout = x.shape[0], x.shape[-1], dy.shape[-1]
    kmlp._check_f32(dy, dev, "dy", (b, out_hw, out_hw, cout))
    geom = _geometry(x, cout, stride, dilate, pads, out_hw)
    dw = torch.empty(K * K * cin, cout, dtype=torch.float32, device=dev)
    if b == 0:
        return dw.zero_()
    lib = _build.load()
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    rows, chunks = dw_plan(b * out_hw * out_hw, K * K * cin, cout, n_sm)
    partial = (torch.empty(chunks * dw.numel(), dtype=torch.float32, device=dev)
               if chunks > 1 else None)
    with torch.cuda.device(dev):
        err = lib.vae_conv_dw(x.data_ptr(), *geom[:4], dy.data_ptr(), *geom[4:], rows,
                              chunks, dw.data_ptr(),
                              partial.data_ptr() if partial is not None else None,
                              int(cd == "bfloat16"), kmlp._stream(x))
    _build.check(lib, err, "conv weight-gradient kernel launch")
    _launches.count(_launches.TRAINING, "conv_dw")
    return dw


def conv_fwd(x, w2d, stride, dilate, pads, out_hw, *, compute_dtype="float32"):
    """The conv kernel on a CUDA tensor, its twin on the CPU: x [B, h, w,
    cin] NHWC, w2d [9·cin, cout] → [B, out_hw, out_hw, cout] fp32."""
    cd = networks.dtype_name(compute_dtype)
    if x.device.type == "cpu":
        return conv_im2col_plain(x, w2d, stride, dilate, pads, out_hw, cd)
    if x.device.type != "cuda":
        raise ValueError(f"the conv kernel runs on CUDA, got {x.device}")
    return _launch_fwd(x, w2d, stride, dilate, pads, out_hw, cd)


def conv_dw(x, dy, stride, dilate, pads, out_hw, *, compute_dtype="float32"):
    """The weight-gradient kernel on a CUDA tensor, its twin on the CPU:
    [9·cin, cout], deterministic (a fixed order of partial sums)."""
    cd = networks.dtype_name(compute_dtype)
    if x.device.type == "cpu":
        return conv_dw_plain(x, dy, stride, dilate, pads, out_hw, cd)
    if x.device.type != "cuda":
        raise ValueError(f"the conv weight-gradient kernel runs on CUDA, got {x.device}")
    return _launch_dw(x, dy, stride, dilate, pads, out_hw, cd)


def conv_dx(dy, w2d, cin: int, stride, dilate, pads, in_hw: int, *, compute_dtype="float32"):
    """dx [B, in_hw, in_hw, cin] of the layer (stride, dilate, pads) for its
    output gradient dy: ``conv_fwd`` with the flipped weight and the mapped
    geometry."""
    geom = DX_GEOMETRY.get((stride, bool(dilate), tuple(pads)))
    if geom is None:
        raise NotImplementedError(
            f"no input gradient for stride {stride}, dilate {dilate}, pads {pads}")
    return conv_fwd(dy, flip_w2d(w2d, cin, dy.shape[-1]), *geom, in_hw,
                    compute_dtype=compute_dtype)


class _Conv(torch.autograd.Function):
    """The reference's ``_conv_im2col`` custom VJP. Inputs: stride, dilate,
    pads, out_hw, compute dtype, x, w2d."""

    @staticmethod
    def forward(ctx, stride, dilate, pads, out_hw, cd, x, w2d):
        ctx.geom = (stride, dilate, pads, out_hw, cd)
        ctx.save_for_backward(x, w2d)
        return conv_fwd(x, w2d, stride, dilate, pads, out_hw, compute_dtype=cd)

    @staticmethod
    def backward(ctx, dy):
        x, w2d = ctx.saved_tensors
        stride, dilate, pads, out_hw, cd = ctx.geom
        dy = dy.contiguous()
        dx = dw = None
        if ctx.needs_input_grad[5]:
            dx = conv_dx(dy, w2d, x.shape[-1], stride, dilate, pads, x.shape[1],
                         compute_dtype=cd)
        if ctx.needs_input_grad[6]:
            dw = conv_dw(x, dy, stride, dilate, pads, out_hw, compute_dtype=cd)
        return None, None, None, None, None, dx, dw


def _layer(x, w_hwio, b, stride, dilate, pads, out_hw, compute_dtype):
    cin, cout = w_hwio.shape[2], w_hwio.shape[3]
    w2d = w_hwio.reshape(K * K * cin, cout)
    y = _Conv.apply(stride, dilate, pads, out_hw, networks.dtype_name(compute_dtype),
                    x, w2d)
    return y + b


def conv3x3_s2(x, w_hwio, b, *, compute_dtype="float32"):
    """SAME 3×3 stride-2 conv on the kernels; matches models/conv.conv3x3_s2.
    Even spatial sizes only: for an odd size ``lax``'s SAME gives ceil(h/2)
    rows where this formulation floors, so it raises instead."""
    if x.shape[1] % 2 or x.shape[2] % 2:
        raise ValueError(f"conv3x3_s2 requires even spatial dims, got {tuple(x.shape[1:3])}")
    return _layer(x, w_hwio, b, 2, False, (0, 1), x.shape[1] // 2, compute_dtype)


def convt3x3_s2(x, w_hwio, b, *, compute_dtype="float32"):
    """SAME 3×3 stride-2 transposed conv on the kernels; matches
    models/conv.convt3x3_s2."""
    return _layer(x, w_hwio, b, 1, True, (2, 1), 2 * x.shape[1], compute_dtype)


encode_conv_fused, decode_conv_fused = conv_mod.make_conv_tower(conv3x3_s2, convt3x3_s2)
