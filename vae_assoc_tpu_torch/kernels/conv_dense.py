"""The edge convs of the conv tower as one dense product each (counterpart
of vae_assoc_tpu/kernels/conv_dense.py).

Config 4's first conv reads one input channel (cin = 1) and its last
transposed conv writes one (cout = 1). The JAX package's alternative
formulation for those two layers folds the whole 2-D geometry into one
dense matrix and runs the layer as a single product:

    conv1:  [B, 784]  @ M[784, 14·14·32 = 6272]
    convt2: [B, 6272] @ M[6272, 784]

M[(r·w + c)·cin + ci, (o·ow + p)·cout + co] = w[dy, dx, ci, co] wherever
tap (dy, dx) links input pixel (r, c) to output pixel (o, p): a constant
0/1 selector per tap (``_sel_s2``, ``_sel_t2``) contracted with the HWIO
kernel. Each (input, output) pair has at most one tap, so M holds copies
of the weights. The gradients come from autograd through the product and
the contraction.

This is plain torch, as the reference is plain XLA: it has no
``pallas_call`` and so no CUDA kernel. The JAX package reaches it only
behind ``kernels/conv_banded.py``'s ``DENSE_EDGES`` switch, which is off.
The port has no banded path (``kernels/conv.py`` serves every layer of the
tower, edge convs included), so no path of the port calls these functions
and they add no switch; they are kept as the reference's alternative
formulation, held against the JAX package's and the port's plain convs by
the tests.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from vae_assoc_tpu_torch.models import networks

_K = 3


@functools.lru_cache(maxsize=16)
def _sel_s2(h: int, w: int) -> np.ndarray:
    """0/1 selector [9, h·w, oh·ow] of a SAME stride-2 conv: tap (dy, dx)
    reads input (2o + dy, 2p + dx) for output (o, p), the reference's
    border rule (pads (0, 1))."""
    oh, ow = h // 2, w // 2
    s = np.zeros((_K * _K, h * w, oh * ow), np.float32)
    for dy in range(_K):
        for dx in range(_K):
            for o in range(oh):
                r = 2 * o + dy
                if r >= h:
                    continue
                for p in range(ow):
                    c = 2 * p + dx
                    if c < w:
                        s[dy * _K + dx, r * w + c, o * ow + p] = 1.0
    return s


@functools.lru_cache(maxsize=16)
def _sel_t2(h: int, w: int) -> np.ndarray:
    """0/1 selector [9, h·w, 2h·2w] of a SAME stride-2 transposed conv:
    output (R, P) takes tap (dy, dx) from input ((R + dy)/2 − 1,
    (P + dx)/2 − 1) where both are whole, as ``lax.conv_transpose``."""
    oh, ow = 2 * h, 2 * w
    s = np.zeros((_K * _K, h * w, oh * ow), np.float32)
    for dy in range(_K):
        for dx in range(_K):
            for R in range(oh):
                if (R + dy) % 2:
                    continue
                r = (R + dy) // 2 - 1
                if not 0 <= r < h:
                    continue
                for P in range(ow):
                    if (P + dx) % 2:
                        continue
                    c = (P + dx) // 2 - 1
                    if 0 <= c < w:
                        s[dy * _K + dx, r * w + c, R * ow + P] = 1.0
    return s


def _dense_conv(x, w_hwio, b, sel: np.ndarray, oh: int, ow: int, compute_dtype):
    """The layer as one product: x [B, h, w, cin] → [B, oh, ow, cout]."""
    cd = networks.dtype_name(compute_dtype)
    bsz, h, w, cin = x.shape
    cout = w_hwio.shape[3]
    w9 = w_hwio.reshape(_K * _K, cin, cout)
    sel_t = torch.from_numpy(sel).to(w_hwio.device)
    m = torch.einsum("gIO,gio->IiOo", sel_t, w9).reshape(h * w * cin, oh * ow * cout)
    a = networks.round_operand(x.float().reshape(bsz, h * w * cin), cd)
    y = a @ networks.round_operand(m, cd)
    return y.reshape(bsz, oh, ow, cout) + b


def conv3x3_s2_dense(x, w_hwio, b, *, compute_dtype="float32"):
    """SAME 3×3 stride-2 conv (``models.conv.conv3x3_s2``) as one dense
    product; even inputs only, as the reference's."""
    _, h, w, _ = x.shape
    if h % 2 or w % 2:
        raise ValueError(f"conv3x3_s2_dense requires even dims, got {(h, w)}")
    return _dense_conv(x, w_hwio, b, _sel_s2(h, w), h // 2, w // 2, compute_dtype)


def convt3x3_s2_dense(x, w_hwio, b, *, compute_dtype="float32"):
    """SAME 3×3 stride-2 transposed conv (``models.conv.convt3x3_s2``) as
    one dense product."""
    _, h, w, _ = x.shape
    return _dense_conv(x, w_hwio, b, _sel_t2(h, w), 2 * h, 2 * w, compute_dtype)
