"""Conv image tower: a strided-conv recognition net and a mirrored
transposed-conv generator net (counterpart of vae_assoc_tpu/models/conv.py).

    encode: [B,28,28,1] ─conv3×3,s2→ [B,14,14,C1] ─conv3×3,s2→ [B,7,7,C2]
            ─flatten→ dense(n_hidden_recog_2) ─heads→ (μ, logσ²)
    decode: z ─dense(n_hidden_gener_1)─ dense(7·7·C2) ─reshape→ [B,7,7,C2]
            ─convT3×3,s2→ [B,14,14,C1] ─convT3×3,s2→ [B,28,28,1] → logits

Inputs and outputs are flat [B, 784] rows, as the MLP tower's, so the joint
model, the losses and the cross-modal verbs do not depend on the tower.

Layouts are the reference's at every public function: activations NHWC,
kernels HWIO ([3, 3, cin, cout]), and the dense layers flatten in (h, w, c)
order. A ``ConvVAE``'s state_dict keys are the JAX tree paths
(``recog.conv1.w``), so ``convert.from_jax_numpy`` loads a config-4 tree
with no transposes. Only the plain layer ops below permute to NCHW, to call
``F.conv2d``.

The two layer ops are the reference's ``lax`` convolutions, spelled out:

- SAME padding of a stride-2 conv on an even input is (0, 1), not PyTorch's
  symmetric (1, 1), so the input is padded explicitly;
- ``lax.conv_transpose`` does not flip the kernel: it is the input dilated
  ×2 with zeros, padded (2, 1), and correlated with the HWIO kernel as it is
  (``F.conv_transpose2d`` would flip it and swap its channels).

Precision follows models/networks.py, which switches TF32 off for cuDNN
when imported (before any conv here runs): fp32 operands as they are, or
under bf16 both operands of each product rounded to bf16 and the sum kept
in fp32.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from vae_assoc_tpu_torch.models import networks

IMG_SIZE = 28
C1 = 32
C2 = 64
MID = IMG_SIZE // 2  # 14
SMALL = IMG_SIZE // 4  # 7
FLAT = SMALL * SMALL * C2  # 3136
K = 3  # kernel size of every conv of the tower


class Conv(nn.Module):
    """A 3×3 conv's ``w`` [3, 3, cin, cout] (HWIO) and ``b`` [cout].

    Glorot-uniform with fan_in = 9·cin and fan_out = 9·cout, drawn on the
    CPU from ``generator`` (as networks.xavier_uniform); zeros without one."""

    def __init__(self, cin: int, cout: int, *, device,
                 generator: torch.Generator | None = None):
        super().__init__()
        shape = (K, K, cin, cout)
        if generator is None:
            w = torch.zeros(shape, device=device)
        else:
            a = math.sqrt(6.0 / (K * K * (cin + cout)))
            w = torch.empty(shape).uniform_(-a, a, generator=generator).to(device)
        self.w = nn.Parameter(w)
        self.b = nn.Parameter(torch.zeros(cout, device=device))


class ConvVAE(nn.Module):
    """One modality's conv towers: ``recog`` {conv1, conv2, dense, out_mean,
    out_logvar} and ``gener`` {dense1, dense2, convt1, convt2}, the tree of
    the reference's ``init_conv_vae_params``."""

    def __init__(self, arch, *, device, generator: torch.Generator | None = None):
        super().__init__()
        if arch["n_input"] != IMG_SIZE * IMG_SIZE:
            raise ValueError(f"conv tower needs n_input={IMG_SIZE * IMG_SIZE}")
        n_z, hr, hg = arch["n_z"], arch["n_hidden_recog_2"], arch["n_hidden_gener_1"]

        def lin(n_in, n_out):
            return networks.Linear(n_in, n_out, device=device, generator=generator)

        def conv(cin, cout):
            return Conv(cin, cout, device=device, generator=generator)

        self.recog = nn.ModuleDict({
            "conv1": conv(1, C1), "conv2": conv(C1, C2), "dense": lin(FLAT, hr),
            "out_mean": lin(hr, n_z), "out_logvar": lin(hr, n_z),
        })
        self.gener = nn.ModuleDict({
            "dense1": lin(n_z, hg), "dense2": lin(hg, FLAT),
            "convt1": conv(C2, C1), "convt2": conv(C1, 1),
        })


def init_conv_vae_params(generator: torch.Generator | None, arch, *, device,
                         n_cond: int = 0) -> ConvVAE:
    """The conv towers of one modality (zeros without a generator). Conv
    towers take no condition (configs.ModalityConfig refuses one)."""
    if n_cond:
        raise ValueError("conv towers take no condition (n_cond must be 0)")
    return ConvVAE(arch, device=device, generator=generator)


def pad_input(x, dilate: bool, pads, compute_dtype="float32"):
    """x̃: x [B, h, w, c] rounded under ``compute_dtype``, dilated ×2 with
    zeros when ``dilate``, padded ``pads`` = (lo, hi) on both spatial axes."""
    x = networks.round_operand(x.float(), networks.dtype_name(compute_dtype))
    lo, hi = pads
    if dilate:
        # A zero after every pixel, by padding a [B, h, 1, w, 1, c] view: out
        # of place, so torch.func.vmap (the sweep, train/sweep.py) batches
        # it. The zeros after the last row and column count toward ``hi``.
        b, h, w, c = x.shape
        x = F.pad(x.reshape(b, h, 1, w, 1, c), (0, 0, 0, 1, 0, 0, 0, 1))
        x = x.reshape(b, 2 * h, 2 * w, c)
        hi -= 1
    return F.pad(x, (0, 0, lo, hi, lo, hi))


def conv_general(x, w_hwio, stride: int, dilate: bool, pads, out_hw: int,
                 compute_dtype="float32"):
    """y[o] = Σ_k w[k]·x̃[stride·o + k] over the 3×3 taps, NHWC in and out,
    x̃ from :func:`pad_input`; the first ``out_hw`` rows and columns are
    kept. ``F.conv2d`` does the sum (no bias)."""
    cd = networks.dtype_name(compute_dtype)
    x = pad_input(x, dilate, pads, cd).permute(0, 3, 1, 2)
    w = networks.round_operand(w_hwio, cd).permute(3, 2, 0, 1)
    y = F.conv2d(x, w, stride=stride)
    if y.shape[2] < out_hw:
        raise ValueError(f"the conv gives {y.shape[2]} rows, fewer than {out_hw}")
    return y[:, :, :out_hw, :out_hw].permute(0, 2, 3, 1)


def conv3x3_s2(x, w_hwio, b, *, compute_dtype="float32"):
    """SAME 3×3 stride-2 conv (``lax.conv_general_dilated``), even inputs:
    pads (0, 1), [B, h, w, cin] → [B, h/2, w/2, cout]."""
    return conv_general(x, w_hwio, 2, False, (0, 1), x.shape[1] // 2, compute_dtype) + b


def convt3x3_s2(x, w_hwio, b, *, compute_dtype="float32"):
    """SAME 3×3 stride-2 transposed conv (``lax.conv_transpose``, kernel not
    flipped): the ×2-dilated input padded (2, 1), [B, h, w, cin] →
    [B, 2h, 2w, cout]."""
    return conv_general(x, w_hwio, 1, True, (2, 1), 2 * x.shape[1], compute_dtype) + b


def make_conv_tower(conv_op, convt_op):
    """(encode, decode) of the conv tower over the given layer ops: the
    wiring (layer order, activations, dense heads, reshapes) exists once,
    for the plain ops here and the kernel ops of kernels/conv.py."""

    def encode(params, x, *, compute_dtype="float32", transfer=networks.softplus):
        """[B, 784] → (z_mean, z_logvar), both fp32 [B, n_z]."""
        cd = networks.dtype_name(compute_dtype)
        r = params.recog
        img = x.float().reshape(-1, IMG_SIZE, IMG_SIZE, 1)
        h = transfer(conv_op(img, r["conv1"].w, r["conv1"].b, compute_dtype=cd))
        h = transfer(conv_op(h, r["conv2"].w, r["conv2"].b, compute_dtype=cd))
        h = transfer(networks.linear(r["dense"], h.reshape(h.shape[0], FLAT), cd))
        return (networks.linear(r["out_mean"], h, cd),
                networks.linear(r["out_logvar"], h, cd))

    def decode(params, z, *, compute_dtype="float32", transfer=networks.softplus):
        """z [B, n_z] → decoder logits [B, 784] (sigmoid → pixel means)."""
        cd = networks.dtype_name(compute_dtype)
        g = params.gener
        h = transfer(networks.linear(g["dense1"], z, cd))
        h = transfer(networks.linear(g["dense2"], h, cd))
        h = h.reshape(-1, SMALL, SMALL, C2)
        h = transfer(convt_op(h, g["convt1"].w, g["convt1"].b, compute_dtype=cd))
        h = convt_op(h, g["convt2"].w, g["convt2"].b, compute_dtype=cd)
        return h.reshape(h.shape[0], IMG_SIZE * IMG_SIZE)

    return encode, decode


encode_conv, decode_conv = make_conv_tower(conv3x3_s2, convt3x3_s2)
