"""MLP recognition/generator towers as torch modules, and their plain math.

Counterpart of vae_assoc_tpu/models/networks.py. A softplus MLP recognition
net produces (z_mean, z_logvar) through two linear heads; a mirrored
generator net produces the decoder output (sigmoid logits for Bernoulli
images, linear for trajectories). Depth comes from the arch dict's
contiguous ``n_hidden_{recog,gener}_k`` keys. Weights are Xavier-uniform,
biases zero.

Parameters keep the reference layout: each linear layer holds ``w`` [in, out]
and ``b`` [out] (not nn.Linear's [out, in]), and the module tree mirrors the
JAX param tree, so a state_dict key reads ``recog.h1.w`` where the JAX path
reads ``["recog"]["h1"]["w"]`` and a JAX tree loads with no transposes
(convert.py).

Precision policy, set once here for the whole package:

- fp32 weights, fp32 accumulation, fp32 outputs.
- ``compute_dtype="float32"``: true fp32 multiplies. TF32 is switched off
  for matmuls and cuDNN at import, since PyTorch lets cuDNN use TF32 by
  default and TF32 keeps about three decimal digits.
- cuDNN runs deterministic algorithms (``torch.backends.cudnn.deterministic``,
  set at import): some of its convolution backward algorithms add with
  atomics, so the plain conv tower's gradients would change in the last
  bits from run to run. ``benchmark`` stays off, so the choice does not
  follow timings either.
- ``compute_dtype="bfloat16"``: each matmul operand is rounded to bf16 and
  the product accumulates in fp32, as the JAX kernels' ``_mm`` does with
  ``preferred_element_type=float32``. ``torch.matmul`` on bf16 tensors
  would return a bf16 result, so the operands are rounded and then held as
  fp32; the product of two bf16 values is exact in fp32.
"""

from __future__ import annotations

import math

import torch
from torch import nn

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.backends.cudnn.deterministic = True

COMPUTE_DTYPES = ("float32", "bfloat16")


def dtype_name(dtype) -> str:
    """Normalize a compute dtype (a name or a torch dtype) to its name."""
    if isinstance(dtype, torch.dtype):
        dtype = str(dtype).removeprefix("torch.")
    if dtype not in COMPUTE_DTYPES:
        raise ValueError(
            f"compute dtype must be one of {COMPUTE_DTYPES}, got {dtype!r}"
        )
    return dtype


def cuda_or_raise(device, what: str) -> torch.device:
    """``device`` as a torch.device; a CUDA device without a GPU raises,
    since nothing falls back to the CPU unless the caller names it."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"{what}(device='cuda') but torch finds no CUDA device; "
            "pass device='cpu' to run on the CPU"
        )
    return device


def round_operand(t: torch.Tensor, compute_dtype: str) -> torch.Tensor:
    """A matmul operand under the policy: fp32 as is, or rounded to bf16
    and held as fp32."""
    if compute_dtype == "float32":
        return t
    return t.bfloat16().float()


class _Softplus(torch.autograd.Function):
    """Autograd of max(a, 0) + log1p(e^{−|a|}) would take clamp's and abs's
    derivatives at a = 0 (1 and 0) and give 1 there; softplus'(0) is
    σ(0) = ½, as the reference's jax.nn.softplus gives. A conv layer over
    the zero background of an image at zero bias meets a = 0 exactly."""

    generate_vmap_rule = True

    @staticmethod
    def forward(a):
        return torch.clamp_min(a, 0.0) + torch.log1p(torch.exp(-torch.abs(a)))

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(inputs[0])

    @staticmethod
    def backward(ctx, g):
        (a,) = ctx.saved_tensors
        return g * torch.sigmoid(a)


def softplus(a: torch.Tensor) -> torch.Tensor:
    """log(1 + e^a) in the overflow-safe form the kernels use; its gradient
    is σ(a)."""
    return _Softplus.apply(a)


def xavier_uniform(n_in: int, n_out: int, *, generator: torch.Generator,
                   device) -> torch.Tensor:
    """Glorot-uniform U(−a, a), a = sqrt(6/(n_in+n_out)).

    Drawn on the CPU from ``generator`` and then moved, so one seed gives
    the same weights on every device."""
    a = math.sqrt(6.0 / (n_in + n_out))
    w = torch.empty(n_in, n_out).uniform_(-a, a, generator=generator)
    return w.to(device)


class Linear(nn.Module):
    """x @ w + b with ``w`` [in, out] and ``b`` [out]. Without a generator
    the weights are zeros, to be filled by ``load_state_dict``."""

    def __init__(self, n_in: int, n_out: int, *, device,
                 generator: torch.Generator | None = None):
        super().__init__()
        if generator is None:
            w = torch.zeros(n_in, n_out, device=device)
        else:
            w = xavier_uniform(n_in, n_out, generator=generator, device=device)
        self.w = nn.Parameter(w)
        self.b = nn.Parameter(torch.zeros(n_out, device=device))


class MLPVAE(nn.Module):
    """One modality's towers: ``recog`` {h1..hL, out_mean, out_logvar} and
    ``gener`` {h1..hL, out}.

    ``n_cond > 0`` widens the first recognition layer to n_input + n_cond
    and the first generator layer to n_z + n_cond; the condition is
    concatenated at the call boundary (models/vae.py)."""

    def __init__(self, arch, *, device, n_cond: int = 0,
                 generator: torch.Generator | None = None):
        super().__init__()
        from vae_assoc_tpu_torch.configs import gener_widths, recog_widths

        def lin(n_in, n_out):
            return Linear(n_in, n_out, device=device, generator=generator)

        n_in, n_z = arch["n_input"], arch["n_z"]
        recog, prev = {}, n_in + n_cond
        for i, width in enumerate(recog_widths(arch), 1):
            recog[f"h{i}"] = lin(prev, width)
            prev = width
        recog["out_mean"] = lin(prev, n_z)
        recog["out_logvar"] = lin(prev, n_z)
        gener, prev = {}, n_z + n_cond
        for i, width in enumerate(gener_widths(arch), 1):
            gener[f"h{i}"] = lin(prev, width)
            prev = width
        gener["out"] = lin(prev, n_in)
        self.recog = nn.ModuleDict(recog)
        self.gener = nn.ModuleDict(gener)


def init_mlp_vae_params(generator: torch.Generator, arch, *, device,
                        n_cond: int = 0) -> MLPVAE:
    """One modality's recognition + generator stacks, Xavier-initialized
    fp32 (the kernels take fp32 weights only)."""
    return MLPVAE(arch, device=device, n_cond=n_cond, generator=generator)


def hidden_layers(net: nn.ModuleDict) -> list:
    """The ``h1..hL`` layers of one net, in numeric order (h10 after h9)."""
    out = []
    i = 1
    while f"h{i}" in net:
        out.append(net[f"h{i}"])
        i += 1
    return out


def linear(layer: Linear, x: torch.Tensor, compute_dtype: str) -> torch.Tensor:
    """x @ w + b under the precision policy; output fp32."""
    a = round_operand(x.float(), compute_dtype)
    return a @ round_operand(layer.w, compute_dtype) + layer.b


def encode_mlp(params: MLPVAE, x: torch.Tensor, *, compute_dtype="float32",
               transfer=softplus):
    """Recognition net: x → (z_mean, z_logvar), both fp32 [batch, n_z]."""
    cd = dtype_name(compute_dtype)
    r = params.recog
    h = x
    for layer in hidden_layers(r):
        h = transfer(linear(layer, h, cd))
    return linear(r["out_mean"], h, cd), linear(r["out_logvar"], h, cd)


def decode_mlp(params: MLPVAE, z: torch.Tensor, *, compute_dtype="float32",
               transfer=softplus):
    """Generator net: z → decoder output before the output activation,
    fp32 [batch, n_input] (sigmoid logits for Bernoulli modalities)."""
    cd = dtype_name(compute_dtype)
    g = params.gener
    h = z
    for layer in hidden_layers(g):
        h = transfer(linear(layer, h, cd))
    return linear(g["out"], h, cd)
