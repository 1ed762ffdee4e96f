"""The plain reference of the joint VAE: forward, loss, gradients and Adam.

Plain PyTorch, float32 with TF32 off, written from the model's equations:

    cost = Σ_k mean_batch[recon_k + KL_k] + λ · mean_batch ‖μ_0 − μ_1‖²

with a softplus MLP tower (784-500-500-20 images, 200-500-500-20
trajectories) or the conv image tower (conv 3×3 stride 2, 1→32→64, dense
3136→500, heads to 20, and its mirror with transposed convs), Bernoulli
cross-entropy on logits for images, squared error for trajectories, and
z = μ + e^{½logσ²}·ε. Weights are a dict keyed by the program's parameter
names (``modalities.<k>.recog.h1.w``), linear weights [in, out], conv
weights HWIO, activations of the conv tower in the (h, w, c) flattening.

Two things the program derives from the seed are worked out again here,
from frozen copies of their definitions: ε (Philox4x32-10 keyed by the
modality seed, counter (row, column), Box–Muller on two 24-bit words) and
the epoch permutation (``torch.randperm`` from a generator seeded by the
SplitMix64 fold of the seed and the step).

``precision`` names the arithmetic of every product: "fp32", or the
control's lower precisions, "tf32" (operands rounded to a 10-bit mantissa,
as TF32 tensor cores take them) and "fp8" (operands scaled per tensor into
float8 e4m3 and back), each summed in float32; and "bf16" (operands
rounded to bfloat16), the reference of the bf16 cells. In the backward a
product's two products take its cotangent and its other operand in the
same precision.

This module imports torch and numpy only.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F

MASK32 = 0xFFFFFFFF
MASK64 = (1 << 64) - 1
PHILOX_M = (0xD2511F53, 0xCD9E8D57)
PHILOX_W = (0x9E3779B9, 0xBB67AE85)
PERM_SALT = 0x5EED
IMG = 28
PRECISIONS = ("fp32", "tf32", "fp8", "bf16")


# -- the seed's derived streams -----------------------------------------------


def fold_in(seed: int, data: int) -> int:
    """SplitMix64's finalizer over seed ^ (data + 1)·golden: a new 64-bit seed."""
    z = (seed ^ ((data + 1) * 0x9E3779B97F4A7C15)) & MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & MASK64
    return z ^ (z >> 31)


def _mulhilo(a: int, b: torch.Tensor):
    al, ah = a & 0xFFFF, a >> 16
    bl, bh = b & 0xFFFF, b >> 16
    ll, lh, hl, hh = al * bl, al * bh, ah * bl, ah * bh
    mid = (ll >> 16) + (lh & 0xFFFF) + (hl & 0xFFFF)
    lo = ((mid & 0xFFFF) << 16) | (ll & 0xFFFF)
    hi = (hh + (lh >> 16) + (hl >> 16) + (mid >> 16)) & MASK32
    return hi, lo


def philox_normal(seed: int, rows: int, cols: int, device) -> torch.Tensor:
    """ε [rows, cols]: Philox4x32-10, key (seed low, seed high), counter
    (row, col, 0, 0); u1 = 24 high bits of word 0 + 1e-7, u2 of word 1;
    ε = sqrt(−2 log u1)·cos(2π u2)."""
    seed &= MASK64
    k0, k1 = seed & MASK32, seed >> 32
    r = torch.arange(rows, dtype=torch.int64, device=device)
    c = torch.arange(cols, dtype=torch.int64, device=device)
    c0, c1 = torch.broadcast_tensors(r[:, None], c[None, :])
    c2 = torch.zeros_like(c0)
    c3 = torch.zeros_like(c0)
    for _ in range(10):
        hi0, lo0 = _mulhilo(PHILOX_M[0], c0)
        hi1, lo1 = _mulhilo(PHILOX_M[1], c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0 = (k0 + PHILOX_W[0]) & MASK32
        k1 = (k1 + PHILOX_W[1]) & MASK32
    u1 = (c0 >> 8).to(torch.float32) * (1.0 / (1 << 24)) + 1e-7
    u2 = (c1 >> 8).to(torch.float32) * (1.0 / (1 << 24))
    return torch.sqrt(-2.0 * torch.log(u1)) * torch.cos(6.283185307179586 * u2)


def step_eps(seed: int, step: int, rows: int, n_z: int, n_modalities: int, device) -> list:
    """ε of every modality at optimizer step ``step`` of the stream ``seed``."""
    s = fold_in(seed, step)
    return [philox_normal(fold_in(s, k), rows, n_z, device) for k in range(n_modalities)]


def epoch_perm(seed: int, step: int, n: int, device) -> torch.Tensor:
    """The order in which an epoch that starts at ``step`` visits n rows."""
    g = torch.Generator(device=device)
    g.manual_seed(fold_in(seed ^ PERM_SALT, step) >> 1)
    return torch.randperm(n, generator=g, device=device)


# -- precision ------------------------------------------------------------------


def rnd(t: torch.Tensor, precision: str) -> torch.Tensor:
    """A product's operand as ``precision`` takes it, held in float32."""
    if precision == "fp32":
        return t
    if precision == "tf32":
        bits = t.contiguous().view(torch.int32)
        bits = (bits + (0xFFF + ((bits >> 13) & 1))) & ~0x1FFF  # round to nearest even
        return bits.view(torch.float32)
    if precision == "fp8":
        scale = t.detach().abs().amax().clamp_min(1e-30) / 448.0
        return (t / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale
    if precision == "bf16":
        return t.to(torch.bfloat16).to(torch.float32)
    raise ValueError(f"precision must be one of {PRECISIONS}, got {precision!r}")


class _Operand(torch.autograd.Function):
    """A product's operand as ``precision`` takes it; its gradient passes
    through as it comes."""

    @staticmethod
    def forward(ctx, t, precision):
        return rnd(t, precision)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Cotangent(torch.autograd.Function):
    """A product's result, whose cotangent the backward's two products take
    in ``precision``: with ``_Operand`` on the forward's operands, both
    passes of a product run in the named precision, summed in float32."""

    @staticmethod
    def forward(ctx, y, precision):
        ctx.precision = precision
        return y.view_as(y)

    @staticmethod
    def backward(ctx, g):
        return rnd(g, ctx.precision), None


def operand(t: torch.Tensor, precision: str) -> torch.Tensor:
    return t if precision == "fp32" else _Operand.apply(t, precision)


def product(y: torch.Tensor, precision: str) -> torch.Tensor:
    return y if precision == "fp32" else _Cotangent.apply(y, precision)


@contextlib.contextmanager
def exact_fp32():
    """TF32 off for matmuls and cuDNN, and deterministic cuDNN, inside."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
             torch.backends.cudnn.deterministic)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
         torch.backends.cudnn.deterministic) = saved


# -- parameters -----------------------------------------------------------------


def _widths(arch: dict, net: str) -> list:
    out, k = [], 1
    while f"n_hidden_{net}_{k}" in arch:
        out.append(int(arch[f"n_hidden_{net}_{k}"]))
        k += 1
    return out


def param_spec(model: dict, conv_channels=(32, 64)) -> list:
    """[(name, shape, fan_in, fan_out)] of every parameter; biases have
    fan_in 0. ``model`` is the configuration file's ``model`` entry."""
    spec = []

    def lin(prefix, n_in, n_out):
        spec.append((f"{prefix}.w", (n_in, n_out), n_in, n_out))
        spec.append((f"{prefix}.b", (n_out,), 0, n_out))

    def conv(prefix, cin, cout):
        spec.append((f"{prefix}.w", (3, 3, cin, cout), 9 * cin, 9 * cout))
        spec.append((f"{prefix}.b", (cout,), 0, cout))

    c1, c2 = conv_channels
    flat = (IMG // 4) ** 2 * c2
    for k, m in enumerate(model["modalities"]):
        arch, p = m["arch"], f"modalities.{k}"
        n_in, n_z = int(arch["n_input"]), int(arch["n_z"])
        if m.get("encoder", "mlp") == "mlp":
            prev = n_in
            for i, w in enumerate(_widths(arch, "recog"), 1):
                lin(f"{p}.recog.h{i}", prev, w)
                prev = w
            lin(f"{p}.recog.out_mean", prev, n_z)
            lin(f"{p}.recog.out_logvar", prev, n_z)
            prev = n_z
            for i, w in enumerate(_widths(arch, "gener"), 1):
                lin(f"{p}.gener.h{i}", prev, w)
                prev = w
            lin(f"{p}.gener.out", prev, n_in)
        else:
            hr, hg = int(arch["n_hidden_recog_2"]), int(arch["n_hidden_gener_1"])
            conv(f"{p}.recog.conv1", 1, c1)
            conv(f"{p}.recog.conv2", c1, c2)
            lin(f"{p}.recog.dense", flat, hr)
            lin(f"{p}.recog.out_mean", hr, n_z)
            lin(f"{p}.recog.out_logvar", hr, n_z)
            lin(f"{p}.gener.dense1", n_z, hg)
            lin(f"{p}.gener.dense2", hg, flat)
            conv(f"{p}.gener.convt1", c2, c1)
            conv(f"{p}.gener.convt2", c1, 1)
    return spec


def init_params(spec: list, generator: torch.Generator) -> dict:
    """Glorot-uniform weights and zero biases, from one draw on the
    generator's device."""
    dev = generator.device
    n = sum(math.prod(s) for _, s, fi, _ in spec if fi)
    u = torch.rand(n, generator=generator, device=dev) * 2.0 - 1.0
    out, off = {}, 0
    for name, shape, fan_in, fan_out in spec:
        size = math.prod(shape)
        if fan_in:
            out[name] = (u[off:off + size] * math.sqrt(6.0 / (fan_in + fan_out))).view(shape)
            off += size
        else:
            out[name] = torch.zeros(shape, device=dev)
    return out


# -- forward --------------------------------------------------------------------


def _linear(p, name, x, precision):
    y = product(operand(x, precision) @ operand(p[f"{name}.w"], precision), precision)
    return y + p[f"{name}.b"]


def _conv(p, name, x, precision):
    """SAME 3×3 stride-2 conv, NCHW: pad (0, 1), correlate."""
    w = operand(p[f"{name}.w"], precision).permute(3, 2, 0, 1)
    y = product(F.conv2d(F.pad(operand(x, precision), (0, 1, 0, 1)), w, stride=2), precision)
    return y + p[f"{name}.b"][:, None, None]


def _convt(p, name, x, precision):
    """SAME 3×3 stride-2 transposed conv with the HWIO kernel not flipped
    (the x2-dilated input padded (2, 1) and correlated), NCHW: the
    transposed conv of the flipped kernel, its last row and column cut."""
    w = operand(p[f"{name}.w"], precision).permute(2, 3, 0, 1).flip(2, 3)
    y = product(F.conv_transpose2d(operand(x, precision), w, stride=2), precision)
    h = 2 * x.shape[2]
    return y[:, :, :h, :h] + p[f"{name}.b"][:, None, None]


def encode(p, k, m, x, precision):
    pre, arch = f"modalities.{k}.recog", m["arch"]
    if m.get("encoder", "mlp") == "mlp":
        h = x
        for i in range(1, len(_widths(arch, "recog")) + 1):
            h = F.softplus(_linear(p, f"{pre}.h{i}", h, precision))
    else:
        h = x.reshape(-1, 1, IMG, IMG)
        h = F.softplus(_conv(p, f"{pre}.conv1", h, precision))
        h = F.softplus(_conv(p, f"{pre}.conv2", h, precision))
        h = h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)
        h = F.softplus(_linear(p, f"{pre}.dense", h, precision))
    return _linear(p, f"{pre}.out_mean", h, precision), _linear(p, f"{pre}.out_logvar", h, precision)


def decode(p, k, m, z, precision):
    """The generator's output before its activation (logits or linear)."""
    pre, arch = f"modalities.{k}.gener", m["arch"]
    if m.get("encoder", "mlp") == "mlp":
        h = z
        for i in range(1, len(_widths(arch, "gener")) + 1):
            h = F.softplus(_linear(p, f"{pre}.h{i}", h, precision))
        return _linear(p, f"{pre}.out", h, precision)
    h = F.softplus(_linear(p, f"{pre}.dense1", z, precision))
    h = F.softplus(_linear(p, f"{pre}.dense2", h, precision))
    c2 = p[f"{pre}.convt1.w"].shape[2]
    h = h.reshape(-1, IMG // 4, IMG // 4, c2).permute(0, 3, 1, 2)
    h = F.softplus(_convt(p, f"{pre}.convt1", h, precision))
    h = _convt(p, f"{pre}.convt2", h, precision)
    return h.permute(0, 2, 3, 1).reshape(h.shape[0], IMG * IMG)


def loss(p, model: dict, xs: list, eps: list, precision="fp32", rows=None) -> torch.Tensor:
    """The joint objective of one batch. ``rows``: take the batch means
    over these rows only (how a fault that drops half the batch reads)."""
    total = torch.zeros((), device=xs[0].device)
    mus = []
    for k, (m, x, e) in enumerate(zip(model["modalities"], xs, eps)):
        mu, lv = encode(p, k, m, x, precision)
        z = mu + torch.exp(0.5 * lv) * e
        out = decode(p, k, m, z, precision)
        if m["recon"] == "bernoulli":
            recon = (out.clamp_min(0) - out * x + torch.log1p(torch.exp(-out.abs()))).sum(-1)
        else:
            recon = ((x - out) ** 2).sum(-1)
        kl = -0.5 * (1.0 + lv - mu * mu - torch.exp(lv)).sum(-1)
        if rows is not None:
            recon, kl = recon[rows], kl[rows]
        total = total + recon.mean() + kl.mean()
        mus.append(mu if rows is None else mu[rows])
    if len(mus) > 1 and model["assoc_lambda"]:
        if model.get("assoc_form", "mean_l2") != "mean_l2":
            raise ValueError("the reference implements assoc_form='mean_l2' only")
        assoc = torch.zeros((), device=xs[0].device)
        for i in range(len(mus)):
            for j in range(i + 1, len(mus)):
                assoc = assoc + ((mus[i] - mus[j]) ** 2).sum(-1).mean()
        total = total + float(model["assoc_lambda"]) * assoc
    return total


def cross_generate(p, model: dict, x, src: int, dst: int, precision="fp32"):
    """Encode with modality ``src`` to its latent mean, decode with ``dst``
    (sigmoid on a Bernoulli output)."""
    ms = model["modalities"]
    mu, _ = encode(p, src, ms[src], x, precision)
    out = decode(p, dst, ms[dst], mu, precision)
    return torch.sigmoid(out) if ms[dst]["recon"] == "bernoulli" else out


# -- training -------------------------------------------------------------------


def adam_steps(params: dict, opt: dict, objective, n_steps: int):
    """Adam (b1, b2, eps, lr from ``opt``, no clipping) over ``n_steps``
    steps, step k descending ``objective(p, k)``, a scalar loss of the
    weights ``p`` (a dict of leaves that require grad).

    Returns (losses, first gradient, change after the last step), the
    latter two dicts by parameter name."""
    names = list(params)
    p = {n: params[n].detach().clone().requires_grad_(True) for n in names}
    mu = {n: torch.zeros_like(p[n]) for n in names}
    nu = {n: torch.zeros_like(p[n]) for n in names}
    b1, b2, eps_adam, lr = opt["adam_b1"], opt["adam_b2"], opt["adam_eps"], opt["learning_rate"]
    losses, grad1 = [], None
    with exact_fp32():
        for step in range(n_steps):
            total = objective(p, step)
            grads = torch.autograd.grad(total, [p[n] for n in names])
            losses.append(float(total.detach()))
            if grad1 is None:
                grad1 = {n: g.detach().clone() for n, g in zip(names, grads)}
            with torch.no_grad():
                t = step + 1
                bc1, bc2 = 1.0 - b1 ** t, 1.0 - b2 ** t
                for n, g in zip(names, grads):
                    mu[n].mul_(b1).add_(g, alpha=1.0 - b1)
                    nu[n].mul_(b2).addcmul_(g, g, value=1.0 - b2)
                    p[n].sub_(lr * (mu[n] / bc1) / ((nu[n] / bc2).sqrt() + eps_adam))
    change = {n: (p[n].detach() - params[n]) for n in names}
    return losses, grad1, change


def train_steps(params: dict, model: dict, opt: dict, batches: list, seed: int,
                precision="fp32", half_batch=False, eps_of=None):
    """``adam_steps`` over ``batches``, one list of per-modality rows per
    step, in the order the program takes them; ε drawn at steps 0, 1, ...
    of the stream ``seed``, or ``eps_of(step, rows)`` where given.

    Returns (losses, first gradient, change after the last step), the
    latter two dicts by parameter name."""
    n_z = int(model["modalities"][0]["arch"]["n_z"])

    def objective(p, step):
        xs = batches[step]
        b = xs[0].shape[0]
        eps = (eps_of(step, b) if eps_of is not None
               else step_eps(seed, step, b, n_z, len(xs), xs[0].device))
        rows = slice(0, b // 2) if half_batch else None
        return loss(p, model, xs, eps, precision, rows=rows)

    return adam_steps(params, opt, objective, len(batches))
