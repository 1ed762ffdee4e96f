"""A plain reference of the joint VAE with a Sketch-RNN trajectory tower, for the CPU tests.

Plain PyTorch in float32 with TF32 off, written from D. Ha and D. Eck, *A
Neural Representation of Sketch Drawings* (ICLR 2018, arXiv:1704.03477) and
magenta's ``sketch_rnn`` (``model.py``, ``rnn.py``, ``sketch_rnn_train.py``),
beside a softplus MLP image tower with a Bernoulli loss and the mean-L2
association. It imports neither package: weights are a dict keyed by the
port's parameter names, linear weights [in, out], each LSTM's W split into
``w_x`` (the input's rows) and ``w_h``.

- rows [S_0, …, S_N], S_0 = (0, 0, 1, 0, 0), padded with (0, 0, 0, 0, 1);
  L = the points with p3 = 0;
- cell: [i, j, f, o] = [x; h]·W + b, c' = c·σ(f + 1) + σ(i)·tanh(j),
  h' = tanh(c')·σ(o);
- encoder: forward over S_1..S_L, backward from S_L, no change past L;
  μ, σ̂ from [h_fw; h_bw], z = μ + exp(σ̂/2)·ε;
- decoder: [c_0; h_0] = tanh(W_z z + b), input [S_{i−1}; z], N steps,
  head y = W_y h + b;
- L_R = mean over rows × N of −log(Σ π N + 1e-6)·(1 − p3) + CE(pen);
  KL = −½ mean(1 + σ̂ − μ² − e^σ̂), the term max(KL, tolerance)·w_KL;
- Adam with each gradient clipped by value; lr(s) = (lr − lr_min)·d^s +
  lr_min; w_KL(s) = w − (w − w_start)·d_KL^s;
- greedy decode: the most probable component's mean and pen state, fed
  back; a row ends at its first p3.

portbench/reference/sketch_rnn.py is the benchmark's copy; a test holds the
two to the same loss, bit for bit.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

POINT = 5
EPS = 1e-6
START = (0.0, 0.0, 1.0, 0.0, 0.0)
PAD = (0.0, 0.0, 0.0, 0.0, 1.0)

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def _cell(p, name, x, h, c):
    w = torch.cat([p[f"{name}.w_x"], p[f"{name}.w_h"]], dim=0)
    pre = torch.cat([x, h], dim=1) @ w + p[f"{name}.b"]
    gi, gj, gf, go = pre.chunk(4, dim=1)
    c = c * torch.sigmoid(gf + 1.0) + torch.sigmoid(gi) * torch.tanh(gj)
    return torch.tanh(c) * torch.sigmoid(go), c


def _rnn(p, name, xs, h, c, lens=None):
    out = []
    for t in range(xs.shape[0]):
        h2, c2 = _cell(p, name, xs[t], h, c)
        if lens is not None:
            on = (lens > t)[:, None]
            h2, c2 = torch.where(on, h2, h), torch.where(on, c2, c)
        h, c = h2, c2
        out.append(h)
    return out, h, c


def lengths(points):
    return (points[..., 4] == 0).sum(1)


def reversed_points(points, lens):
    b, n, _ = points.shape
    idx = lens[:, None] - 1 - torch.arange(n, device=points.device)[None, :]
    got = torch.gather(points, 1, idx.clamp_min(0)[..., None].expand(b, n, POINT))
    return torch.where((idx >= 0)[..., None], got, torch.zeros_like(got)).transpose(0, 1)


def encode(p, pre, points):
    lens = lengths(points)
    zeros = points.new_zeros(points.shape[0], p[f"{pre}.enc_fw.w_h"].shape[0])
    _, hf, _ = _rnn(p, f"{pre}.enc_fw", points.transpose(0, 1), zeros, zeros, lens)
    _, hb, _ = _rnn(p, f"{pre}.enc_bw", reversed_points(points, lens), zeros, zeros, lens)
    h = torch.cat([hf, hb], dim=1)
    return h @ p[f"{pre}.mu.w"] + p[f"{pre}.mu.b"], h @ p[f"{pre}.sigma.w"] + p[f"{pre}.sigma.b"]


def initial_state(p, pre, z):
    hd = p[f"{pre}.dec.w_h"].shape[0]
    s = torch.tanh(z @ p[f"{pre}.init.w"] + p[f"{pre}.init.b"])
    return s[:, hd:], s[:, :hd]


def head(p, pre, h):
    return h @ p[f"{pre}.out.w"] + p[f"{pre}.out.b"]


def decode(p, pre, rows, z):
    b, n = rows.shape[0], rows.shape[1] - 1
    h, c = initial_state(p, pre, z)
    xs = torch.cat([rows[:, :-1].transpose(0, 1), z[None].expand(n, b, z.shape[1])], dim=2)
    hs, _, _ = _rnn(p, f"{pre}.dec", xs, h, c)
    return head(p, pre, torch.stack(hs))


def mixture_loss(y, tgt):
    m = (y.shape[-1] - 3) // 6
    pi, mu1, mu2, s1, s2, rho = y[..., 3:].split(m, dim=-1)
    pi, s1, s2, rho = torch.softmax(pi, dim=-1), torch.exp(s1), torch.exp(s2), torch.tanh(rho)
    n1, n2 = tgt[..., 0:1] - mu1, tgt[..., 1:2] - mu2
    s1s2 = s1 * s2
    z = (n1 / s1) ** 2 + (n2 / s2) ** 2 - 2 * (rho * (n1 * n2)) / s1s2
    neg_rho = 1 - rho * rho
    pdf = torch.exp(-z / (2 * neg_rho)) / (2 * math.pi * s1s2 * torch.sqrt(neg_rho))
    offsets = -torch.log((pdf * pi).sum(-1) + EPS) * (1.0 - tgt[..., 4])
    pen = -(tgt[..., 2:5] * torch.log_softmax(y[..., :3], dim=-1)).sum(-1)
    return offsets + pen


def sketch_terms(p, k, rows, eps, tolerance):
    """(μ, L_R, max(KL, tolerance)) of the sketch tower, modality ``k``."""
    pre = f"modalities.{k}"
    points = rows[:, 1:]
    mu, presig = encode(p, pre, points)
    z = mu + torch.exp(0.5 * presig) * eps
    per_row = mixture_loss(decode(p, pre, rows, z), points.transpose(0, 1))
    kl = 1.0 + presig - mu * mu - torch.exp(presig)
    kl = torch.clamp_min(-0.5 * torch.mean(kl), float(tolerance))
    return mu, torch.mean(per_row), kl


def _linear(p, name, x):
    return x @ p[f"{name}.w"] + p[f"{name}.b"]


def image_terms(p, x, eps, depth=2):
    """(μ, Bernoulli recon [B], KL [B]) of the softplus MLP image tower,
    modality 0."""
    h = x
    for i in range(1, depth + 1):
        h = F.softplus(_linear(p, f"modalities.0.recog.h{i}", h))
    mu = _linear(p, "modalities.0.recog.out_mean", h)
    lv = _linear(p, "modalities.0.recog.out_logvar", h)
    h = mu + torch.exp(0.5 * lv) * eps
    for i in range(1, depth + 1):
        h = F.softplus(_linear(p, f"modalities.0.gener.h{i}", h))
    out = _linear(p, "modalities.0.gener.out", h)
    recon = (out.clamp_min(0) - out * x + torch.log1p(torch.exp(-out.abs()))).sum(-1)
    kl = -0.5 * (1.0 + lv - mu * mu - torch.exp(lv)).sum(-1)
    return mu, recon, kl


def loss(p, xs, eps, w_kl, tolerance, lam):
    """The joint objective: image recon + KL, L_R + w_kl·max(KL, tolerance),
    lam·mean ‖μ_img − μ_sk‖²."""
    mu0, recon0, kl0 = image_terms(p, xs[0], eps[0])
    mu1, recon1, kl1 = sketch_terms(p, 1, xs[1], eps[1], tolerance)
    assoc = ((mu0 - mu1) ** 2).sum(-1).mean()
    return recon0.mean() + kl0.mean() + recon1 + w_kl * kl1 + lam * assoc


def lr_at(lr, lr_min, decay, step):
    return (lr - lr_min) * decay ** step + lr_min


def kl_weight_at(w, w_start, decay, step):
    return w - (w - w_start) * decay ** step


def adam_steps(params, objective, n_steps, *, lr_of, clip, b1=0.9, b2=0.999, eps=1e-8):
    """Adam over ``objective(p, step)``, every gradient clipped to ±clip,
    at the learning rate ``lr_of(step)``. Returns (losses, the first
    clipped gradient, the change of every weight)."""
    names = list(params)
    p = {n: params[n].detach().clone().requires_grad_(True) for n in names}
    mu = {n: torch.zeros_like(p[n]) for n in names}
    nu = {n: torch.zeros_like(p[n]) for n in names}
    losses, grad1 = [], None
    for step in range(n_steps):
        total = objective(p, step)
        grads = [g.clamp(-clip, clip) for g in torch.autograd.grad(total, [p[n] for n in names])]
        losses.append(float(total.detach()))
        if grad1 is None:
            grad1 = {n: g.detach().clone() for n, g in zip(names, grads)}
        with torch.no_grad():
            t = step + 1
            bc1, bc2 = 1.0 - b1 ** t, 1.0 - b2 ** t
            for n, g in zip(names, grads):
                mu[n].mul_(b1).add_(g, alpha=1.0 - b1)
                nu[n].mul_(b2).addcmul_(g, g, value=1.0 - b2)
                p[n].sub_(lr_of(step) * (mu[n] / bc1) / ((nu[n] / bc2).sqrt() + eps))
    return losses, grad1, {n: p[n].detach() - params[n] for n in names}


@torch.no_grad()
def greedy_decode(p, pre, z, n_steps):
    """Points S_1..S_N [B, N, 5] of sketch_rnn's greedy decode from z."""
    m = (p[f"{pre}.out.w"].shape[1] - 3) // 6
    b = z.shape[0]
    h, c = initial_state(p, pre, z)
    prev = z.new_tensor(START).expand(b, POINT)
    done = torch.zeros(b, dtype=torch.bool)
    out = []
    for _ in range(n_steps):
        h, c = _cell(p, f"{pre}.dec", torch.cat([prev, z], dim=1), h, c)
        y = head(p, pre, h)
        j = y[:, 3:3 + m].argmax(1, keepdim=True)
        pen = y[:, :3].argmax(1)
        point = torch.cat([y[:, 3 + m:3 + 2 * m].gather(1, j),
                           y[:, 3 + 2 * m:3 + 3 * m].gather(1, j), F.one_hot(pen, 3).float()], dim=1)
        point = torch.where(done[:, None], z.new_tensor(PAD).expand(b, POINT), point)
        out.append(point)
        done = done | (pen == 2)
        prev = point
    return torch.stack(out, dim=1)
