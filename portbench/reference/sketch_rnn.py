"""The plain reference of the joint VAE with a Sketch-RNN trajectory tower: loss, gradients, Adam.

Plain PyTorch, float32 with TF32 off, written from the equations of D. Ha
and D. Eck, *A Neural Representation of Sketch Drawings* (ICLR 2018,
arXiv:1704.03477) and magenta's ``sketch_rnn`` (``model.py``, ``rnn.py``,
``sketch_rnn_train.py``):

- rows [S_0, S_1, …, S_N] of stroke-5 points, S_0 = (0, 0, 1, 0, 0), padded
  with (0, 0, 0, 0, 1); L = the points with p3 = 0;
- LSTM cell: [i, j, f, o] = [x; h]·W + b, c' = c·σ(f + 1) + σ(i)·tanh(j),
  h' = tanh(c')·σ(o);
- encoder: a bidirectional LSTM over S_1..S_L (the backward direction
  starts at S_L; steps past L change no state), μ and σ̂ from [h_fw; h_bw],
  z = μ + exp(σ̂/2)·ε;
- decoder: [c_0; h_0] = tanh(W_z z + b), input [S_{i−1}; z], N steps;
  head y = W_y h + b, pen logits and a mixture of M bivariate Gaussians;
- L_R = mean over rows × N of −log(Σ π N + 1e-6)·(1 − p3) + CE(pen);
  KL = −½ mean(1 + σ̂ − μ² − e^σ̂), the term max(KL, kl_tolerance)·w_KL;
- the joint objective: the image tower's Bernoulli loss and KL (the MLP
  tower of reference/model.py) + L_R + the KL term + λ·mean ‖μ_img − μ_sk‖²;
- Adam with every gradient clipped by value, lr(s) = (lr − lr_min)·d^s +
  lr_min, w_KL(s) = w − (w − w_start)·d_KL^s.

Weights are a dict keyed by the program's parameter names
(``modalities.1.enc_fw.w_x``; the cell's W split into ``w_x`` and ``w_h``),
linear weights [in, out]. ``precision`` names the arithmetic of every
product as in reference/model.py, whose ε, rounding and epoch permutation
this module uses. Also here: the step's FLOPs and the compulsory bytes of
its recurrences and of its mixture loss, for the rooflines.

This module imports torch and reference/model.py only.
"""

from __future__ import annotations

import math

import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench.reference import model as ref

POINT = 5
EPS = 1e-6


def _sketch(model: dict):
    (k,) = [i for i, m in enumerate(model["modalities"]) if m.get("encoder") == "sketch_rnn"]
    return k, model["modalities"][k]


def param_spec(model: dict) -> list:
    """[(name, shape, fan_in, fan_out)] of every parameter: the MLP image
    tower (modality 0) as reference/model.py, then the sketch tower."""
    k, m = _sketch(model)
    spec = ref.param_spec({"modalities": [model["modalities"][0]]})
    a, p = m["arch"], f"modalities.{k}"
    he, hd, nz = a["enc_rnn_size"], a["dec_rnn_size"], a["n_z"]

    def lstm(name, n_in, h):
        spec.append((f"{p}.{name}.w_x", (n_in, 4 * h), n_in, 4 * h))
        spec.append((f"{p}.{name}.w_h", (h, 4 * h), h, 4 * h))
        spec.append((f"{p}.{name}.b", (4 * h,), 0, 4 * h))

    def lin(name, n_in, n_out):
        spec.append((f"{p}.{name}.w", (n_in, n_out), n_in, n_out))
        spec.append((f"{p}.{name}.b", (n_out,), 0, n_out))

    lstm("enc_fw", POINT, he)
    lstm("enc_bw", POINT, he)
    lin("mu", 2 * he, nz)
    lin("sigma", 2 * he, nz)
    lin("init", nz, 2 * hd)
    lstm("dec", POINT + nz, hd)
    lin("out", hd, 3 + 6 * a["num_mixture"])
    return spec


# -- the sketch tower ------------------------------------------------------------


def _mm(x, w, precision):
    return ref.product(ref.operand(x, precision) @ ref.operand(w, precision), precision)


def _cell(p, name, x, h, c, precision):
    w = torch.cat([p[f"{name}.w_x"], p[f"{name}.w_h"]], dim=0)
    pre = _mm(torch.cat([x, h], dim=1), w, precision) + p[f"{name}.b"]
    gi, gj, gf, go = pre.chunk(4, dim=1)
    c = c * torch.sigmoid(gf + 1.0) + torch.sigmoid(gi) * torch.tanh(gj)
    return torch.tanh(c) * torch.sigmoid(go), c


def _rnn(p, name, xs, h, c, precision, lens=None):
    """Every step's h over the time-major ``xs`` [N, B, n_in], and the last
    (h, c); a row holds its state from step lens[b] on."""
    out = []
    for t in range(xs.shape[0]):
        h2, c2 = _cell(p, name, xs[t], h, c, precision)
        if lens is not None:
            on = (lens > t)[:, None]
            h2, c2 = torch.where(on, h2, h), torch.where(on, c2, c)
        h, c = h2, c2
        out.append(h)
    return out, h, c


def lengths(points):
    return (points[..., 4] == 0).sum(1)


def reversed_points(points, lens):
    """Time-major [N, B, 5]: step k of row b is S_{L_b − k}, zeros past L_b."""
    b, n, _ = points.shape
    idx = lens[:, None] - 1 - torch.arange(n, device=points.device)[None, :]
    got = torch.gather(points, 1, idx.clamp_min(0)[..., None].expand(b, n, POINT))
    return torch.where((idx >= 0)[..., None], got, torch.zeros_like(got)).transpose(0, 1)


def encode(p, pre, points, precision):
    """(μ, σ̂) of the encoder over S_1..S_N [B, N, 5]; ``pre`` the tower's
    name prefix (``modalities.1``)."""
    lens = lengths(points)
    zeros = points.new_zeros(points.shape[0], p[f"{pre}.enc_fw.w_h"].shape[0])
    _, hf, _ = _rnn(p, f"{pre}.enc_fw", points.transpose(0, 1), zeros, zeros, precision, lens)
    _, hb, _ = _rnn(p, f"{pre}.enc_bw", reversed_points(points, lens), zeros, zeros, precision,
                    lens)
    h = torch.cat([hf, hb], dim=1)
    return (_mm(h, p[f"{pre}.mu.w"], precision) + p[f"{pre}.mu.b"],
            _mm(h, p[f"{pre}.sigma.w"], precision) + p[f"{pre}.sigma.b"])


def initial_state(p, pre, z, precision):
    hd = p[f"{pre}.dec.w_h"].shape[0]
    s = torch.tanh(_mm(z, p[f"{pre}.init.w"], precision) + p[f"{pre}.init.b"])
    return s[:, hd:], s[:, :hd]


def head(p, pre, h, precision):
    return _mm(h, p[f"{pre}.out.w"], precision) + p[f"{pre}.out.b"]


def decode(p, pre, rows, z, precision):
    """The head's output [N, B, 3 + 6M] of the teacher-forced decoder."""
    b, n = rows.shape[0], rows.shape[1] - 1
    h, c = initial_state(p, pre, z, precision)
    xs = torch.cat([rows[:, :-1].transpose(0, 1), z[None].expand(n, b, z.shape[1])], dim=2)
    hs, _, _ = _rnn(p, f"{pre}.dec", xs, h, c, precision)
    return head(p, pre, torch.stack(hs), precision)


def mixture_loss(y, tgt):
    """Each row's loss of head outputs y [.., 3 + 6M] against the points
    tgt [.., 5], as sketch_rnn's ``get_lossfunc`` (training) writes it."""
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


def sketch_terms(p, k, m, rows, eps, precision, keep=None):
    """(μ, L_R, max(KL, kl_tolerance)) of the sketch tower on ``rows``;
    ``keep`` takes the means over those rows only."""
    pre = f"modalities.{k}"
    points = rows[:, 1:]
    mu, presig = encode(p, pre, points, precision)
    z = mu + torch.exp(0.5 * presig) * eps
    per_row = mixture_loss(decode(p, pre, rows, z, precision), points.transpose(0, 1))
    kl = 1.0 + presig - mu * mu - torch.exp(presig)
    if keep is not None:
        per_row, kl, mu = per_row[:, keep], kl[keep], mu[keep]
    kl = torch.clamp_min(-0.5 * torch.mean(kl), float(m.get("kl_tolerance", 0.0)))
    return mu, torch.mean(per_row), kl


def loss(p, model: dict, xs: list, eps: list, w_kl: float, precision="fp32", rows=None):
    """The joint objective of one batch at the sketch KL weight ``w_kl``."""
    k, m = _sketch(model)
    img = model["modalities"][0]
    mu0, lv0 = ref.encode(p, 0, img, xs[0], precision)
    out = ref.decode(p, 0, img, mu0 + torch.exp(0.5 * lv0) * eps[0], precision)
    x = xs[0]
    recon0 = (out.clamp_min(0) - out * x + torch.log1p(torch.exp(-out.abs()))).sum(-1)
    kl0 = -0.5 * (1.0 + lv0 - mu0 * mu0 - torch.exp(lv0)).sum(-1)
    if rows is not None:
        recon0, kl0, mu0 = recon0[rows], kl0[rows], mu0[rows]
    mu1, recon1, kl1 = sketch_terms(p, k, m, xs[k], eps[k], precision, rows)
    assoc = ((mu0 - mu1) ** 2).sum(-1).mean()
    return (recon0.mean() + kl0.mean() + recon1 + w_kl * kl1
            + float(model["assoc_lambda"]) * assoc)


# -- training -------------------------------------------------------------------


def lr_at(train: dict, step: int) -> float:
    """(lr − lr_min)·decay^step + lr_min (sketch_rnn_train.py)."""
    lo = train["min_learning_rate"]
    return (train["learning_rate"] - lo) * train["lr_decay_rate"] ** step + lo


def kl_weight_at(model: dict, step: int) -> float:
    """w − (w − w_start)·decay^step (sketch_rnn_train.py), from the sketch
    modality's ``kl_weight``, ``kl_weight_start`` and ``kl_decay_rate``."""
    m = _sketch(model)[1]
    w = m["kl_weight"]
    return w - (w - m["kl_weight_start"]) * m["kl_decay_rate"] ** step


def train_steps(params: dict, model: dict, train: dict, batches: list, seed: int,
                precision="fp32", half_batch=False):
    """Adam over ``batches`` (one list of per-modality rows a step, in the
    order the program takes them), every gradient clipped to
    ±grad_clip_value, at the schedules' learning rate and KL weight; ε drawn
    at steps 0, 1, ... of the stream ``seed``.

    Returns (losses, first gradient after clipping, change after the last
    step), the latter two dicts by parameter name."""
    names = list(params)
    p = {n: params[n].detach().clone().requires_grad_(True) for n in names}
    mu = {n: torch.zeros_like(p[n]) for n in names}
    nu = {n: torch.zeros_like(p[n]) for n in names}
    b1, b2, eps_adam = train["adam_b1"], train["adam_b2"], train["adam_eps"]
    clip = train["grad_clip_value"]
    n_z = int(model["modalities"][0]["arch"]["n_z"])
    losses, grad1 = [], None
    with ref.exact_fp32():
        for step, xs in enumerate(batches):
            b = xs[0].shape[0]
            eps = ref.step_eps(seed, step, b, n_z, len(xs), xs[0].device)
            rows = slice(0, b // 2) if half_batch else None
            total = loss(p, model, xs, eps, kl_weight_at(model, step), precision, rows)
            grads = torch.autograd.grad(total, [p[n] for n in names])
            grads = [g.clamp(-clip, clip) for g in grads]
            losses.append(float(total.detach()))
            if grad1 is None:
                grad1 = {n: g.detach().clone() for n, g in zip(names, grads)}
            with torch.no_grad():
                t = step + 1
                bc1, bc2 = 1.0 - b1 ** t, 1.0 - b2 ** t
                lr = lr_at(train, step)
                for n, g in zip(names, grads):
                    mu[n].mul_(b1).add_(g, alpha=1.0 - b1)
                    nu[n].mul_(b2).addcmul_(g, g, value=1.0 - b2)
                    p[n].sub_(lr * (mu[n] / bc1) / ((nu[n] / bc2).sqrt() + eps_adam))
    change = {n: (p[n].detach() - params[n]) for n in names}
    return losses, grad1, change


# -- work of a step, for the rooflines --------------------------------------------


def step_flops(model: dict, batch: int) -> int:
    """Model FLOPs of one training step (forward and backward) at ``batch``,
    counted by ``torch.utils.flop_counter`` over this reference on the
    ``meta`` device."""
    k, m = _sketch(model)
    meta = torch.device("meta")
    p = {n: torch.empty(s, device=meta, requires_grad=True) for n, s, _, _ in param_spec(model)}
    n_z = int(m["arch"]["n_z"])
    xs = [torch.empty(batch, int(model["modalities"][0]["arch"]["n_input"]), device=meta),
          torch.zeros(batch, m["arch"]["max_seq_len"] + 1, POINT, device=meta)]
    eps = [torch.empty(batch, n_z, device=meta) for _ in xs]
    with FlopCounterMode(display=False) as counter:
        total = loss(p, model, xs, eps, 1.0)
        torch.autograd.grad(total, list(p.values()))
    return int(counter.get_total_flops())


def _layers(model: dict):
    """(n_in, H, directions) of each LSTM layer of the sketch tower."""
    a = _sketch(model)[1]["arch"]
    return [(POINT, a["enc_rnn_size"], 2), (POINT + a["n_z"], a["dec_rnn_size"], 1)]


def lstm_flops(model: dict, batch: int) -> int:
    """The recurrences' FLOPs a step: per LSTM and direction 2·B·N·(n_in +
    H)·4H forward and twice that backward."""
    n = _sketch(model)[1]["arch"]["max_seq_len"]
    return sum(3 * d * 2 * batch * n * (n_in + h) * 4 * h for n_in, h, d in _layers(model))


def lstm_bytes(model: dict, batch: int) -> int:
    """The recurrences' compulsory bytes a step in fp32: each direction's
    weights read once; its gate pre-activations and its h and c sequences
    written once and read once."""
    n = _sketch(model)[1]["arch"]["max_seq_len"]
    return sum(d * 4 * ((n_in + h) * 4 * h + 2 * n * batch * (4 * h + 2 * h))
               for n_in, h, d in _layers(model))


def mixture_bytes(model: dict, batch: int) -> int:
    """The mixture loss's compulsory bytes a step in fp32: the head output
    and the targets read once, the gradient written once."""
    a = _sketch(model)[1]["arch"]
    width = 3 + 6 * a["num_mixture"]
    return 4 * batch * a["max_seq_len"] * (2 * width + POINT)
