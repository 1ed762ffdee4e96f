"""Sketch-RNN as a modality tower of the joint VAE (``encoder="sketch_rnn"``).

D. Ha and D. Eck, *A Neural Representation of Sketch Drawings*, ICLR 2018
(arXiv:1704.03477); magenta ``sketch_rnn/model.py``, ``rnn.py`` and
``sketch_rnn_train.py``. The port's own tower: the JAX package has none and
cannot read a config that holds one. The equations, followed exactly:

Notation. S_i = (Δx, Δy, p1, p2, p3), S_0 = (0, 0, 1, 0, 0). A row is
[S_0, S_1, …, S_Nmax] ([N_max + 1, 5]), padded past its end with
(0, 0, 0, 0, 1). Its length L is its number of points with p3 = 0, counted
on the device from the row itself.

- LSTM cell (``rnn.LSTMCell``): [i, j, f, o] = [x; h]·W + b, then
  c' = c·σ(f + 1.0) + σ(i)·tanh(j), h' = tanh(c')·σ(o).
- Encoder: a bidirectional LSTM of ``enc_rnn_size`` a direction over
  S_1..S_L with ``bidirectional_dynamic_rnn(sequence_length=L)`` semantics:
  the forward direction's state is taken at step L, the backward direction
  starts at S_L, steps past L change no state. h = [h_fw; h_bw],
  μ = W_μ h + b, σ̂ = W_σ h + b, z = μ + exp(σ̂/2)·ε.
- Decoder: [c_0; h_0] = tanh(W_z z + b); the input at step i is
  [S_{i−1}; z]; it runs all N_max steps, with no length.
- Head: y_i = W_y h_i + b (3 + 6M). The pen logits are y[0:3]; the rest
  splits into six groups of M: π (softmax), μx, μy, σx = exp, σy = exp,
  ρ = tanh.
- Loss of the modality: L_R = mean over batch × N_max of
  [−log(Σ_j π_j N(Δx, Δy | μ, σ, ρ) + 1e-6)·(1 − p3) + CE(pen logits,
  (p1, p2, p3))] against S_i; the pen term over every step.
- KL = −½·mean over batch and n_z of (1 + σ̂ − μ² − e^σ̂); the term is
  max(KL, ``kl_tolerance``)·w_KL, w_KL the modality's ``kl_weight`` or
  ``TrainConfig``'s schedule toward it (train/step.py).

Recurrent dropout is off (``use_recurrent_dropout=False``), and strokes are
not augmented. Parameters: ``enc_fw``, ``enc_bw`` and ``dec`` hold ``w_x``
[n_in, 4H], ``w_h`` [H, 4H], ``b`` [4H] (the cell's W split at the input's
width); ``mu``, ``sigma``, ``init`` (W_z) and ``out`` (W_y) hold ``w``
[in, out], ``b``.

``use_pallas`` truthy runs the tower on the hand-written kernels: each
LSTM's input product hoisted over all steps into one product on the dense
kernels, one persistent ``lstm_fwd`` launch a layer (both encoder
directions in one; the greedy decode's a one-step range), ``lstm_bwd``
backward, the head over all steps in one product and
``mixture_loss`` (kernels/lstm.py, kernels/mixture.py; their plain twins on
the CPU). False is the plain torch path, autograd through the equations as
written. Spans ``sketch.encode``, ``sketch.decode``, ``sketch.mixture_loss``.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from vae_assoc_tpu_torch.models import networks
from vae_assoc_tpu_torch.models.networks import Linear, round_operand, xavier_uniform
from vae_assoc_tpu_torch.utils import spans

POINT = 5
START = (0.0, 0.0, 1.0, 0.0, 0.0)
PAD = (0.0, 0.0, 0.0, 0.0, 1.0)
EPS = 1e-6


class LSTMLayer(nn.Module):
    """One LSTM direction: ``w_x`` [n_in, 4H], ``w_h`` [H, 4H] (Glorot),
    ``b`` [4H] (zeros); gates in the order [i, j, f, o]."""

    def __init__(self, n_in: int, n_hidden: int, *, device, generator=None):
        super().__init__()

        def w(n_rows):
            if generator is None:
                return nn.Parameter(torch.zeros(n_rows, 4 * n_hidden, device=device))
            return nn.Parameter(xavier_uniform(n_rows, 4 * n_hidden, generator=generator,
                                               device=device))

        self.w_x = w(n_in)
        self.w_h = w(n_hidden)
        self.b = nn.Parameter(torch.zeros(4 * n_hidden, device=device))


class SketchRNN(nn.Module):
    """The tower's weights at the arch dict's sizes (configs.SKETCH_ARCH_KEYS)."""

    def __init__(self, arch, *, device, generator=None):
        super().__init__()
        he, hd, nz = arch["enc_rnn_size"], arch["dec_rnn_size"], arch["n_z"]

        def lin(n_in, n_out):
            return Linear(n_in, n_out, device=device, generator=generator)

        self.enc_fw = LSTMLayer(POINT, he, device=device, generator=generator)
        self.enc_bw = LSTMLayer(POINT, he, device=device, generator=generator)
        self.mu = lin(2 * he, nz)
        self.sigma = lin(2 * he, nz)
        self.init = lin(nz, 2 * hd)
        self.dec = LSTMLayer(POINT + nz, hd, device=device, generator=generator)
        self.out = lin(hd, 3 + 6 * arch["num_mixture"])
        # The bias of the decoder's hoisted product over the points (its b
        # goes with z's): one tensor at one address, so that a captured
        # step finds the dense kernel's weight table it built eagerly.
        self.register_buffer("no_bias", torch.zeros(4 * hd, device=device), persistent=False)


def check_rows(rows: torch.Tensor, arch, name: str) -> None:
    """A batch of the wrong shape is the caller's error: ValueError."""
    want = (arch["max_seq_len"] + 1, POINT)
    if rows.ndim != 3 or tuple(rows.shape[1:]) != want:
        raise ValueError(f"modality {name!r} expects [batch, {want[0]}, {POINT}] stroke-5 rows, "
                         f"got {tuple(rows.shape)}")


def lengths(points: torch.Tensor) -> torch.Tensor:
    """Each row's L [B] int32: its points S_1..S_N ([B, N, 5]) with p3 = 0."""
    return (points[..., 4] == 0).sum(1).to(torch.int32)


def reverse_by_length(points: torch.Tensor, lens: torch.Tensor) -> torch.Tensor:
    """The backward direction's inputs, time-major [N, B, 5]: step k of row b
    is S_{L_b − k}, zeros past L_b."""
    b, n, _ = points.shape
    idx = lens[:, None].long() - 1 - torch.arange(n, device=points.device)[None, :]
    got = torch.gather(points, 1, idx.clamp_min(0)[..., None].expand(b, n, POINT))
    return torch.where((idx >= 0)[..., None], got, torch.zeros_like(got)).transpose(0, 1)


def _mm(a, w, cd):
    return round_operand(a, cd) @ round_operand(w, cd)


def _cell(pre, c):
    gi, gj, gf, go = pre.chunk(4, dim=-1)
    c = c * torch.sigmoid(gf + 1.0) + torch.sigmoid(gi) * torch.tanh(gj)
    return torch.tanh(c) * torch.sigmoid(go), c


def _lstm_plain(layer, xs, h, c, cd, lens=None):
    """The cell as written over the time-major inputs ``xs`` [T, B, n_in]:
    (every step's h, the last h, the last c); a row holds its state from
    step lens[b] on."""
    w = torch.cat([layer.w_x, layer.w_h], dim=0)
    out = []
    for t in range(xs.shape[0]):
        h2, c2 = _cell(_mm(torch.cat([xs[t], h], dim=1), w, cd) + layer.b, c)
        if lens is not None:
            active = (lens > t)[:, None]
            h2, c2 = torch.where(active, h2, h), torch.where(active, c2, c)
        h, c = h2, c2
        out.append(h)
    return out, h, c


def _linear(layer, x, cd, use_pallas):
    if use_pallas:
        from vae_assoc_tpu_torch.kernels import lstm as klstm

        return klstm.linear(x, layer.w, layer.b, cd)
    return networks.linear(layer, x, cd)


def encode(p: SketchRNN, points: torch.Tensor, lens: torch.Tensor, cd: str, use_pallas):
    """(μ, σ̂) [B, n_z] from the points S_1..S_N [B, N, 5] of lengths ``lens``."""
    b, n, _ = points.shape
    he = p.enc_fw.w_h.shape[0]
    fw_in, bw_in = points.transpose(0, 1), reverse_by_length(points, lens)
    zeros = points.new_zeros(b, he)
    if use_pallas:
        from vae_assoc_tpu_torch.kernels import lstm as klstm

        xf = klstm.linear(fw_in.reshape(n * b, POINT), p.enc_fw.w_x, p.enc_fw.b, cd)
        xb = klstm.linear(bw_in.reshape(n * b, POINT), p.enc_bw.w_x, p.enc_bw.b, cd)
        hf, hb = klstm.lstm([xf.view(n, b, -1), xb.view(n, b, -1)], [p.enc_fw.w_h, p.enc_bw.w_h],
                            [zeros, zeros], [zeros, zeros], lengths=lens, compute_dtype=cd)
        h = torch.cat([hf[n], hb[n]], dim=1)
    else:
        _, hf, _ = _lstm_plain(p.enc_fw, fw_in, zeros, zeros, cd, lens)
        _, hb, _ = _lstm_plain(p.enc_bw, bw_in, zeros, zeros, cd, lens)
        h = torch.cat([hf, hb], dim=1)
    return _linear(p.mu, h, cd, use_pallas), _linear(p.sigma, h, cd, use_pallas)


def initial_state(p: SketchRNN, z, cd, use_pallas):
    """(h_0, c_0) from [c_0; h_0] = tanh(W_z z + b)."""
    hd = p.dec.w_h.shape[0]
    s = torch.tanh(_linear(p.init, z, cd, use_pallas))
    return s[:, hd:].contiguous(), s[:, :hd].contiguous()


def decode(p: SketchRNN, rows: torch.Tensor, z: torch.Tensor, cd: str, use_pallas):
    """The head's output y [N·B, 3 + 6M], time-major, of the teacher-forced
    decoder over the inputs [S_{i−1}; z], i = 1..N."""
    b, n = rows.shape[0], rows.shape[1] - 1
    hd = p.dec.w_h.shape[0]
    h0, c0 = initial_state(p, z, cd, use_pallas)
    xin = rows[:, :-1].transpose(0, 1)
    if use_pallas:
        from vae_assoc_tpu_torch.kernels import lstm as klstm

        xp = klstm.linear(xin.reshape(n * b, POINT), p.dec.w_x[:POINT], p.no_bias, cd)
        xrow = klstm.linear(z, p.dec.w_x[POINT:], p.dec.b, cd)
        (hs,) = klstm.lstm([xp.view(n, b, -1)], [p.dec.w_h], [h0], [c0], xrow=xrow,
                           compute_dtype=cd)
        return klstm.linear(hs[1:].reshape(n * b, hd), p.out.w, p.out.b, cd)
    xs = torch.cat([xin, z[None].expand(n, b, z.shape[1])], dim=2)
    hs, _, _ = _lstm_plain(p.dec, xs, h0, c0, cd)
    return networks.linear(p.out, torch.stack(hs).reshape(n * b, hd), cd)


def mixture_loss_published(y: torch.Tensor, tgt: torch.Tensor) -> torch.Tensor:
    """Each row's loss, as sketch_rnn's ``get_lossfunc`` writes it (the
    plain path; autograd gives its gradient)."""
    m = (y.shape[1] - 3) // 6
    pi, mu1, mu2, s1, s2, rho = y[:, 3:].split(m, dim=1)
    pi, s1, s2, rho = torch.softmax(pi, dim=1), torch.exp(s1), torch.exp(s2), torch.tanh(rho)
    n1, n2 = tgt[:, 0:1] - mu1, tgt[:, 1:2] - mu2
    s1s2 = s1 * s2
    z = (n1 / s1) ** 2 + (n2 / s2) ** 2 - 2 * (rho * (n1 * n2)) / s1s2
    neg_rho = 1 - rho * rho
    pdf = torch.exp(-z / (2 * neg_rho)) / (2 * math.pi * s1s2 * torch.sqrt(neg_rho))
    offsets = -torch.log((pdf * pi).sum(1) + EPS) * (1.0 - tgt[:, 4])
    pen = -(tgt[:, 2:5] * torch.log_softmax(y[:, :3], dim=1)).sum(1)
    return offsets + pen


def sketch_forward(p: SketchRNN, rows, cfg, *, seed=None, eps=None, compute_dtype="float32",
                   use_pallas=False):
    """Encoder → z → decoder → the modality's reconstruction loss:
    ``VAEOutputs(μ, σ̂, z, recon)`` with ``recon`` the scalar L_R. ε from
    ``seed`` (an int or a 0-dim int64 tensor) or ``eps`` [B, n_z]."""
    from vae_assoc_tpu_torch.models.vae import VAEOutputs, draw_eps
    from vae_assoc_tpu_torch.ops import sampling

    check_rows(rows, cfg.arch, cfg.name)
    cd = networks.dtype_name(compute_dtype)
    rows = rows.float()
    points = rows[:, 1:]
    with spans.span("sketch.encode"):
        mu, presig = encode(p, points, lengths(points), cd, use_pallas)
        if eps is None and seed is None:
            raise ValueError("sketch_forward needs `seed` or `eps`")
        if use_pallas and eps is None:
            from vae_assoc_tpu_torch.kernels.sampling import reparameterize_fused

            z = reparameterize_fused(mu, presig, seed)
        else:
            if eps is None:
                eps = draw_eps(seed, rows.shape[0], cfg, rows.device)
            z = sampling.reparameterize(mu, presig, eps=eps)
    with spans.span("sketch.decode"):
        y = decode(p, rows, z, cd, use_pallas)
    with spans.span("sketch.mixture_loss"):
        tgt = points.transpose(0, 1).reshape(-1, POINT)
        if use_pallas:
            from vae_assoc_tpu_torch.kernels import mixture as kmix

            per_row = kmix.mixture_loss(y, tgt)
        else:
            per_row = mixture_loss_published(y, tgt)
    return VAEOutputs(mu, presig, z, torch.mean(per_row))


def kl_term(out, cfg) -> torch.Tensor:
    """max(KL, kl_tolerance), KL = −½·mean over batch and n_z of
    (1 + σ̂ − μ² − e^σ̂)."""
    kl = -0.5 * torch.mean(1.0 + out.z_logvar - out.z_mean * out.z_mean - torch.exp(out.z_logvar))
    return torch.clamp_min(kl, cfg.kl_tolerance)


def transform(p: SketchRNN, rows, cfg, *, compute_dtype="float32", use_pallas=False):
    """Rows → μ, the encoder's latent mean."""
    check_rows(rows, cfg.arch, cfg.name)
    points = rows.float()[:, 1:]
    return encode(p, points, lengths(points), networks.dtype_name(compute_dtype), use_pallas)[0]


@torch.no_grad()
def greedy_decode(p: SketchRNN, z, cfg, *, compute_dtype="float32", use_pallas=False):
    """sketch_rnn's greedy decode from z [B, n_z]: at each step the most
    probable component's mean and the most probable pen state, fed back as
    the next input; a row ends at its first p3 and is padded with
    (0, 0, 0, 0, 1) to N_max. Returns the points S_1..S_Nmax [B, N_max, 5]."""
    cd = networks.dtype_name(compute_dtype)
    n, m = cfg.arch["max_seq_len"], cfg.arch["num_mixture"]
    b = z.shape[0]
    z = z.float()
    h, c = initial_state(p, z, cd, use_pallas)
    prev = z.new_tensor(START).expand(b, POINT)
    pad = z.new_tensor(PAD).expand(b, POINT)
    done = torch.zeros(b, dtype=torch.bool, device=z.device)
    out = z.new_empty(b, n, POINT)
    if use_pallas:
        from vae_assoc_tpu_torch.kernels import lstm as klstm

        xrow = klstm.linear(z, p.dec.w_x[POINT:], p.dec.b, cd)
    for i in range(n):
        if use_pallas:
            xp = klstm.linear(prev.contiguous(), p.dec.w_x[:POINT], p.no_bias, cd)
            (d,) = klstm.forward_states([xp[None]], [p.dec.w_h], [h], [c], xrow=xrow,
                                        compute_dtype=cd)
            h, c = d.hs[1], d.cs[1]
        else:
            _, h, c = _lstm_plain(p.dec, torch.cat([prev, z], dim=1)[None], h, c, cd)
        y = _linear(p.out, h, cd, use_pallas)
        j = y[:, 3:3 + m].argmax(1, keepdim=True)
        dx = y[:, 3 + m:3 + 2 * m].gather(1, j)
        dy = y[:, 3 + 2 * m:3 + 3 * m].gather(1, j)
        pen = y[:, :3].argmax(1)
        point = torch.cat([dx, dy, nn.functional.one_hot(pen, 3).float()], dim=1)
        point = torch.where(done[:, None], pad, point)
        out[:, i] = point
        done = done | (pen == 2)
        prev = point
    return out
