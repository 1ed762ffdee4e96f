"""LSTM layers on hand-written CUDA kernels (``csrc/lstm.cu``) and their plain twins.

Sketch-RNN's cell (models/sketch_rnn.py; sketch_rnn ``rnn.LSTMCell``, forget
bias 1): [i, j, f, o] = x·W_x + h·W_h + b, c' = c·σ(f + 1) + σ(i)·tanh(j),
h' = tanh(c')·σ(o). A layer takes its input product hoisted over all steps,
``xproj`` [T, B, 4H] = x·W_x (+ b), computed beforehand in one product on
the dense kernels (:func:`linear`), and an optional per-row addend ``xrow``
[B, 4H] (the decoder's z·W_x[5:] + b). With ``lengths`` (int32 [B]) a row
holds its state from step ``lengths[b]`` on (``bidirectional_dynamic_rnn``'s
``sequence_length``); the encoder's two directions share each launch.

Both kernels are persistent over time: one launch runs a range of steps of
a layer, every direction in it, each block keeping its share of W_h in
shared memory across the steps and one barrier ending each step.
``lstm_fwd`` walks [t0, t1) forward: the recurrent product h_t·W_h, then the
gates, the c/h update and the length mask, keeping the gate pre-activations
for the backward; a layer's forward is one launch, the greedy decode's step
a one-step range. ``lstm_bwd`` walks t1 − 1 down to t0: dgates_{t+1}·W_hᵀ
split by gate over the four blocks of a cluster, its partials added in gate
order, then the gate gradients of step t and the carried dc; t0 = −1 ends
with dh of the initial state. W_h's gradient is one ``wgrad`` over all T·B
rows afterwards (kernels/mlp.py::weight_grads). The bf16 policy is the
other kernels': products' operands rounded to bf16 and summed in fp32; c, h
and every other value in fp32.

Dispatch is by the device of the input: the plain twins on the CPU, the
kernels on CUDA (or raise). Each launch adds one to its counter in
``_launches.TRAINING``: one a layer call, more only where the batch needs
more row groups than the device holds at once (:func:`step_plan`).
"""

from __future__ import annotations

import ctypes

import torch

from vae_assoc_tpu_torch.kernels import _build, _launches
from vae_assoc_tpu_torch.kernels import mlp as kmlp
from vae_assoc_tpu_torch.models import networks

UNITS = 16
"""Units a forward block owns (all four gates of each): the hidden width
must be a multiple of it."""

SYNC_GROUPS = 512
"""Barrier counters kept per device and stream (csrc/lstm.cu): one per row
group and direction of a launch."""

SYNC_STRIDE = 32
"""Words between two counters (csrc/lstm.cu's kSyncStride): one 128-byte
line each."""


class _Dir(ctypes.Structure):
    """``LstmDir`` of csrc/lstm.cu: one direction's device pointers."""

    _fields_ = [(n, ctypes.c_void_p) for n in (
        "xproj", "w", "hs", "cs", "gates", "dgates", "dh_seq", "dh_acc", "dc_acc", "dh0",
        "stage")]


def step_plan(fwd: bool, batch: int, hidden: int, n_dirs: int, compute_dtype, device) -> dict:
    """The split the kernels take on the card for a layer (csrc/lstm.cu's
    ``lstm_plan``): ``tile_rows`` (16, 32, 48 or 64), ``rows`` a row group,
    ``chunk`` rows a launch, ``per_group`` blocks a row group (every
    direction's; a step's barrier spans one direction's), ``k_chunks`` the
    step's operand is staged in, ``smem`` bytes a block, ``resident`` blocks
    the device holds at once, and ``launches``."""
    lib = _build.load()
    out = (ctypes.c_int * 8)()
    bf16 = int(networks.dtype_name(compute_dtype) == "bfloat16")
    with torch.cuda.device(device):
        err = lib.vae_lstm_plan(int(fwd), n_dirs, batch, hidden, bf16, out)
    _build.check(lib, err, "lstm plan")
    return dict(zip(("tile_rows", "rows", "chunk", "per_group", "k_chunks", "smem", "resident",
                     "launches"), out))


_syncs: dict = {}


def sync_counters(device) -> torch.Tensor:
    """The barrier counters of ``device``, zero when made; each barrier
    leaves them as it found them, so they are made once and a replayed graph
    needs no reset. One set a device: the LSTM kernels of a device run one
    at a time, on one stream (eager steps and graph replays alike), since
    two launches at once would share a barrier. They are made eagerly, so
    never inside a CUDA graph's capture, where the zero fill would be
    recorded and not run: a capture must follow an eager call."""
    device = torch.device(device)
    index = device.index if device.index is not None else torch.cuda.current_device()
    t = _syncs.get(index)
    if t is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("the LSTM kernels' barrier counters are made by an eager call; "
                               "run the step once before capturing it")
        t = _syncs[index] = torch.zeros(SYNC_GROUPS * SYNC_STRIDE, dtype=torch.int32,
                                        device=device)
    return t


class Direction:
    """One direction's tensors: ``xproj`` [T, B, 4H], ``w_h`` [H, 4H], the
    states ``hs``, ``cs`` [T + 1, B, H] (index 0 the initial state), the gate
    pre-activations ``gates`` [T, B, 4H]; in the backward, ``dgates``
    [T + 1, B, 4H] (slot T zero), ``dh_seq`` (the cotangent of ``hs``, or
    None), the carried ``dh_acc``, ``dc_acc`` [B, H] (zero at first) and
    ``dh0``."""

    def __init__(self, xproj, w_h, hs, cs, gates):
        self.xproj, self.w_h, self.hs, self.cs, self.gates = xproj, w_h, hs, cs, gates
        self.dgates = self.dh_seq = self.dh_acc = self.dc_acc = self.dh0 = None


def lstm_fwd_plain(dirs, xrow, lengths, t: int, compute_dtype) -> None:
    """Plain twin of one step of ``lstm_fwd``: step t of every direction,
    written into its ``gates[t]``, ``hs[t + 1]``, ``cs[t + 1]``."""
    cd = networks.dtype_name(compute_dtype)
    for k, d in enumerate(dirs):
        p = networks.round_operand(d.hs[t], cd) @ networks.round_operand(d.w_h, cd)
        pre = p + d.xproj[t]
        if k == 0 and xrow is not None:
            pre = pre + xrow
        d.gates[t] = pre
        gi, gj, gf, go = pre.chunk(4, dim=1)
        c = d.cs[t] * torch.sigmoid(gf + 1.0) + torch.sigmoid(gi) * torch.tanh(gj)
        h = torch.tanh(c) * torch.sigmoid(go)
        if lengths is not None:
            active = (lengths > t)[:, None]
            c, h = torch.where(active, c, d.cs[t]), torch.where(active, h, d.hs[t])
        d.cs[t + 1] = c
        d.hs[t + 1] = h


def lstm_bwd_plain(dirs, lengths, t: int, steps: int, compute_dtype) -> None:
    """Plain twin of one step of ``lstm_bwd``: step t (or, at t = −1, dh of
    the initial state) of every direction, from dgates_{t+1}·W_hᵀ summed by
    gate in the kernel's order."""
    cd = networks.dtype_name(compute_dtype)
    for d in dirs:
        h = d.w_h.shape[0]
        dh_in, dc_in = d.dh_acc, d.dc_acc
        dg = d.dgates[t + 1]
        p = 0.0
        for g in range(4):
            p = p + (networks.round_operand(dg[:, g * h:(g + 1) * h], cd)
                     @ networks.round_operand(d.w_h[:, g * h:(g + 1) * h], cd).T)
        nxt = torch.full((p.shape[0], 1), t + 1 < steps, device=p.device)
        if lengths is not None:
            nxt = nxt & (lengths > t + 1)[:, None]
        carry = p + torch.where(nxt, torch.zeros_like(p), dh_in)
        if t < 0:
            d.dh0.copy_(carry)
            continue
        dh = (d.dh_seq[t + 1] if d.dh_seq is not None else 0.0) + carry
        gi, gj, gf, go = d.gates[t].chunk(4, dim=1)
        i, j = torch.sigmoid(gi), torch.tanh(gj)
        f, o = torch.sigmoid(gf + 1.0), torch.sigmoid(go)
        tc = torch.tanh(d.cs[t + 1])
        dc = dc_in + dh * o * (1.0 - tc * tc)
        dg = torch.cat([dc * j * (i * (1.0 - i)), dc * i * (1.0 - j * j),
                        dc * d.cs[t] * (f * (1.0 - f)), dh * tc * (o * (1.0 - o))], dim=1)
        dc_prev = dc * f
        if lengths is not None:
            active = (lengths > t)[:, None]
            dg = torch.where(active, dg, torch.zeros_like(dg))
            dc_prev = torch.where(active, dc_prev, dc_in)
        d.dgates[t] = dg
        d.dc_acc.copy_(dc_prev)
        d.dh_acc.copy_(dh)


def _ptr(t):
    return None if t is None else t.data_ptr()


def _table(dirs, stages) -> ctypes.Array:
    return (_Dir * len(dirs))(*[
        _Dir(_ptr(d.xproj), _ptr(d.w_h), _ptr(d.hs), _ptr(d.cs), _ptr(d.gates), _ptr(d.dgates),
             _ptr(d.dh_seq), _ptr(d.dh_acc), _ptr(d.dc_acc), _ptr(d.dh0), _ptr(st))
        for d, st in zip(dirs, stages)])


def _check_dirs(dirs, xrow, lengths):
    dev = dirs[0].xproj.device
    steps, batch, n = dirs[0].xproj.shape
    h = n // 4
    if n != 4 * h or h % UNITS:
        raise ValueError(f"the LSTM kernels take a hidden width that is a multiple of {UNITS}, "
                         f"got gates of width {n}")
    for d in dirs:
        kmlp._check_f32(d.xproj, dev, "xproj", (steps, batch, n))
        kmlp._check_f32(d.w_h, dev, "w_h", (h, n))
    if xrow is not None:
        kmlp._check_f32(xrow, dev, "xrow", (batch, n))
    if lengths is not None and (lengths.device != dev or lengths.dtype != torch.int32
                                or tuple(lengths.shape) != (batch,)):
        raise ValueError(f"lengths: expected int32 [{batch}] on {dev}")
    return dev, steps, batch, h


def _launch(fwd: bool, dirs, xrow, lengths, t0: int, t1: int, cd: str) -> None:
    """One kernel call over steps [t0, t1), its launches counted. In bf16
    each direction gets a two-slot stage for the next step's operand."""
    dev, steps, batch, h = _check_dirs(dirs, xrow, lengths)
    lib = _build.load()
    bf16 = cd == "bfloat16"
    width = h if fwd else 4 * h
    stages = [torch.empty(2, batch, width, dtype=torch.bfloat16, device=dev) if bf16 else None
              for _ in dirs]
    table = _table(dirs, stages)
    launches = ctypes.c_int(0)
    stream = kmlp._stream(dirs[0].xproj)
    with torch.cuda.device(dev):
        sync = sync_counters(dev).data_ptr()
        if fwd:
            err = lib.vae_lstm_fwd(table, len(dirs), _ptr(xrow), _ptr(lengths), sync,
                                   SYNC_GROUPS, t0, t1, steps, batch, h, int(bf16), stream,
                                   ctypes.byref(launches))
        else:
            err = lib.vae_lstm_bwd(table, len(dirs), _ptr(lengths), sync, SYNC_GROUPS, t0, t1,
                                   steps, batch, h, int(bf16), stream, ctypes.byref(launches))
    name = "lstm_fwd" if fwd else "lstm_bwd"
    _build.check(lib, err, f"{name} kernel launch")
    for _ in range(launches.value):
        _launches.count(_launches.TRAINING, name)


def run_forward(dirs, xrow, lengths, compute_dtype) -> None:
    """Every step of every direction: one ``lstm_fwd`` call on CUDA (the
    greedy decode's step is a one-step layer), the twin a step at a time on
    the CPU. Fills each direction's ``hs``, ``cs`` and ``gates``."""
    cd = networks.dtype_name(compute_dtype)
    steps = dirs[0].xproj.shape[0]
    if dirs[0].xproj.device.type == "cpu":
        for t in range(steps):
            lstm_fwd_plain(dirs, xrow, lengths, t, cd)
        return
    _launch(True, dirs, xrow, lengths, 0, steps, cd)


def run_backward(dirs, lengths, compute_dtype, initial: bool) -> None:
    """Every step of every direction backward, T − 1 down to 0, and with
    ``initial`` the step that gives dh of the initial state: one
    ``lstm_bwd`` call on CUDA, the twin a step at a time on the CPU. Each
    direction's ``dgates``, ``dh_acc``, ``dc_acc`` (zeros, and slot T of
    ``dgates``) and ``dh0`` are given."""
    cd = networks.dtype_name(compute_dtype)
    steps = dirs[0].xproj.shape[0]
    last = -1 if initial else 0
    if dirs[0].xproj.device.type == "cpu":
        for t in range(steps - 1, last - 1, -1):
            lstm_bwd_plain(dirs, lengths, t, steps, cd)
        return
    _launch(False, dirs, None, lengths, last, steps, cd)


def forward_states(xprojs, w_hs, h0s, c0s, xrow=None, lengths=None, compute_dtype="float32"):
    """The layer's forward with no autograd: one :class:`Direction` a
    direction (``hs``, ``cs``, ``gates`` filled) from the hoisted
    products ``xprojs``, weights ``w_hs`` and initial states."""
    dirs = []
    for xp, w, h0, c0 in zip(xprojs, w_hs, h0s, c0s):
        steps, batch, n = xp.shape
        h = n // 4
        hs = torch.empty(steps + 1, batch, h, dtype=torch.float32, device=xp.device)
        cs = torch.empty_like(hs)
        hs[0], cs[0] = h0, c0
        gates = torch.empty(steps, batch, n, dtype=torch.float32, device=xp.device)
        dirs.append(Direction(xp.detach().float().contiguous(), w.detach().contiguous(), hs, cs,
                              gates))
    xrow = None if xrow is None else xrow.detach().float().contiguous()
    run_forward(dirs, xrow, lengths, compute_dtype)
    return dirs


class _LSTM(torch.autograd.Function):
    """Inputs: compute dtype, lengths (or None), xrow (or None), then
    (xproj, w_h, h0, c0) of each direction. Outputs: each direction's ``hs``
    [T + 1, B, H]."""

    @staticmethod
    def forward(ctx, cd, lengths, xrow, *flat):
        n = len(flat) // 4
        dirs = forward_states(flat[0::4], flat[1::4], flat[2::4], flat[3::4], xrow, lengths, cd)
        ctx.cd, ctx.n, ctx.has_xrow = cd, n, xrow is not None
        ctx.save_for_backward(lengths, *(t for d in dirs for t in (d.w_h, d.hs, d.cs, d.gates)))
        return tuple(d.hs for d in dirs)

    @staticmethod
    def backward(ctx, *dhs):
        lengths, *saved = ctx.saved_tensors
        cd, n = ctx.cd, ctx.n
        initial = any(ctx.needs_input_grad[5 + 4 * k] or ctx.needs_input_grad[6 + 4 * k]
                      for k in range(n))
        dirs = []
        for k in range(n):
            w_h, hs, cs, gates = saved[4 * k:4 * k + 4]
            steps, batch, width = gates.shape
            d = Direction(gates, w_h, hs, cs, gates)  # xproj: shapes only, unread
            d.dgates = gates.new_empty(steps + 1, batch, width)
            d.dgates[steps].zero_()
            d.dh_seq = None if dhs[k] is None else dhs[k].float().contiguous()
            d.dh_acc = torch.zeros_like(hs[0])
            d.dc_acc = torch.zeros_like(hs[0])
            d.dh0 = torch.zeros_like(hs[0])
            dirs.append(d)
        run_backward(dirs, lengths, cd, initial)
        grads = []
        for k, d in enumerate(dirs):
            steps, batch, width = d.gates.shape
            dgates = d.dgates[:steps]
            dw = kmlp.weight_grads(d.hs[:steps].reshape(steps * batch, -1),
                                   dgates.reshape(steps * batch, width), compute_dtype=cd)[0]
            dh0 = d.dh0 if d.dh_seq is None else d.dh0 + d.dh_seq[0]
            grads += [dgates, dw, dh0, d.dc_acc]
        dxrow = dirs[0].dgates[:-1].sum(0) if ctx.has_xrow and ctx.needs_input_grad[2] else None
        return (None, None, dxrow, *grads)


def lstm(xprojs, w_hs, h0s, c0s, *, xrow=None, lengths=None, compute_dtype="float32"):
    """One or two directions of an LSTM layer over T steps, differentiable:
    each direction's ``hs`` [T + 1, B, H] (index 0 the initial state) from
    its hoisted input product ``xproj`` [T, B, 4H], ``w_h`` [H, 4H] and
    initial ``h0``, ``c0`` [B, H]. ``xrow`` [B, 4H] is added to the first
    direction's gates at every step; ``lengths`` (int32 [B]) holds a row's
    state from that step on."""
    flat = [t for d in zip(xprojs, w_hs, h0s, c0s) for t in d]
    return _LSTM.apply(networks.dtype_name(compute_dtype), lengths, xrow, *flat)


def linear(x, w, b, compute_dtype="float32"):
    """x·w + b on the dense kernels (the MLP stack kernel with one linear
    layer, ``dec_fwd``; its backward ``dec_bwd`` and ``wgrad``), the plain
    twin on the CPU; differentiable in x, w and b."""
    return kmlp._DecodeFused.apply(networks.dtype_name(compute_dtype), x, w, b)
