"""Fused MLP encoder/decoder stacks: hand-written CUDA kernels and their plain twins.

Counterpart of vae_assoc_tpu/kernels/mlp.py. Each forward wrapper runs a
whole recognition stack (x → h1 → … → hL → μ, logσ²) or generator stack
(z → h1 → … → hL → out) in one launch of ``csrc/mlp_fwd.cu``.
``encode_mlp_fused`` / ``decode_mlp_fused`` keep the signatures of
``networks.encode_mlp`` / ``networks.decode_mlp``; softplus only.

The kernels run on one block-tiled product (``csrc/dense_tile.cuh``): a
block owns 16, 32 or 64 rows and runs the stack's products in turn, each
weight byte it reads serving all its rows (fp32 on register tiles, bf16
on tensor cores), each product's input streamed back from device memory:
the hidden activations go to a workspace that the wrapper allocates per
call. What bounds them is arithmetic on weights read from L2 (bf16: each
block streaming its weight slices); where a small batch leaves SMs idle,
blocks that share a row tile split its column tiles (``dense_parts``).

Both stacks have a gradient: under autograd ``encode_mlp_fused`` and
``decode_mlp_fused`` are ``torch.autograd.Function``s whose backward is the
stack-backward kernel (``csrc/mlp_bwd.cu``, launched as ``enc_bwd``,
replacing the Pallas ``_enc_bwd_kernel``, or as ``dec_bwd``, replacing
``_dec_bwd_kernel``) followed by the weight-gradient kernel
``weight_grads``; the tower megakernel's backward uses the encoder's
(kernels/megakernel.py). The stack backward computes the input gradient
only when a caller reads it (``want_dx``): the training paths' data needs
none.

Dispatch is by the device of the input, and only by it: a CPU tensor goes
to the plain twin in this module (the CPU tests' path); a CUDA tensor
launches the kernel or raises. There is no capacity gate that falls back:
every operand streams from device memory, so no width bounds a tile.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from vae_assoc_tpu_torch.kernels import _build, _launches
from vae_assoc_tpu_torch.models import networks

LAUNCHES = _launches.SERVING
"""Kernel launches per forward wrapper since the last reset_launches(); each
wrapper adds one where it launches its kernel, and nowhere else. The
training kernels count in ``_launches.TRAINING``."""

_tables: dict = {}

SMEM_BYTES = 232448
"""Dynamic shared memory a block may opt into on Hopper (227 KB)."""


def reset_launches() -> None:
    """Set every kernel's launch count (serving and training) to zero."""
    _launches.reset()


def _count(name: str) -> None:
    _launches.count(LAUNCHES, name)


def encode_mlp_plain(params, x, *, compute_dtype="float32"):
    """Plain torch twin of the encoder kernel: the same math, unfused."""
    return networks.encode_mlp(
        params, x, compute_dtype=compute_dtype, transfer=networks.softplus
    )


def decode_mlp_plain(params, z, *, compute_dtype="float32"):
    """Plain torch twin of the decoder kernel: the same math, unfused."""
    return networks.decode_mlp(
        params, z, compute_dtype=compute_dtype, transfer=networks.softplus
    )


def _layer_table(layers, device) -> torch.Tensor:
    """Device-side [n_layers, 4] int64 table (w ptr, b ptr, n_in, n_out).

    Cached by content: the key is exactly what the table holds, so a hit is
    always the table a rebuild would give."""
    rows = tuple(
        (l.w.data_ptr(), l.b.data_ptr(), l.w.shape[0], l.w.shape[1])
        for l in layers
    )
    key = (device, rows)
    table = _tables.get(key)
    if table is None:
        if len(_tables) > 256:
            _tables.clear()
        table = torch.tensor(rows, dtype=torch.int64, device=device)
        _tables[key] = table
    return table


def device_tables() -> list:
    """Every weight table built so far (``_layer_table``): a CUDA graph
    whose launches read them holds them, so that they outlive a clear of
    the cache."""
    return list(_tables.values())


def _check_stack(x, hidden, heads):
    """Validate device, dtype, contiguity and the width chain of a stack."""
    n_in = x.shape[1]  # the heads chain from the last hidden width, or from x's
    for i, l in enumerate(hidden + heads):
        for name, t in (("w", l.w), ("b", l.b)):
            if t.device != x.device or t.dtype != torch.float32:
                raise ValueError(
                    f"layer {i} {name}: expected float32 on {x.device}, got "
                    f"{t.dtype} on {t.device}"
                )
            if not t.is_contiguous():
                raise ValueError(f"layer {i} {name} is not contiguous")
        if l.w.ndim != 2 or l.w.shape[0] != n_in or l.b.shape != (l.w.shape[1],):
            raise ValueError(
                f"layer {i}: w {tuple(l.w.shape)} / b {tuple(l.b.shape)} do "
                f"not chain from width {n_in}"
            )
        if i < len(hidden):
            n_in = l.w.shape[1]


def _launch(name, x, hidden, heads, compute_dtype):
    """Launch csrc/mlp_fwd.cu on one stack; returns the head outputs."""
    if x.device.type != "cuda":
        raise ValueError(f"the fused MLP kernel runs on CUDA, got {x.device}")
    cd = networks.dtype_name(compute_dtype)
    x = x.float().contiguous()
    if x.ndim != 2:
        raise ValueError(f"expected a [batch, features] input, got {tuple(x.shape)}")
    _check_stack(x, hidden, heads)
    batch = x.shape[0]
    outs = [
        torch.empty(batch, h.w.shape[1], dtype=torch.float32, device=x.device)
        for h in heads
    ]
    if batch == 0:
        return outs
    lib = _build.load()
    rows, smem, parts = stack_fwd_plan(tuple(l.w.shape[1] for l in hidden + heads), batch,
                                       sm_count(x.device), cd)
    ldh = _pad4(max(l.w.shape[1] for l in hidden)) if hidden else 0
    ws = torch.empty(min(len(hidden), 2), batch, ldh, dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        table = _layer_table(hidden + heads, x.device)
        err = lib.vae_mlp_stack_fwd(
            x.data_ptr(), batch, x.shape[1], table.data_ptr(),
            len(hidden), len(heads), outs[0].data_ptr(),
            outs[1].data_ptr() if len(outs) > 1 else None,
            ws.data_ptr() if hidden else None, ldh, rows, smem, parts,
            int(cd == "bfloat16"), _stream(x),
        )
    _build.check(lib, err, f"{name} kernel launch")
    _count(name)
    return outs


def _grad_needed(params, x) -> bool:
    return torch.is_grad_enabled() and (
        x.requires_grad or any(p.requires_grad for p in params.parameters())
    )


def encode_mlp_fused(params, x, *, compute_dtype="float32", transfer=None):
    """Drop-in for `networks.encode_mlp`, fused on the GPU. softplus only.

    x [B, n_in] → (z_mean, z_logvar), fp32 [B, n_z]. Under autograd the
    backward is the encoder-backward kernel (or its plain twin on the CPU)."""
    r = params.recog
    if _grad_needed(params, x):
        layers = networks.hidden_layers(r) + [r["out_mean"], r["out_logvar"]]
        flat = [t for l in layers for t in (l.w, l.b)]
        return _EncodeFused.apply(networks.dtype_name(compute_dtype), x, *flat)
    if x.device.type == "cpu":
        return encode_mlp_plain(params, x, compute_dtype=compute_dtype)
    mu, lv = _launch(
        "enc_fwd", x, networks.hidden_layers(r),
        [r["out_mean"], r["out_logvar"]], compute_dtype,
    )
    return mu, lv


def decode_mlp_fused(params, z, *, compute_dtype="float32", transfer=None):
    """Drop-in for `networks.decode_mlp`, fused on the GPU. softplus only.

    z [B, n_z(+n_cond)] → decoder output before its activation, fp32
    [B, n_input]. Under autograd the backward is the decoder-backward
    kernel (or its plain twin on the CPU)."""
    g = params.gener
    if _grad_needed(params, z):
        layers = networks.hidden_layers(g) + [g["out"]]
        flat = [t for l in layers for t in (l.w, l.b)]
        return _DecodeFused.apply(networks.dtype_name(compute_dtype), z, *flat)
    if z.device.type == "cpu":
        return decode_mlp_plain(params, z, compute_dtype=compute_dtype)
    (out,) = _launch(
        "dec_fwd", z, networks.hidden_layers(g), [g["out"]], compute_dtype
    )
    return out


# ---------------------------------------------------------------------------
# Backward: the encoder and decoder stacks (Pallas _enc_bwd_kernel,
# _dec_bwd_kernel) and the weight grads.
# ---------------------------------------------------------------------------


class _Layer:
    """A (w, b) pair of tensors with the attribute names of networks.Linear."""

    __slots__ = ("w", "b")

    def __init__(self, w, b):
        self.w, self.b = w, b


def _pairs(flat) -> list:
    return [_Layer(flat[i], flat[i + 1]) for i in range(0, len(flat), 2)]


class _EncodeFused(torch.autograd.Function):
    """The encoder stack with the backward of the Pallas ``_encode_fused``
    custom VJP. Inputs: compute dtype, x, then (w, b) of every hidden layer,
    out_mean and out_logvar."""

    @staticmethod
    def forward(ctx, cd, x, *flat):
        layers = _pairs(flat)
        if x.device.type == "cpu":
            h = x
            for l in layers[:-2]:
                h = networks.softplus(networks.linear(l, h, cd))
            mu, lv = (networks.linear(l, h, cd) for l in layers[-2:])
        else:
            mu, lv = _launch("enc_fwd", x, layers[:-2], layers[-2:], cd)
        ctx.cd = cd
        ctx.save_for_backward(x, *flat)
        return mu, lv

    @staticmethod
    def backward(ctx, dmu, dlv):
        x, *flat = ctx.saved_tensors
        layers = _pairs(flat)
        grads, dx = encode_bwd(layers[:-2], layers[-2:], x, dmu, dlv,
                               compute_dtype=ctx.cd, want_dx=ctx.needs_input_grad[1])
        return (None, dx, *(g for pair in grads for g in pair))


class _DecodeFused(torch.autograd.Function):
    """The decoder stack with the backward of the Pallas ``_decode_fused``
    custom VJP. Inputs: compute dtype, z, then (w, b) of every hidden layer
    and of the output layer."""

    @staticmethod
    def forward(ctx, cd, z, *flat):
        layers = _pairs(flat)
        if z.device.type == "cpu":
            h = z
            for l in layers[:-1]:
                h = networks.softplus(networks.linear(l, h, cd))
            out = networks.linear(layers[-1], h, cd)
        else:
            (out,) = _launch("dec_fwd", z, layers[:-1], layers[-1:], cd)
        ctx.cd = cd
        ctx.save_for_backward(z, *flat)
        return out

    @staticmethod
    def backward(ctx, dout):
        z, *flat = ctx.saved_tensors
        layers = _pairs(flat)
        grads, dz = decode_bwd(layers[:-1], layers[-1], z, dout, compute_dtype=ctx.cd,
                               want_dx=ctx.needs_input_grad[1])
        return (None, dz, *(g for pair in grads for g in pair))


def _stack_bwd(hidden, heads, x, cts, cd, want_dx, dsoftplus):
    """The stack backward's explicit formulas (see encode_bwd_plain) for one
    or two heads with cotangents ``cts``; ``dsoftplus(pre, post)`` is
    softplus'(pre) = σ(pre), from the pre- or the post-activation. The input
    gradient is None unless ``want_dx``."""

    def mm(a, b):
        return networks.round_operand(a, cd) @ networks.round_operand(b, cd)

    hw = [(l.w.detach(), l.b.detach()) for l in hidden]
    x = x.detach().float()
    cts = [c.float() for c in cts]
    acts, pres = [x], []
    for w, b in hw:
        a = mm(acts[-1], w) + b
        pres.append(a)
        acts.append(networks.softplus(a))
    grads = [None] * len(hw) + [(mm(acts[-1].T, c), c.sum(0)) for c in cts]
    if not (hw or want_dx):
        return grads, None
    dh = mm(cts[0], heads[0].w.detach().T)
    for c, h in zip(cts[1:], heads[1:]):
        dh = dh + mm(c, h.w.detach().T)
    for i in reversed(range(len(hw))):
        da = dh * dsoftplus(pres[i], acts[i + 1])
        grads[i] = (mm(acts[i].T, da), da.sum(0))
        dh = mm(da, hw[i][0].T) if i or want_dx else None
    return grads, dh


def _sigmoid_of_pre(pre, post):
    return torch.sigmoid(pre)


def encode_bwd_plain(hidden, heads, x, dmu, dlv, *, compute_dtype="float32", want_dx=True):
    """Plain twin of the encoder-backward kernel and its weight grads.

    ``hidden``: the hidden layers and ``heads``: (out_mean, out_logvar), each
    with ``w`` [in, out] and ``b``; x [B, n_in]; dmu, dlv [B, n_z]. Returns
    ([(dw, db) per hidden layer, then out_mean, out_logvar], dx), dx None
    unless ``want_dx``. Written as the reference kernel's explicit formulas,
    with each operand of each product rounded under the bf16 policy
    (mlp.py::_enc_bwd_kernel, _mm_nt, _mm_tn): autograd of the forward twin
    would round each product's result instead."""
    return _stack_bwd(hidden, heads, x, [dmu, dlv], networks.dtype_name(compute_dtype),
                      want_dx, _sigmoid_of_pre)


def decode_bwd_plain(hidden, head, z, dout, *, compute_dtype="float32", want_dx=True):
    """Plain twin of the decoder-backward kernel and its weight grads.

    ``hidden``: the hidden layers and ``head``: the output layer; z
    [B, n_z(+n_cond)] the decoder input; dout [B, n_out]. Returns
    ([(dw, db) per hidden layer, then the output layer], dz), dz None
    unless ``want_dx``. Explicit formulas with the operand rounding of
    :func:`encode_bwd_plain` (mlp.py::_dec_bwd_kernel)."""
    return _stack_bwd(hidden, [head], z, [dout], networks.dtype_name(compute_dtype),
                      want_dx, _sigmoid_of_pre)


def stack_bwd_mirror(hidden, heads, x, cts, *, compute_dtype="float32", want_dx=True):
    """The stack-backward kernel's arithmetic in plain torch, for the
    encoder (``heads`` = (out_mean, out_logvar), ``cts`` = (dμ, dlogσ²)) or
    the decoder (the output layer and its cotangent): the twins' formulas
    with σ(pre) recovered from the saved post-activation h as −expm1(−h),
    as csrc/mlp_bwd.cu does (it keeps no pre-activation). Result as
    :func:`encode_bwd_plain`."""
    return _stack_bwd(hidden, list(heads), x, list(cts), networks.dtype_name(compute_dtype),
                      want_dx, lambda pre, post: -torch.expm1(-post))


def weight_grads_plain(a, d, *, compute_dtype="float32"):
    """Plain twin of the weight-gradient kernel: (round(a)ᵀ·round(d), Σ_rows d)."""
    cd = networks.dtype_name(compute_dtype)
    return (networks.round_operand(a, cd).T @ networks.round_operand(d, cd),
            d.sum(0))


DENSE_N, DENSE_STAGES = 128, 3
"""The megakernels' block-tiled product (csrc/dense_tile.cuh): output
columns per tile, slices in its cp.async ring."""
DENSE_ROWS = (16, 32, 64)
"""Rows per block it takes: multiples of the mma m16."""


def dense_ring_bytes(rows: int, trans: bool, stream: bool, bf16: bool) -> int:
    """Shared memory of the product's ring (dense_tile.cuh::dense_ring_bytes):
    3 stages, each a weight slice of kd × 128 fp32 (rows of 132; with
    ``trans`` 128 × kd, rows of kd + 4) and, with A streamed (``stream``), an
    A slice of ``rows`` × kd (rows of kd + 4), kd = 32 at 64 rows and 64
    below; in bf16 also two rounded slices (rows of 136 or kd + 8)."""
    kd = 32 if rows == 64 else 64
    w = DENSE_N * (kd + 4) if trans else kd * (DENSE_N + 4)
    a = rows * (kd + 4) if stream else 0
    wh = DENSE_N * (kd + 8) if trans else kd * (DENSE_N + 8)
    ah = rows * (kd + 8) if stream else 0
    return 4 * DENSE_STAGES * (w + a) + (2 * 2 * (wh + ah) if bf16 else 0)


def dense_tile_rows(batch: int, n_sm: int) -> int:
    """Rows per block of a kernel built on the block-tiled product: the
    fewest of :data:`DENSE_ROWS` that keep the batch within one block per
    SM, else the most (each weight byte a block reads serves all its rows,
    and a small batch still spreads over the SMs). Raises on an empty
    batch."""
    if batch < 1:
        raise ValueError(f"a tile plan needs a batch of at least one row, got {batch}")
    return next((r for r in DENSE_ROWS if r * n_sm >= batch), DENSE_ROWS[-1])


def dense_parts(batch: int, rows: int, n_sm: int, most: int = 2) -> int:
    """Blocks that share each row tile of a kernel built on the block-tiled
    product (a cluster, each taking every parts-th column tile of every
    product), so that where 16-row tiles leave SMs idle more blocks stream a
    share of the weights each: the most of 2, 4 and 8 up to ``most`` that
    keep the blocks within the SMs (2) or within half of them (4 and 8: a
    cluster must fit within one GPC, a group of SMs, so past half the SMs
    clusters of 4 or 8 may not all run at once); 1 at 32 and 64 rows."""
    tiles = -(-batch // rows)
    fits = [p for p in (2, 4, 8) if p <= most and p * tiles <= (n_sm if p == 2 else n_sm // 2)]
    return fits[-1] if rows == 16 and fits else 1


def _pad4(n: int) -> int:
    return -(-n // 4) * 4


@functools.lru_cache(maxsize=256)
def stack_fwd_plan(widths: tuple, batch: int, n_sm: int, compute_dtype="float32"):
    """(rows per block, dynamic shared memory in bytes, blocks per row tile)
    for the stack-forward kernel (``enc_fwd`` and ``dec_fwd``) over products
    of ``widths`` output columns (cached: every serving request plans);
    csrc/mlp_fwd.cu computes the same bytes
    and refuses a launch that disagrees. Rows: 16, 32 or 64 from the batch
    (:func:`dense_tile_rows`); shared memory: the ring of its one product
    mode, W as stored with A streamed; blocks: :func:`dense_parts`, up to
    the widest product's column tiles rounded up to a power of two (the
    serving buckets 1 to 256 are latency-bound: each block streams a share
    of the weights). Every row's operands stream from device memory, so no
    width bounds the tile. Raises on an empty batch."""
    rows = dense_tile_rows(batch, n_sm)
    bf16 = networks.dtype_name(compute_dtype) == "bfloat16"
    most = 1 << (-(-max(widths) // DENSE_N) - 1).bit_length()
    return (rows, dense_ring_bytes(rows, False, True, bf16),
            dense_parts(batch, rows, n_sm, most))


ENC_BWD_MAX_HIDDEN = 16
"""Hidden layers the stack-backward kernel's by-value layer table holds
(``kMaxHidden`` in csrc/mlp_bwd.cu), for the encoder and the decoder."""


def stack_bwd_plan(hidden_widths, batch: int, n_sm: int, compute_dtype="float32"):
    """(rows per block, dynamic shared memory in bytes, blocks per row tile)
    for the stack-backward kernel (the encoder's and the decoder's);
    csrc/mlp_bwd.cu computes the same bytes and refuses a launch that
    disagrees. Rows: 16, 32 or 64 from the batch (:func:`dense_tile_rows`);
    shared memory: the ring of its largest product, Wᵀ with A streamed;
    blocks: :func:`dense_parts`. Every row's operands stream from device
    memory, so no width bounds the tile. Raises on an empty batch and
    past ``ENC_BWD_MAX_HIDDEN`` hidden layers (none is a linear layer:
    the kernel computes only its dx)."""
    if not 0 <= len(hidden_widths) <= ENC_BWD_MAX_HIDDEN:
        raise ValueError(
            f"the stack-backward kernel takes 0 to {ENC_BWD_MAX_HIDDEN} hidden layers, "
            f"got {len(hidden_widths)}"
        )
    rows = dense_tile_rows(batch, n_sm)
    bf16 = networks.dtype_name(compute_dtype) == "bfloat16"
    return rows, dense_ring_bytes(rows, True, True, bf16), dense_parts(batch, rows, n_sm)

WGRAD_TILE = 128
WGRAD_SLICE = 32
WGRAD_MIN_ROWS = 512


@functools.lru_cache(maxsize=256)
def wgrad_plan(batch: int, m: int, n: int, n_sm: int):
    """(rows_per_chunk, chunks) for dW = Aᵀ·D with A [batch, m], D [batch, n].

    The kernel has one block per 128×128 tile of dW (the blocks of the
    first row of tiles also sum db) and holds one block per SM. The rows
    split into chunks of at least ``WGRAD_MIN_ROWS`` (a multiple of the
    32-row slice) whose partial tiles a second launch adds in order; the
    chunk count minimizes the rows a block walks times the waves of
    ``n_sm`` blocks (a partial wave costs a whole one), the fewest chunks
    among equals."""
    tiles = -(-m // WGRAD_TILE) * -(-n // WGRAD_TILE)
    best = None
    for chunks in range(1, max(1, batch // WGRAD_MIN_ROWS) + 1):
        rows = -(-batch // chunks)
        rows = -(-rows // WGRAD_SLICE) * WGRAD_SLICE
        cost = -(-tiles * chunks // n_sm) * rows
        if best is None or cost < best[0]:
            best = (cost, rows)
    rows = best[1]
    return rows, -(-batch // rows)


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


_sm_counts: dict = {}


def sm_count(device) -> int:
    """Streaming multiprocessors of a CUDA device, queried once per device
    and process (every kernel wrapper's tile plans read it)."""
    index = torch.device(device).index
    if index is None:
        index = torch.cuda.current_device()
    n = _sm_counts.get(index)
    if n is None:
        n = _sm_counts[index] = torch.cuda.get_device_properties(index).multi_processor_count
    return n


def _check_f32(t: torch.Tensor, device, name: str, shape=None):
    if t.device != device or t.dtype != torch.float32 or not t.is_contiguous():
        raise ValueError(
            f"{name}: expected a contiguous float32 tensor on {device}, got "
            f"{t.dtype} on {t.device}"
        )
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")


def weight_grads(a, d, *, compute_dtype="float32"):
    """(dW, db) = (Aᵀ·D, Σ_rows D) summed over every row of A [B, M] and
    D [B, N]: the weight-gradient kernel on a CUDA tensor, its twin on the
    CPU. Deterministic: each output is added in a fixed row order."""
    cd = networks.dtype_name(compute_dtype)
    if a.device.type == "cpu":
        return weight_grads_plain(a, d, compute_dtype=cd)
    if a.device.type != "cuda":
        raise ValueError(f"the weight-gradient kernel runs on CUDA, got {a.device}")
    batch, m = a.shape
    n = d.shape[1]
    _check_f32(a, a.device, "A")
    _check_f32(d, a.device, "D", (batch, n))
    dw = torch.empty(m, n, dtype=torch.float32, device=a.device)
    db = torch.empty(n, dtype=torch.float32, device=a.device)
    if batch == 0:
        return dw.zero_(), db.zero_()
    lib = _build.load()
    n_sm = sm_count(a.device)
    rows, chunks = wgrad_plan(batch, m, n, n_sm)
    partial = (torch.empty(chunks * (m + 1) * n, dtype=torch.float32, device=a.device)
               if chunks > 1 else None)
    with torch.cuda.device(a.device):
        err = lib.vae_wgrad(
            a.data_ptr(), m, d.data_ptr(), n, batch, m, n, rows, chunks,
            dw.data_ptr(), db.data_ptr(),
            partial.data_ptr() if partial is not None else None,
            int(cd == "bfloat16"), _stream(a),
        )
    _build.check(lib, err, "weight-gradient kernel launch")
    _launches.count(_launches.TRAINING, "wgrad")
    return dw, db


def _stack_bwd_kernel(name, hidden, heads, x, cts, cd, want_dx=True):
    """The stack-backward kernel alone (the encoder's two heads or the
    decoder's one): (dx, or None unless ``want_dx``, and the weight grads'
    (A, D) operand pairs from its scratch: (the input of hidden layer i,
    da_i) per layer, then (h_L, the cotangent) per head, h_0 being x)."""
    dev = x.device
    x = x.detach().float().contiguous()
    cts = [t.detach().float().contiguous() for t in cts]
    batch, n_in = x.shape
    n_g = heads[0].w.shape[1]
    _check_f32(x, dev, "x")
    for i, t in enumerate(cts):
        _check_f32(t, dev, f"head cotangent {i}", (batch, n_g))
    _check_stack(x, hidden, heads)
    widths = [l.w.shape[1] for l in hidden]
    acts = [torch.empty(batch, w, dtype=torch.float32, device=dev) for w in widths]
    das = [torch.empty(batch, w, dtype=torch.float32, device=dev) for w in widths]
    dx = torch.empty(batch, n_in, dtype=torch.float32, device=dev) if want_dx else None
    # With no hidden layer and no dx there is nothing per row to compute:
    # the weight grads read x and the cotangent as they are.
    if batch and (hidden or want_dx):
        lib = _build.load()
        rows, smem, parts = stack_bwd_plan(widths, batch, sm_count(dev), cd)
        table = (ctypes.c_longlong * (6 * len(hidden)))(*[
            v for l, a, d in zip(hidden, acts, das)
            for v in (l.w.data_ptr(), l.b.data_ptr(), a.data_ptr(), d.data_ptr(),
                      l.w.shape[0], l.w.shape[1])])
        dx_ptr = dx.data_ptr() if dx is not None else None
        bf16 = int(cd == "bfloat16")
        with torch.cuda.device(dev):
            if len(heads) == 2:
                err = lib.vae_mlp_enc_bwd(
                    x.data_ptr(), batch, n_in, table, len(hidden), heads[0].w.data_ptr(),
                    heads[1].w.data_ptr(), n_g, cts[0].data_ptr(), cts[1].data_ptr(), dx_ptr,
                    rows, smem, parts, bf16, _stream(x),
                )
            else:
                err = lib.vae_mlp_dec_bwd(
                    x.data_ptr(), batch, n_in, table, len(hidden), heads[0].w.data_ptr(),
                    n_g, cts[0].data_ptr(), dx_ptr, rows, smem, parts, bf16, _stream(x),
                )
        _build.check(lib, err, f"{name} kernel launch")
        _launches.count(_launches.TRAINING, "enc_bwd" if len(heads) == 2 else "dec_bwd")
    top = acts[-1] if acts else x
    pairs = list(zip([x] + acts[:-1], das)) + [(top, c) for c in cts]
    return dx, pairs


def _launch_stack_bwd(name, hidden, heads, x, cts, cd, want_dx):
    """The stack-backward kernel and the weight-gradient kernel; returns
    (grads, dx)."""
    dx, pairs = _stack_bwd_kernel(name, hidden, heads, x, cts, cd, want_dx)
    return [weight_grads(a, d, compute_dtype=cd) for a, d in pairs], dx


def encode_bwd(hidden, heads, x, dmu, dlv, *, compute_dtype="float32", want_dx=True):
    """Encoder-stack backward: the kernel on a CUDA tensor, its twin on the
    CPU. Arguments and result as :func:`encode_bwd_plain`; without
    ``want_dx`` the kernel skips the input gradient's product."""
    cd = networks.dtype_name(compute_dtype)
    if x.device.type == "cpu":
        return encode_bwd_plain(hidden, heads, x, dmu, dlv, compute_dtype=cd, want_dx=want_dx)
    if x.device.type != "cuda":
        raise ValueError(f"the encoder-backward kernel runs on CUDA, got {x.device}")
    return _launch_stack_bwd("encoder-backward", hidden, heads, x, [dmu, dlv], cd, want_dx)


def decode_bwd(hidden, head, z, dout, *, compute_dtype="float32", want_dx=True):
    """Decoder-stack backward: the kernel on a CUDA tensor, its twin on the
    CPU. Arguments and result as :func:`decode_bwd_plain`; without
    ``want_dx`` the kernel skips dz's product."""
    cd = networks.dtype_name(compute_dtype)
    if z.device.type == "cpu":
        return decode_bwd_plain(hidden, head, z, dout, compute_dtype=cd, want_dx=want_dx)
    if z.device.type != "cuda":
        raise ValueError(f"the decoder-backward kernel runs on CUDA, got {z.device}")
    return _launch_stack_bwd("decoder-backward", hidden, [head], z, [dout], cd, want_dx)
