"""Fused MLP encoder/decoder stacks: hand-written CUDA kernels and their plain twins.

Counterpart of the forward half of vae_assoc_tpu/kernels/mlp.py. Each
wrapper runs a whole recognition stack (x → h1 → … → hL → μ, logσ²) or
generator stack (z → h1 → … → hL → out) in one launch of
``csrc/mlp_fwd.cu``, with the hidden activations kept in shared memory.
``encode_mlp_fused`` / ``decode_mlp_fused`` keep the signatures of
``networks.encode_mlp`` / ``networks.decode_mlp``; softplus only.

Dispatch is by the device of the input, and only by it: a CPU tensor goes
to the plain twin in this module (the CPU tests' path); a CUDA tensor
launches the kernel or raises. There is no capacity gate that falls back:
the tile height adapts down to one row, and a width beyond even that raises.
"""

from __future__ import annotations

import threading

import torch

from vae_assoc_tpu_torch.kernels import _build
from vae_assoc_tpu_torch.models import networks

LAUNCHES = {"enc_fwd": 0, "dec_fwd": 0}
"""Kernel launches per wrapper since the last reset_launches(); each wrapper
adds one where it launches its kernel, and nowhere else."""

_launch_lock = threading.Lock()
_tables: dict = {}

SMEM_BYTES = 232448
"""Dynamic shared memory a block may opt into on Hopper (227 KB)."""

MAX_TILE_ROWS = 32


def reset_launches() -> None:
    with _launch_lock:
        for k in LAUNCHES:
            LAUNCHES[k] = 0


def _count(name: str) -> None:
    with _launch_lock:
        LAUNCHES[name] += 1


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


def tile_plan(n_in: int, hidden_widths, batch: int, n_sm: int):
    """(tile_rows, stride) for one stack launch.

    ``stride`` is the shared-memory row length: the widest on-chip layer
    (the input or a hidden layer; heads go straight to device memory),
    padded to a multiple of 4 for 16-byte reads. ``tile_rows`` is the
    largest power of two ≤ 32 whose two ping-pong buffers fit
    ``SMEM_BYTES``, lowered further so that a small batch still spreads
    over ``n_sm`` blocks."""
    stride = -(-max(n_in, *hidden_widths) // 4) * 4
    cap = MAX_TILE_ROWS
    while cap > 1 and 2 * cap * stride * 4 > SMEM_BYTES:
        cap //= 2
    if 2 * cap * stride * 4 > SMEM_BYTES:
        raise ValueError(
            f"layer width {stride} exceeds the fused MLP kernel's shared "
            f"memory even at one row per block ({SMEM_BYTES} bytes)"
        )
    want = 1
    while want * n_sm < batch and want < cap:
        want *= 2
    return min(cap, want), stride


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


def _check_stack(x, hidden, heads):
    """Validate device, dtype, contiguity and the width chain of a stack."""
    prev = x.shape[1]
    for i, l in enumerate(hidden + heads):
        for name, t in (("w", l.w), ("b", l.b)):
            if t.device != x.device or t.dtype != torch.float32:
                raise ValueError(
                    f"layer {i} {name}: expected float32 on {x.device}, got "
                    f"{t.dtype} on {t.device}"
                )
            if not t.is_contiguous():
                raise ValueError(f"layer {i} {name} is not contiguous")
        n_in = prev if i < len(hidden) else hidden[-1].w.shape[1]
        if l.w.ndim != 2 or l.w.shape[0] != n_in or l.b.shape != (l.w.shape[1],):
            raise ValueError(
                f"layer {i}: w {tuple(l.w.shape)} / b {tuple(l.b.shape)} do "
                f"not chain from width {n_in}"
            )
        if i < len(hidden):
            prev = l.w.shape[1]


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
    n_sm = torch.cuda.get_device_properties(x.device).multi_processor_count
    tile, stride = tile_plan(
        x.shape[1], [l.w.shape[1] for l in hidden], batch, n_sm
    )
    with torch.cuda.device(x.device):
        table = _layer_table(hidden + heads, x.device)
        err = lib.vae_mlp_stack_fwd(
            x.data_ptr(), batch, x.shape[1], table.data_ptr(),
            len(hidden), len(heads), outs[0].data_ptr(),
            outs[1].data_ptr() if len(outs) > 1 else None,
            stride, tile, int(cd == "bfloat16"),
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    _build.check(lib, err, f"{name} kernel launch")
    _count(name)
    return outs


def encode_mlp_fused(params, x, *, compute_dtype="float32", transfer=None):
    """Drop-in for `networks.encode_mlp`, fused on the GPU. softplus only.

    x [B, n_in] → (z_mean, z_logvar), fp32 [B, n_z]."""
    if x.device.type == "cpu":
        return encode_mlp_plain(params, x, compute_dtype=compute_dtype)
    r = params.recog
    mu, lv = _launch(
        "enc_fwd", x, networks.hidden_layers(r),
        [r["out_mean"], r["out_logvar"]], compute_dtype,
    )
    return mu, lv


def decode_mlp_fused(params, z, *, compute_dtype="float32", transfer=None):
    """Drop-in for `networks.decode_mlp`, fused on the GPU. softplus only.

    z [B, n_z] → decoder output before its activation, fp32 [B, n_input]."""
    if z.device.type == "cpu":
        return decode_mlp_plain(params, z, compute_dtype=compute_dtype)
    g = params.gener
    (out,) = _launch(
        "dec_fwd", z, networks.hidden_layers(g), [g["out"]], compute_dtype
    )
    return out
