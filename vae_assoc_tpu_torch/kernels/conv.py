"""The conv tower's linear primitive and its weight gradient: hand-written CUDA kernels and their plain twins.

Counterpart of vae_assoc_tpu/kernels/conv.py (the im2col kernels) and of
vae_assoc_tpu/kernels/conv_banded.py (the banded kernels), which compute the
same two layer functions. One kernel backs both: the banded formulation's
band matrices and row-parity plans exist for the TPU's 128-lane layout,
which Hopper does not have, so it is not ported as a module.

    conv_fwd(x, w2d; stride, dilate, pads, out_hw)   csrc/conv.cu
      stride 2, no dilation, pads (0, 1)  the SAME stride-2 conv
      stride 1, dilated ×2, pads (2, 1)   the SAME stride-2 transposed conv
                                          (kernel not flipped)
    conv_dw(x, dy; same geometry)         csrc/conv.cu::conv_dw

``conv_fwd`` runs a phase plan (:func:`phase_plan`): the output pixels split
into parity classes, each a dense conv of the undilated input over only the
taps that meet nonzero input (the sub-pixel split of a dilated conv: 9 tap
products per 4 output pixels instead of 36; a stride-2 conv is one class of
9 taps); the kernel's blockIdx.y picks the class. :func:`conv_phase_plain`
runs the same plan in torch, and :func:`fwd_tile_plan` picks the kernel's
route (register-tiled fp32, bf16 tensor cores, or the thin layers' lane
groups and tap loads).

``conv_dw`` runs the same plan with its taps rewritten per pixel of the
layer's undilated side (:func:`dw_taps`: dy of the stride-2 conv, x of the
transposed conv), where each tap meets the other side at 2·pixel + an
offset: dW is then one product over those pixels, [9·32 gathered values]ᵀ
× [the pixel's channels], with no dilation zeros (:func:`dw_route`: fp32
register tiles or bf16 tensor cores for conv2 and convt1; a byte-bound
thin route for conv1 and convt2). :func:`conv_dw_phase_plain` runs it in
torch; :func:`dw_plan` splits the pixels into chunks whose partials a
second launch adds in order.

``conv3x3_s2`` and ``convt3x3_s2`` call one ``torch.autograd.Function``
(the reference's ``_conv_im2col`` custom VJP) whose backward is the kernels
again: dx is ``conv_fwd`` on the flipped, channel-transposed weight with the
mapped stride and pads, computed only when the input asks for a gradient
(conv1's input is the data, so its dx is never launched), and dw is
``conv_dw``. Bias add and activation stay in torch. ``encode_conv_fused`` /
``decode_conv_fused`` are the tower (models/conv.make_conv_tower) over these
ops; models/vae.py routes ``encoder="conv_pallas"`` here whatever
``use_pallas`` says, as the reference does.

Dispatch is by the device of the input, and only by it: a CPU tensor goes to
the plain twins in this module (the CPU tests' path); a CUDA tensor launches
the kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools
import itertools
from typing import NamedTuple

import torch

from vae_assoc_tpu_torch.kernels import _build, _launches
from vae_assoc_tpu_torch.kernels import mlp as kmlp
from vae_assoc_tpu_torch.models import conv as conv_mod
from vae_assoc_tpu_torch.models import networks

K = conv_mod.K
MAX_COUT = 64
"""Output channels the kernels take (``kMaxCout`` in csrc/conv.cu)."""
ROUTES = ("taps", "dot", "ffma", "mma")
"""conv_fwd's routes (``Route`` in csrc/conv.cu)."""
STAGE_K = 32
"""Patch columns per staged slice of the tiled routes (``kStageK``)."""
FFMA_TILE, MMA_TILE, DOT_TILE, TAPS_PIX = 256, 128, 128, 2
"""Output pixels per block tile of the fp32, bf16 and cout = 1 routes;
pixels per thread of the taps route."""
FWD_THREADS = 256
MAX_CLASSES = 4
PLAN_BYTES = 4 * (4 + 5 * MAX_CLASSES + 3 * K * K)
"""The plan as the kernel keeps it in shared memory (``PhasePlan``)."""
DW_ROUTES = ("ffma", "mma", "thin")
"""conv_dw's routes (``DwRoute`` in csrc/conv.cu)."""
DW_SLICE, DW_STAGES = 32, 3
"""Pixels per staged slice and slices in the cp.async ring of conv_dw's
tiled routes (``kDwSlice``, ``kDwStages``)."""
DW_GATHERED = 32
"""Channels of the gathered side on conv_dw's tiled routes (``kDwG``)."""
DW_WAVES = {"ffma": 2, "mma": 2, "thin": 4}
"""Chunks per SM that conv_dw's plan aims at, per route."""
DW_MIN_PIXELS = 16 * DW_SLICE
"""The fewest pixels a conv_dw chunk takes."""

# The input gradient of each layer geometry: (stride, dilate, pads) of the
# forward → those of the conv that computes dx from dy (the reference's
# _conv_vjp_bwd). s2 conv: dx(i) = Σ_k wf[k]·dyd(i − 2 + k), a stride-1
# conv of the ×2-dilated dy padded (2, 2), clipped to the input size.
# Transposed conv: dx(i) = Σ_k wf[k]·dy(2i + k), a stride-2 conv padded (0, 1).
DX_GEOMETRY = {(2, False, (0, 1)): (1, True, (2, 2)), (1, True, (2, 1)): (2, False, (0, 1))}


def _taps(xp, stride, out_hw):
    """(tap index, [B, out_hw, out_hw, c] slice of x̃) for the 9 kernel taps."""
    span = stride * (out_hw - 1) + 1
    if xp.shape[1] < span + K - 1 or xp.shape[2] < span + K - 1:
        raise ValueError(f"a padded input of {tuple(xp.shape[1:3])} cannot give "
                         f"{out_hw} outputs at stride {stride}")
    for ky in range(K):
        for kx in range(K):
            yield ky * K + kx, xp[:, ky:ky + span:stride, kx:kx + span:stride]


def conv_im2col_plain(x, w2d, stride, dilate, pads, out_hw, compute_dtype="float32"):
    """Plain twin of the conv kernel: x [B, h, w, cin] (NHWC) and w2d
    [9·cin, cout] → [B, out_hw, out_hw, cout] fp32, the reference's
    _fwd_kernel: models/conv.conv_general on the HWIO view of w2d."""
    cin, cout = x.shape[3], w2d.shape[1]
    return conv_mod.conv_general(x, w2d.float().reshape(K, K, cin, cout), stride, dilate,
                                 pads, out_hw, compute_dtype)


def conv_dw_plain(x, dy, stride, dilate, pads, out_hw, compute_dtype="float32"):
    """Plain twin of the weight-gradient kernel: [9·cin, cout], tap by tap
    Σ over every output pixel of tap[pixel, cin]ᵀ · dy[pixel, cout] (the
    reference's _dw_kernel)."""
    cd = networks.dtype_name(compute_dtype)
    cin, cout = x.shape[3], dy.shape[3]
    d = networks.round_operand(dy.float(), cd).reshape(-1, cout)
    parts = [tap.reshape(-1, cin).T @ d
             for _, tap in _taps(conv_mod.pad_input(x, dilate, pads, cd), stride, out_hw)]
    return torch.cat(parts)


def flip_w2d(w2d, cin: int, cout: int):
    """[9·cin, cout] → the spatially flipped, channel-transposed
    [9·cout, cin]: the weight of the conv that computes dx."""
    w = w2d.reshape(K, K, cin, cout).flip(0, 1).transpose(2, 3)
    return w.reshape(K * K * cout, cin).contiguous()


class PhaseClass(NamedTuple):
    """Output pixels (oy0 + ostep·qy, ox0 + ostep·qx) for qy < nqy, qx < nqx,
    each the sum over ``taps`` (wrow = 3·ky + kx, dy, dx) of x[b, istep·qy
    + dy, istep·qx + dx, :] · w2d[wrow·cin : (wrow + 1)·cin] (zero where
    the input index leaves the image)."""
    oy0: int
    ox0: int
    ostep: int
    nqy: int
    nqx: int
    istep: int
    taps: tuple


def _axis_classes(stride: int, dilate: bool, lo: int, out: int):
    """Parity classes along one axis: (first output, output step, count,
    input step, ((k, input offset), ...)). Output o reads x̃[stride·o + k],
    x̃ being x dilated ×2 when ``dilate`` and padded ``lo`` in front."""
    if not dilate:
        return [(0, 1, out, stride, tuple((k, k - lo) for k in range(K)))]
    if stride % 2 == 0:  # every output has the same parity: one class
        return [(0, 1, out, stride // 2,
                 tuple((k, (k - lo) // 2) for k in range(K) if (k - lo) % 2 == 0))]
    classes = []
    for p in range(2):  # o = 2q + p reads x[stride·q + (stride·p + k − lo)/2]
        n = (out - p + 1) // 2
        taps = tuple((k, (stride * p + k - lo) // 2) for k in range(K)
                     if (stride * p + k - lo) % 2 == 0)
        if n > 0 and taps:
            classes.append((p, 2, n, stride, taps))
    return classes


@functools.lru_cache(maxsize=64)
def phase_plan(stride: int, dilate: bool, lo: int, out_hw: int) -> tuple:
    """The parity classes that cover every (output pixel, tap meeting
    nonzero input) of the conv exactly once: the product of the two axes'
    classes (:class:`PhaseClass`). The kernel takes it by value."""
    plan = []
    for oy0, ostep, nqy, istep, ytaps in _axis_classes(stride, bool(dilate), lo, out_hw):
        for ox0, _, nqx, _, xtaps in _axis_classes(stride, bool(dilate), lo, out_hw):
            taps = tuple((K * ky + kx, dy, dx) for ky, dy in ytaps for kx, dx in xtaps)
            plan.append(PhaseClass(oy0, ox0, ostep, nqy, nqx, istep, taps))
    return tuple(plan)


@functools.lru_cache(maxsize=64)
def _plan_table(plan: tuple):
    """The plan as the C entry point reads it (csrc/conv.cu::PhasePlan): the
    class count, the tap count, the input and output steps; per class
    (zero-padded to 4) oy0, ox0, its extent nqy, nqx and the end of its
    taps; per tap (padded to 9) wrow, dy, dx, class after class."""
    taps = [t for c in plan for t in c.taps]

    def pad(v, n):
        return list(v) + [0] * (n - len(v))

    ends = list(itertools.accumulate(len(c.taps) for c in plan))
    rows = [len(plan), len(taps), plan[0].istep, plan[0].ostep]
    for field in ("oy0", "ox0", "nqy", "nqx"):
        rows += pad([getattr(c, field) for c in plan], MAX_CLASSES)
    rows += pad(ends, MAX_CLASSES)
    for v in zip(*taps):
        rows += pad(v, K * K)
    return (ctypes.c_int * len(rows))(*rows)


def conv_phase_plain(x, w2d, stride, dilate, pads, out_hw, compute_dtype="float32"):
    """The phase plan run in torch: per class and tap, the shifted input
    (zero outside the image) times the tap's rows of the weight, written
    to the class's output pixels. The kernel's arithmetic (operands
    rounded under ``compute_dtype``, sums in fp32) in the plain twin's
    function."""
    cd = networks.dtype_name(compute_dtype)
    b, h, w, cin = x.shape
    cout = w2d.shape[1]
    xr = networks.round_operand(x.float(), cd)
    wr = networks.round_operand(w2d.float(), cd)
    y = xr.new_zeros(b, out_hw, out_hw, cout)
    for c in phase_plan(stride, bool(dilate), pads[0], out_hw):
        acc = xr.new_zeros(b * c.nqy * c.nqx, cout)
        for wrow, dy, dx in c.taps:
            iy = c.istep * torch.arange(c.nqy) + dy
            ix = c.istep * torch.arange(c.nqx) + dx
            inside = ((iy >= 0) & (iy < h))[:, None] & ((ix >= 0) & (ix < w))[None, :]
            patch = xr[:, iy.clamp(0, h - 1)][:, :, ix.clamp(0, w - 1)]
            patch = patch * inside[None, :, :, None]
            acc = acc + patch.reshape(-1, cin) @ wr[wrow * cin:(wrow + 1) * cin]
        y[:, c.oy0::c.ostep, c.ox0::c.ostep] = acc.reshape(b, c.nqy, c.nqx, cout)
    return y


def fwd_route(cin: int, cout: int, compute_dtype="float32") -> str:
    """conv_fwd's route: the tiled routes take cin in slices of 32 and
    cout 32 or 64, bf16 on tensor cores (``mma``) and fp32 on FFMA
    (``ffma``); cout = 1 takes 8 lanes per output pixel (``dot``, cin a
    multiple of 32); cin = 1 and every other shape one pixel's channel
    group per thread (``taps``)."""
    if cin % STAGE_K == 0 and cout in (32, 64):
        return "mma" if networks.dtype_name(compute_dtype) == "bfloat16" else "ffma"
    if cout == 1 and cin % STAGE_K == 0:
        return "dot"
    return "taps"


def _taps_groups(cout: int):
    """(channels per thread, threads per pixel) of the taps route."""
    cg = 8 if cout >= 8 else 1
    return cg, -(-cout // cg)


def fwd_tile_plan(plan: tuple, cin: int, cout: int, compute_dtype="float32"):
    """(route, output pixels per block tile, dynamic shared memory in
    bytes) of conv_fwd; csrc/conv.cu::fwd_smem computes the same bytes and
    refuses a launch that disagrees. A block keeps its class's weight
    (and, on the tiled routes, two slice buffers and the tile's pixel
    rows). Raises when that does not fit a block's shared memory."""
    route = fwd_route(cin, cout, compute_dtype)
    k = max(len(c.taps) for c in plan) * cin
    if route == "ffma":
        tile = FFMA_TILE
        smem = 4 * (k * cout + 2 * tile * (STAGE_K + 4)) + 16 * tile
    elif route == "mma":
        tile = MMA_TILE
        smem = 2 * (cout * (k + 8) + 2 * tile * (STAGE_K + 8)) + 16 * tile
    elif route == "dot":
        tile, smem = DOT_TILE, 4 * k
    else:
        cg, groups = _taps_groups(cout)
        tile, smem = FWD_THREADS // groups * TAPS_PIX, 4 * k * cg * groups
    if smem + PLAN_BYTES > kmlp.SMEM_BYTES:
        raise ValueError(f"the conv kernel keeps the weight in shared memory: "
                         f"{k} patch columns × {cout} channels need {smem} bytes on the "
                         f"{route} route, more than a block has")
    return route, tile, smem


def dw_gathered(plan: tuple) -> str:
    """The side conv_dw gathers at the taps (the other, "direct" side is
    the layer's undilated one, read once per pixel): ``"x"`` for a
    stride-2 conv, whose one class of 9 taps covers its output pixels;
    ``"dy"`` for a transposed conv, each of whose input pixels meets one
    output pixel under each tap. Raises for another plan."""
    if sum(len(c.taps) for c in plan) == K * K:
        if len(plan) == 1 and plan[0].istep == 2 and plan[0].ostep == 1 \
                and plan[0].oy0 == plan[0].ox0 == 0:
            return "x"
        if all(c.istep == 1 and c.ostep == 2 for c in plan):
            return "dy"
    raise ValueError("the conv weight-gradient kernel takes the stride-2 conv and the "
                     "stride-2 transposed conv")


def dw_taps(plan: tuple, gathered: str) -> tuple:
    """The plan's 9 taps as conv_dw reads them: (wrow, oy, ox), direct
    pixel (y, x) meeting the gathered side at (2y + oy, 2x + ox). Gathered
    x: output pixel q reads x at 2q + (dy, dx). Gathered dy: input pixel p
    is tap (dy, dx) of its class's output pixel q = p − (dy, dx), at
    (oy0, ox0) + 2q."""
    if gathered == "x":
        return tuple(t for c in plan for t in c.taps)
    return tuple((w, c.oy0 - 2 * dy, c.ox0 - 2 * dx) for c in plan for w, dy, dx in c.taps)


def dw_route(plan: tuple, cin: int, cout: int, compute_dtype="float32") -> str:
    """conv_dw's route: ``thin`` for one channel on the gathered side and
    4-32 on the other (conv1, convt2); the tiled routes for 32 gathered
    channels and 32 or 64 direct ones (conv2, convt1), bf16 on tensor cores
    (``mma``), fp32 on FFMA (``ffma``). Raises for other layers."""
    gathered = dw_gathered(plan)
    cg, cd = (cin, cout) if gathered == "x" else (cout, cin)
    if cg == 1 and cd in (4, 8, 16, 32):
        return "thin"
    if cg == DW_GATHERED and cd in (32, 64):
        return "mma" if networks.dtype_name(compute_dtype) == "bfloat16" else "ffma"
    raise ValueError(f"the conv weight-gradient kernel takes 1 or {DW_GATHERED} channels on "
                     f"the gathered side ({gathered}) and 4-64 on the other; got cin {cin}, "
                     f"cout {cout}")


def dw_smem(route: str, cd: int) -> int:
    """Dynamic shared memory of conv_dw for ``cd`` direct channels: the
    tiled routes' ring of slices (gathered rows of 288 + 4 floats, direct
    rows of cd + 4) and, in bf16, two rounded slices (rows of 288 + 8 and
    cd + 8); the thin route takes none (csrc/conv.cu::dw_smem)."""
    if route == "thin":
        return 0
    ring = 4 * DW_STAGES * DW_SLICE * (K * K * DW_GATHERED + 4 + cd + 4)
    if route == "ffma":
        return ring
    return ring + 2 * 2 * DW_SLICE * (K * K * DW_GATHERED + 8 + cd + 8)


def dw_plan(pixels: int, n_sm: int, waves: int):
    """(chunks, pixels per chunk) for conv_dw over the direct side's
    ``pixels``: about ``waves`` × ``n_sm`` chunks, none below
    ``DW_MIN_PIXELS``, each a whole number of ``DW_SLICE``-pixel slices. A
    second launch adds the chunks' partials in order."""
    per = max(-(-pixels // (waves * n_sm)), DW_MIN_PIXELS)
    per = -(-per // DW_SLICE) * DW_SLICE
    return -(-pixels // per), per


def conv_dw_phase_plain(x, dy, stride, dilate, pads, out_hw, compute_dtype="float32"):
    """The weight-gradient kernel's plan run in torch: per tap
    (:func:`dw_taps`), the gathered side at (2y + oy, 2x + ox) (zero
    outside it) against the direct side at (y, x), summed over every
    direct pixel, into the tap's rows of dW. The kernel's arithmetic
    (operands rounded under ``compute_dtype``, sums in fp32) in the plain
    twin's function."""
    cd = networks.dtype_name(compute_dtype)
    cin, cout = x.shape[3], dy.shape[3]
    xr = networks.round_operand(x.float(), cd)
    dr = networks.round_operand(dy.float(), cd)
    plan = phase_plan(stride, bool(dilate), pads[0], out_hw)
    gathered = dw_gathered(plan)
    gv, dv = (xr, dr) if gathered == "x" else (dr, xr)
    hd, hg = dv.shape[1], gv.shape[1]
    dw = xr.new_zeros(K * K * cin, cout)
    for wrow, oy, ox in dw_taps(plan, gathered):
        ny, nx = 2 * torch.arange(hd) + oy, 2 * torch.arange(hd) + ox
        inside = ((ny >= 0) & (ny < hg))[:, None] & ((nx >= 0) & (nx < hg))[None, :]
        g = gv[:, ny.clamp(0, hg - 1)][:, :, nx.clamp(0, hg - 1)] * inside[None, :, :, None]
        prod = g.reshape(-1, g.shape[3]).T @ dv.reshape(-1, dv.shape[3])  # [cg, cd]
        dw[wrow * cin:(wrow + 1) * cin] = prod if gathered == "x" else prod.T
    return dw


def _geometry(x, cout, stride, dilate, pads, out_hw):
    if x.ndim != 4:
        raise ValueError(f"expected an NHWC [batch, h, w, c] input, got {tuple(x.shape)}")
    if stride not in (1, 2) or not 1 <= cout <= MAX_COUT:
        raise ValueError(f"the conv kernels take stride 1 or 2 and 1..{MAX_COUT} "
                         f"output channels, got stride {stride}, cout {cout}")
    b, h, w, cin = x.shape
    lo, hi = pads
    span = stride * (out_hw - 1) + K
    if out_hw < 1 or min(lo, hi) < 0 or span > (2 * h - 1 if dilate else h) + lo + hi \
            or span > (2 * w - 1 if dilate else w) + lo + hi:
        raise ValueError(f"a {h}×{w} input padded {pads} cannot give {out_hw} outputs at "
                         f"stride {stride}")
    if max(x.numel(), b * out_hw * out_hw * cout) >= 2 ** 31:
        raise ValueError("the conv kernels index with 32-bit offsets: split the batch")
    return (b, h, w, cin, cout, stride, int(bool(dilate)), lo, hi, out_hw)


def _launch_fwd(x, w2d, stride, dilate, pads, out_hw, cd):
    dev = x.device
    x = _aligned(x)
    w2d = w2d.detach().float().contiguous()
    cin, cout = x.shape[-1], w2d.shape[1]
    kmlp._check_f32(w2d, dev, "w2d", (K * K * cin, cout))
    b, h, w, *_ = _geometry(x, cout, stride, dilate, pads, out_hw)
    y = torch.empty(b, out_hw, out_hw, cout, dtype=torch.float32, device=dev)
    if b == 0:
        return y
    plan = phase_plan(stride, bool(dilate), pads[0], out_hw)
    route, _, smem = fwd_tile_plan(plan, cin, cout, cd)
    lib = _build.load()
    with torch.cuda.device(dev):
        err = lib.vae_conv_fwd(x.data_ptr(), b, h, w, cin, w2d.data_ptr(), cout, out_hw,
                               _plan_table(plan), ROUTES.index(route), smem,
                               kmlp.sm_count(dev), y.data_ptr(), int(cd == "bfloat16"),
                               kmlp._stream(x))
    _build.check(lib, err, "conv kernel launch")
    _launches.count(_launches.SERVING, "conv_fwd")
    return y


def _aligned(t):
    """``t`` as fp32, contiguous and at a 16-byte boundary (the kernels
    read 16-byte vectors)."""
    t = t.detach().float().contiguous()
    return t.clone() if t.data_ptr() % 16 else t


def _launch_dw(x, dy, stride, dilate, pads, out_hw, cd):
    dev = x.device
    x, dy = _aligned(x), _aligned(dy)
    b, cin, cout = x.shape[0], x.shape[-1], dy.shape[-1]
    kmlp._check_f32(dy, dev, "dy", (b, out_hw, out_hw, cout))
    _, h, w, *_ = _geometry(x, cout, stride, dilate, pads, out_hw)
    dw = torch.empty(K * K * cin, cout, dtype=torch.float32, device=dev)
    if b == 0:
        return dw.zero_()
    plan = phase_plan(stride, bool(dilate), pads[0], out_hw)
    route = dw_route(plan, cin, cout, cd)
    gathered = dw_gathered(plan)
    pixels = b * (out_hw * out_hw if gathered == "x" else h * w)
    chunks, per = dw_plan(pixels, kmlp.sm_count(dev), DW_WAVES[route])
    smem = dw_smem(route, cout if gathered == "x" else cin)
    taps = (ctypes.c_int * (3 * K * K))(*itertools.chain(*dw_taps(plan, gathered)))
    partial = (torch.empty(chunks * dw.numel(), dtype=torch.float32, device=dev)
               if chunks > 1 else None)
    lib = _build.load()
    with torch.cuda.device(dev):
        err = lib.vae_conv_dw(x.data_ptr(), b, h, w, cin, dy.data_ptr(), cout, out_hw,
                              taps, int(gathered == "x"), DW_ROUTES.index(route), per,
                              chunks, smem, dw.data_ptr(),
                              partial.data_ptr() if partial is not None else None,
                              int(cd == "bfloat16"), kmlp._stream(x))
    _build.check(lib, err, "conv weight-gradient kernel launch")
    _launches.count(_launches.TRAINING, "conv_dw")
    return dw


def conv_fwd(x, w2d, stride, dilate, pads, out_hw, *, compute_dtype="float32"):
    """The conv kernel on a CUDA tensor, its twin on the CPU: x [B, h, w,
    cin] NHWC, w2d [9·cin, cout] → [B, out_hw, out_hw, cout] fp32."""
    cd = networks.dtype_name(compute_dtype)
    if x.device.type == "cpu":
        return conv_im2col_plain(x, w2d, stride, dilate, pads, out_hw, cd)
    if x.device.type != "cuda":
        raise ValueError(f"the conv kernel runs on CUDA, got {x.device}")
    return _launch_fwd(x, w2d, stride, dilate, pads, out_hw, cd)


def conv_dw(x, dy, stride, dilate, pads, out_hw, *, compute_dtype="float32"):
    """The weight-gradient kernel on a CUDA tensor, its twin on the CPU:
    [9·cin, cout], deterministic (a fixed order of partial sums)."""
    cd = networks.dtype_name(compute_dtype)
    if x.device.type == "cpu":
        return conv_dw_plain(x, dy, stride, dilate, pads, out_hw, cd)
    if x.device.type != "cuda":
        raise ValueError(f"the conv weight-gradient kernel runs on CUDA, got {x.device}")
    return _launch_dw(x, dy, stride, dilate, pads, out_hw, cd)


def conv_dx(dy, w2d, cin: int, stride, dilate, pads, in_hw: int, *, compute_dtype="float32"):
    """dx [B, in_hw, in_hw, cin] of the layer (stride, dilate, pads) for its
    output gradient dy: ``conv_fwd`` with the flipped weight and the mapped
    geometry."""
    geom = DX_GEOMETRY.get((stride, bool(dilate), tuple(pads)))
    if geom is None:
        raise NotImplementedError(
            f"no input gradient for stride {stride}, dilate {dilate}, pads {pads}")
    return conv_fwd(dy, flip_w2d(w2d, cin, dy.shape[-1]), *geom, in_hw,
                    compute_dtype=compute_dtype)


class _Conv(torch.autograd.Function):
    """The reference's ``_conv_im2col`` custom VJP. Inputs: stride, dilate,
    pads, out_hw, compute dtype, x, w2d."""

    @staticmethod
    def forward(ctx, stride, dilate, pads, out_hw, cd, x, w2d):
        ctx.geom = (stride, dilate, pads, out_hw, cd)
        ctx.save_for_backward(x, w2d)
        return conv_fwd(x, w2d, stride, dilate, pads, out_hw, compute_dtype=cd)

    @staticmethod
    def backward(ctx, dy):
        x, w2d = ctx.saved_tensors
        stride, dilate, pads, out_hw, cd = ctx.geom
        dy = dy.contiguous()
        dx = dw = None
        if ctx.needs_input_grad[5]:
            dx = conv_dx(dy, w2d, x.shape[-1], stride, dilate, pads, x.shape[1],
                         compute_dtype=cd)
        if ctx.needs_input_grad[6]:
            dw = conv_dw(x, dy, stride, dilate, pads, out_hw, compute_dtype=cd)
        return None, None, None, None, None, dx, dw


def _layer(x, w_hwio, b, stride, dilate, pads, out_hw, compute_dtype):
    cin, cout = w_hwio.shape[2], w_hwio.shape[3]
    w2d = w_hwio.reshape(K * K * cin, cout)
    y = _Conv.apply(stride, dilate, pads, out_hw, networks.dtype_name(compute_dtype),
                    x, w2d)
    return y + b


def conv3x3_s2(x, w_hwio, b, *, compute_dtype="float32"):
    """SAME 3×3 stride-2 conv on the kernels; matches models/conv.conv3x3_s2.
    Even spatial sizes only: for an odd size ``lax``'s SAME gives ceil(h/2)
    rows where this formulation floors, so it raises instead."""
    if x.shape[1] % 2 or x.shape[2] % 2:
        raise ValueError(f"conv3x3_s2 requires even spatial dims, got {tuple(x.shape[1:3])}")
    return _layer(x, w_hwio, b, 2, False, (0, 1), x.shape[1] // 2, compute_dtype)


def convt3x3_s2(x, w_hwio, b, *, compute_dtype="float32"):
    """SAME 3×3 stride-2 transposed conv on the kernels; matches
    models/conv.convt3x3_s2."""
    return _layer(x, w_hwio, b, 1, True, (2, 1), 2 * x.shape[1], compute_dtype)


encode_conv_fused, decode_conv_fused = conv_mod.make_conv_tower(conv3x3_s2, convt3x3_s2)
