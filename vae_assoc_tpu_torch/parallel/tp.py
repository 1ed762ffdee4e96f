"""Tensor parallelism that keeps the kernels (counterpart of
vae_assoc_tpu/parallel/tp_shard.py and, under the package-level names, of
its GSPMD tp.py).

The Megatron column × row decomposition, written as explicit collectives
around the width-agnostic MLP kernels. The unit is a **pair block**: two
consecutive linear layers (a, b) of a tower run on each rank as one
``kernels.mlp.decode_mlp_fused`` launch on a depth-1-plus-linear-out stack,
``softplus(h @ Wa_r + ba_r) @ Wb_r``, ``Wa`` split by columns and ``Wb``
by rows; one all-reduce over the model group rebuilds the whole
pre-activation, and layer b's bias and transfer follow. Tower shapes map
onto it as in the JAX package (``_net_roles``):

- encoder hidden layers pair up (h1, h2), (h3, h4), …; an odd leftover
  runs split by columns (``_colsplit_linear``: the depth-0 stack, the
  columns all-gathered); the μ and logσ² heads stay replicated;
- decoder hidden layers pair the same way; at odd depth the last hidden
  layer pairs with the output layer, at even depth the output layer runs
  split by columns.

**Conv towers** (``encoder="conv"``) take the channel splits of the JAX
package's GSPMD conv pattern (``_conv_roles``): conv1 and convt1 split
their output channels, conv2 and convt2 their input channels with g's
all-reduce after them, and the dense layers pair column × row (the
recognition dense with the heads, the generator's two dense layers). They
run as the port's ``models/conv.py`` runs ``encoder="conv"``: plain
``F.conv2d`` on the channel slices and plain products.

Widths the model group does not divide are zero-padded to its next
multiple (500 over 8 ranks is 8 × 63 with 4 pad columns). A pad column's
activation is softplus(0), but its only consumer is a pad row (or pad
input channel) of the contraction-split partner, zero from the start and
kept zero by masking its gradient every step (``_pad_masks``), so the
padded model computes the unpadded function. Column-split leftovers drop
their pad columns after the gather, which zeroes those columns'
gradients.

**The collectives** are ``ops.collectives``' autograd Functions with
Megatron's gradients: ``reduce_from_model`` (g: all-reduce forward,
identity backward) after a contraction-split product,
``copy_to_model`` (f: identity forward, all-reduce backward) where a
replicated activation enters a split layer, and ``gather_columns``.
Replicated leaves get the whole gradient on every rank (the loss after
each all-reduce is replicated), and split leaves their exact slice.
Clipping compares the norm of the whole gradient: the split leaves'
squares summed over the model group, the replicated leaves' counted once
(``slices.split_norm``).

**DP × TP** runs on a 2-D ``("data", "model")`` mesh (``make_tp_mesh(n,
data_parallel=D)``): batches shard over ``data``, the blocks split over
``model``, and every weight's gradient is averaged over the data group in
one all-reduce; ε folds the data rank, one stream per data shard, so the
2-D step follows the DP step at the same global batch. In pure TP the
batch is whole on every rank and the ε stream is the single-device one.

**Two sets of entry points, one machinery.** ``make_tp_train_step`` and
``tp_train_loop`` here are the JAX package's ``tp_shard`` names and keep
its refusals (``check_tp_shard``): conv towers, ``parity_mode`` and
``remat``. ``make_gspmd_tp_train_step`` and ``gspmd_tp_train_loop`` are
what ``vae_assoc_tpu_torch.parallel`` exports under the GSPMD names
``make_tp_train_step`` and ``tp_train_loop``, and take what the JAX
package's GSPMD TP takes (``check_tp``): conv towers, ``remat``
(``torch.utils.checkpoint`` around each tower, whose collectives run again
in the recompute) and ``parity_mode`` (the ordered plain losses; the
partial sums still reassociate, so it holds within tolerance, not bit for
bit, as GSPMD's does). Both reject ``encoder="conv_pallas"``, and the
GSPMD names reject ``use_pallas`` on a conv tower, as the JAX package
does; the MLP towers keep the kernels under both names, where JAX's GSPMD
TP runs its jnp path (a deliberate difference). The state functions
(``tp_param_specs``, ``shard_params``, ``init_tp_train_state``, …) serve
both.

Conditional models ride (the condition widens the unsplit input rows of
the first column-split layer); a non-softplus modality, or ``use_pallas``
off, runs its blocks on the plain ``networks.decode_mlp``. The heads are
plain products; ε and the loss terms are the single-device step's (the
sampler and loss kernels where ``use_pallas``). DTensor is not used: its
dispatch never reaches a ``ctypes`` kernel.
"""

from __future__ import annotations

import functools
from types import SimpleNamespace

import torch
import torch.distributed as dist
from torch import nn
from torch.utils.checkpoint import checkpoint

from vae_assoc_tpu_torch.configs import (
    TRANSFER_FNS,
    AssocConfig,
    TrainConfig,
    gener_widths,
    recog_widths,
)
from vae_assoc_tpu_torch.models import assoc as assoc_mod
from vae_assoc_tpu_torch.models import conv as conv_mod
from vae_assoc_tpu_torch.models import networks
from vae_assoc_tpu_torch.models import vae as vae_mod
from vae_assoc_tpu_torch.ops import sampling
from vae_assoc_tpu_torch.ops.collectives import (
    all_gather_rows,
    copy_to_model,
    gather_columns,
    reduce_from_model,
)
from vae_assoc_tpu_torch.parallel import mesh as mesh_mod
from vae_assoc_tpu_torch.parallel import slices
from vae_assoc_tpu_torch.parallel.dp import _epoch_loop
from vae_assoc_tpu_torch.train import step as step_mod
from vae_assoc_tpu_torch.train.step import TrainState, init_train_state, make_optimizer

AXIS = mesh_mod.MODEL_AXIS
replicate_batch = mesh_mod.replicate_batch  # pure TP's batch placement, as tp_shard names it

# Leaf roles. COL/COLSPLIT: weight [in, out] split by columns, the bias with
# it. ROW: weight split by rows, bias replicated (added after the sum).
# REPL: replicated. COL and COLSPLIT differ only in how the forward reads
# them (a pair block, or a gather of the columns). COUT/CIN: a conv kernel
# [3, 3, cin, cout] split by output channels (the bias with it) or by input
# channels (bias replicated, added after the sum).
COL, ROW, COLSPLIT, REPL, COUT, CIN = "col", "row", "colsplit", "repl", "cout", "cin"
# The roles whose weight is split along the contraction: their pad rows
# (or pad input channels) are masked.
CONTRACTED = {ROW: 0, CIN: 2}


def make_tp_mesh(n_devices=None, *, data_parallel: int = 1, device_type: str = "cuda"):
    """The mesh of this layout: ``("model",)`` for pure TP (the batch whole
    on every rank), or ``("data", "model")`` of ``data_parallel`` ×
    ``n / data_parallel`` for DP × TP, each model group consecutive ranks."""
    if data_parallel == 1:
        return mesh_mod.make_mesh(n_devices, data_axis=AXIS, device_type=device_type)
    if n_devices is None:
        networks.cuda_or_raise(device_type, "make_tp_mesh")
        mesh_mod.init_distributed(device_type=device_type)
        n_devices = dist.get_world_size()
    if n_devices % data_parallel:
        raise ValueError(f"{n_devices} devices not divisible by data_parallel={data_parallel}")
    return mesh_mod.make_mesh(n_devices, model_axis=AXIS,
                              model_parallel=n_devices // data_parallel,
                              device_type=device_type)


def _mesh_info(mesh):
    """(model ranks, the data axis or None) of a mesh of this layout."""
    names = tuple(mesh.mesh_dim_names or ())
    if names == (AXIS,):
        return mesh.size(), None
    if names == (mesh_mod.DATA_AXIS, AXIS):
        return mesh.size(1), mesh_mod.DATA_AXIS
    raise ValueError(
        f"tensor parallelism runs over a 1-D ('{AXIS}',) mesh or a 2-D "
        f"('{mesh_mod.DATA_AXIS}', '{AXIS}') mesh (make_tp_mesh); got "
        f"{dict(zip(names, mesh.shape))}"
    )


def _check_spec_encoders(cfg: AssocConfig) -> None:
    """The splits cover the plain towers, ``"mlp"`` and ``"conv"``, as the
    JAX package's ``_check_gspmd_encoders``."""
    for m in cfg.modalities:
        if m.encoder not in ("mlp", "conv"):
            raise ValueError(
                f"tensor parallelism splits 'mlp' and 'conv' towers; modality {m.name!r} has "
                f"encoder={m.encoder!r}, whose conv kernels run whole layers. Use "
                "encoder='conv' here, or keep the conv kernels under parallel/zero.py "
                "(sharded state) or parallel/dp.py."
            )


def check_tp_shard(cfg: AssocConfig, tc: TrainConfig) -> None:
    """What the ``tp_shard`` names reject, as the JAX package's tp_shard:
    ``parity_mode``, ``remat`` and every tower but an MLP."""
    if tc.parity_mode:
        raise ValueError(
            "tensor parallelism reorders every reduction (a sum of partial "
            "products), so the pinned-order bitwise parity cannot hold; run "
            "parity_mode on the single-device step, or under the GSPMD names "
            "(vae_assoc_tpu_torch.parallel.make_tp_train_step) within tolerance."
        )
    if tc.remat:
        raise ValueError(
            "the tp_shard layout does not implement remat (its activations are "
            "block-local); use parallel/zero.py, the single-device step, or the "
            "GSPMD names (vae_assoc_tpu_torch.parallel.make_tp_train_step)."
        )
    for m in cfg.modalities:
        if m.encoder != "mlp":
            raise ValueError(
                f"the tp_shard layout splits MLP towers only; modality {m.name!r} has "
                f"encoder={m.encoder!r}. Conv towers scale with their kernels under "
                "parallel/zero.py (sharded state) or parallel/dp.py, and split their "
                "channels under the GSPMD names (vae_assoc_tpu_torch.parallel."
                "make_tp_train_step, encoder='conv')."
            )


def check_tp(cfg: AssocConfig, tc: TrainConfig) -> None:
    """What the GSPMD names reject, as the JAX package's GSPMD TP: the conv
    kernels (``encoder="conv_pallas"``, or ``use_pallas`` on a conv
    tower). MLP towers keep their kernels."""
    _check_spec_encoders(cfg)
    conv = [m.name for m in cfg.modalities if m.encoder == "conv"]
    if tc.use_pallas and conv:
        raise ValueError(
            f"the conv towers of {conv} split their channels on the plain convs (the JAX "
            "package's GSPMD TP runs its jnp path); use_pallas keeps the kernels on MLP "
            "towers only. Set TrainConfig(use_pallas=False), or keep the conv kernels "
            "under parallel/zero.py (sharded state) or parallel/dp.py."
        )


def _net_roles(n_hidden: int, *, is_gener: bool) -> dict:
    """Role of every linear layer of one net, by name: the hidden layers
    (and a decoder's output layer) pair up, a leftover is split by columns,
    an encoder's heads are replicated."""
    seq = [f"h{i + 1}" for i in range(n_hidden)] + (["out"] if is_gener else [])
    paired = len(seq) - len(seq) % 2
    roles = {name: (COL if i % 2 == 0 else ROW) if i < paired else COLSPLIT
             for i, name in enumerate(seq)}
    if not is_gener:
        roles.update(out_mean=REPL, out_logvar=REPL)
    return roles


def _conv_roles() -> dict:
    """The conv tower's roles, JAX's GSPMD conv pattern: the output channels
    of conv1 and convt1, the input channels of conv2 and convt2, and the
    dense layers column × row."""
    return {"recog": {"conv1": COUT, "conv2": CIN, "dense": COL, "out_mean": ROW,
                      "out_logvar": ROW},
            "gener": {"dense1": COL, "dense2": ROW, "convt1": COUT, "convt2": CIN}}


@functools.lru_cache(maxsize=32)
def tp_roles(cfg: AssocConfig) -> tuple:
    """Per modality {"recog": {layer: role}, "gener": {layer: role}}."""
    return tuple(_conv_roles() if m.encoder == "conv" else
                 {"recog": _net_roles(len(recog_widths(m.arch)), is_gener=False),
                  "gener": _net_roles(len(gener_widths(m.arch)), is_gener=True)}
                 for m in cfg.modalities)


def _split_dim(role: str, leaf: str):
    """The dim a leaf is split along (None: replicated)."""
    if role in (COL, COLSPLIT):
        return 1 if leaf == "w" else 0
    if role == COUT:
        return 3 if leaf == "w" else 0
    if role in CONTRACTED and leaf == "w":
        return CONTRACTED[role]
    return None


def tp_param_specs(cfg: AssocConfig) -> dict:
    """How each parameter lies in the layout: state_dict key → the dim it is
    split along over the model group (padded to a multiple of its size),
    or None where it is replicated."""
    _check_spec_encoders(cfg)
    roles = tp_roles(cfg)
    out = {}
    for key, _ in assoc_mod.AssocVAE(cfg, device="meta").named_parameters():
        _, k, net, name, leaf = key.split(".")
        out[key] = _split_dim(roles[int(k)][net][name], leaf)
    return out


def cut_shard(t: torch.Tensor, dim, n: int, r: int) -> torch.Tensor:
    """Rank r's slice of ``t`` zero-padded along ``dim`` to a multiple of n
    (all of it where ``dim`` is None)."""
    t = t.detach()
    if dim is None:
        return t.clone()
    pad = slices.pad_len(t.shape[dim], n) - t.shape[dim]
    if pad:
        widths = [0, 0] * t.ndim
        widths[2 * (t.ndim - 1 - dim) + 1] = pad
        t = nn.functional.pad(t, widths)
    return t.chunk(n, dim)[r].contiguous()


def _check_tp_state(state: TrainState, cfg: AssocConfig):
    specs = tp_param_specs(cfg)
    if len(list(state.params.parameters())) != len(specs):
        raise ValueError("the state's parameters do not match the config's")
    return list(specs.values())


def shard_params(mesh, params: assoc_mod.AssocVAE, cfg: AssocConfig) -> assoc_mod.AssocVAE:
    """The whole model, the same on every rank → this rank's TP model: the
    same module tree with each split leaf replaced by its padded slice."""
    n, _ = _mesh_info(mesh)
    r = mesh.get_local_rank(AXIS)
    specs = tp_param_specs(cfg)
    dev = next(params.parameters()).device
    model = assoc_mod.AssocVAE(cfg, device="meta")
    whole = dict(params.named_parameters())
    for key, dim in specs.items():
        mod, leaf = key.rsplit(".", 1)
        setattr(model.get_submodule(mod), leaf,
                nn.Parameter(cut_shard(whole[key], dim, n, r).to(dev)))
    return model


def shard_tp_train_state(mesh, state: TrainState, cfg: AssocConfig,
                         tc: TrainConfig) -> TrainState:
    """A whole TrainState, the same on every rank → the TP layout: the
    split leaves of the weights and of every optimizer list cut to this
    rank's padded slice, the rest as it is."""
    n, _ = _mesh_info(mesh)
    r = mesh.get_local_rank(AXIS)
    dims = _check_tp_state(state, cfg)

    def cut(ts):
        return [cut_shard(t, d, n, r) for t, d in zip(ts, dims)]

    return TrainState(state.step, shard_params(mesh, state.params, cfg),
                      state.opt_state.map_lists(cut), state.seed)


def _uncut(t: torch.Tensor, dim, size: int, group) -> torch.Tensor:
    if dim is None:
        return t.detach().clone()
    got = all_gather_rows(t.detach().movedim(dim, 0), group).movedim(0, dim)
    return got.narrow(dim, 0, size).contiguous()


@torch.no_grad()
def gather_tp_train_state(tstate: TrainState, cfg: AssocConfig, tc: TrainConfig,
                          mesh) -> TrainState:
    """Inverse of :func:`shard_tp_train_state`, on every rank: the slices
    gathered over the model group and the pads dropped, a whole TrainState
    that checkpoints, evaluates and serves like any. A collective over the
    mesh (every rank calls it)."""
    _mesh_info(mesh)
    group = mesh.get_group(AXIS)
    dims = _check_tp_state(tstate, cfg)
    dev = next(tstate.params.parameters()).device
    model = assoc_mod.AssocVAE(cfg, device=dev)
    full = list(model.parameters())

    def uncut(ts):
        return [_uncut(t, d, f.shape[d] if d is not None else 0, group)
                for t, d, f in zip(ts, dims, full)]

    torch._foreach_copy_(full, uncut(list(tstate.params.parameters())))
    return TrainState(tstate.step, model, tstate.opt_state.map_lists(uncut), tstate.seed)


def init_tp_train_state(cfg: AssocConfig, tc: TrainConfig, mesh, *, params=None) -> TrainState:
    """Step 0 (from ``tc.seed``, or ``params``) in the TP layout, on this
    rank's device of ``mesh``: the card unless the mesh is of CPUs."""
    _mesh_info(mesh)
    full = init_train_state(cfg, tc, device=mesh_mod.mesh_device(mesh, "init_tp_train_state"),
                             params=params)
    return shard_tp_train_state(mesh, full, cfg, tc)


# ---------------------------------------------------------------------------
# The split forward: pair blocks and column splits around the stack kernels
# ---------------------------------------------------------------------------


class _Stack:
    """A generator stack as ``decode_mlp_fused`` and ``networks.decode_mlp``
    read one: ``gener`` maps layer names to objects with ``w`` and ``b``."""

    def __init__(self, **layers):
        self.gener = {k: SimpleNamespace(w=w, b=b) for k, (w, b) in layers.items()}

    def parameters(self):
        return [t for l in self.gener.values() for t in (l.w, l.b)]


def _block_fn(tc: TrainConfig, transfer: str):
    """A block's compute: the stack kernels (softplus only, as the fused
    kernels hard-code it in their forward and backward), or the plain
    ``networks.decode_mlp`` with the modality's transfer."""
    if tc.use_pallas and transfer == "softplus":
        from vae_assoc_tpu_torch.kernels.mlp import decode_mlp_fused

        return decode_mlp_fused
    return functools.partial(networks.decode_mlp, transfer=TRANSFER_FNS[transfer])


class _Split(SimpleNamespace):
    """What a modality's split forward needs: the model group, this rank's
    place in it, the block function, whether the sampler kernel draws ε
    (``fused``) and the compute dtype."""

    def zeros(self, n: int, device) -> torch.Tensor:
        """A zero bias of width n, kept: the stack kernel caches its layer
        table by the layers' addresses, and a fresh bias each call would
        rebuild it, a blocking copy to the device, every block."""
        cache = self.__dict__.setdefault("_zeros", {})
        key = (n, torch.device(device))
        if key not in cache:
            cache[key] = torch.zeros(n, dtype=torch.float32, device=device)
        return cache[key]

    def stack(self, **layers) -> _Stack:
        """The block's ``_Stack`` over these (w, b) pairs, built once per set
        of tensors: the state's weights are updated in place, so every step
        reads the same ones. The cached stack holds its tensors, so their
        ids are not reused while it is kept."""
        cache = self.__dict__.setdefault("_stacks", {})
        key = tuple((k, id(w), id(b)) for k, (w, b) in layers.items())
        if key not in cache:
            cache[key] = _Stack(**layers)
        return cache[key]


def _pair_block(h, wa, ba, wb, sp: _Split):
    """transfer(h @ Wa_r + ba_r) @ Wb_r, summed over the model group: the
    whole [B, out_b] pre-activation, before layer b's bias."""
    part = sp.block_fn(sp.stack(h1=(wa, ba), out=(wb, sp.zeros(wb.shape[1], wb.device))),
                       copy_to_model(h, sp.group), compute_dtype=sp.cd)
    return reduce_from_model(part, sp.group)


def _colsplit_linear(h, w, b, width: int, sp: _Split):
    """h @ W_r + b_r on the depth-0 stack, the columns gathered over the
    model group and the pads dropped: [B, width]."""
    local = sp.block_fn(sp.stack(out=(w, b)), copy_to_model(h, sp.group), compute_dtype=sp.cd)
    return gather_columns(local, sp.group, sp.rank)[:, :width]


def _sample(mu, lv, x, m, sp: _Split, seed, eps):
    """z from ε as the single-device step draws it: injected, the sampler
    kernel's (``sp.fused``), or ``draw_eps(seed)``'s."""
    if eps is not None:
        return sampling.reparameterize(mu, lv, eps=eps)
    if sp.fused:  # the sampler kernel draws draw_eps(seed)'s ε in place
        from vae_assoc_tpu_torch.kernels.sampling import reparameterize_fused

        return reparameterize_fused(mu, lv, seed)
    return sampling.reparameterize(mu, lv, eps=vae_mod.draw_eps(seed, x.shape[0], m, x.device))


def _tp_modality_forward(p, x, m, sp: _Split, *, seed=None, eps=None, cond=None):
    """One MLP modality's forward with split towers, the single-device
    step's otherwise: the same ε (from ``seed``, or injected), head math and
    condition concatenation as ``models.vae.vae_forward``."""
    transfer = TRANSFER_FNS[m.transfer]
    r, g = p.recog, p.gener
    rw, gw = recog_widths(m.arch), gener_widths(m.arch)
    h = x.float() if cond is None else torch.cat([x.float(), cond], dim=1)
    i = 0
    while i + 1 < len(rw):
        a, b = r[f"h{i + 1}"], r[f"h{i + 2}"]
        h = transfer(_pair_block(h, a.w, a.b, b.w, sp) + b.b)
        i += 2
    if i < len(rw):
        a = r[f"h{i + 1}"]
        h = transfer(_colsplit_linear(h, a.w, a.b, rw[i], sp))
    mu = networks.linear(r["out_mean"], h, sp.cd)
    lv = networks.linear(r["out_logvar"], h, sp.cd)
    z = _sample(mu, lv, x, m, sp, seed, eps)
    h = z if cond is None else torch.cat([z, cond], dim=1)
    i = 0
    while i + 1 < len(gw):  # pairs of hidden layers, as _net_roles
        a, b = g[f"h{i + 1}"], g[f"h{i + 2}"]
        h = transfer(_pair_block(h, a.w, a.b, b.w, sp) + b.b)
        i += 2
    if i < len(gw):  # odd depth: (h_last, out), no transfer on out
        a = g[f"h{i + 1}"]
        recon = _pair_block(h, a.w, a.b, g["out"].w, sp) + g["out"].b
    else:  # even depth: out split by columns, pads dropped by the gather
        recon = _colsplit_linear(h, g["out"].w, g["out"].b, m.arch["n_input"], sp)
    return vae_mod.VAEOutputs(mu, lv, z, recon)


def _row_product(h, layers, sp: _Split):
    """Σ over the model group of h @ W_r for each row-split layer, in one
    all-reduce, then each layer's bias: [B, out] per layer."""
    a = networks.round_operand(h, sp.cd)
    parts = [a @ networks.round_operand(l.w, sp.cd) for l in layers]
    whole = reduce_from_model(torch.cat(parts, dim=1), sp.group)
    return [y + l.b for y, l in zip(whole.split([p.shape[1] for p in parts], dim=1), layers)]


def _cin_conv(h, layer, stride, dilate, pads, out_hw, sp: _Split):
    """An input-channel-split conv: this rank's partial sum over its input
    channels, summed over the model group, then the bias."""
    part = conv_mod.conv_general(h, layer.w, stride, dilate, pads, out_hw, sp.cd)
    return reduce_from_model(part.contiguous(), sp.group) + layer.b


def _tp_conv_forward(p, x, m, sp: _Split, *, seed=None, eps=None, cond=None):
    """One conv modality's forward with channel splits (``_conv_roles``),
    ``models.conv``'s layer ops and wiring otherwise."""
    del cond  # conv towers take no condition (configs refuse one)
    transfer = TRANSFER_FNS[m.transfer]
    r, g = p.recog, p.gener
    img = x.float().reshape(-1, conv_mod.IMG_SIZE, conv_mod.IMG_SIZE, 1)
    h = transfer(conv_mod.conv3x3_s2(copy_to_model(img, sp.group), r["conv1"].w,
                                     r["conv1"].b, compute_dtype=sp.cd))
    h = transfer(_cin_conv(h, r["conv2"], 2, False, (0, 1), h.shape[1] // 2, sp))
    h = copy_to_model(h.reshape(h.shape[0], conv_mod.FLAT), sp.group)
    h = transfer(networks.linear(r["dense"], h, sp.cd))
    mu, lv = _row_product(h, [r["out_mean"], r["out_logvar"]], sp)
    z = _sample(mu, lv, x, m, sp, seed, eps)
    h = transfer(networks.linear(g["dense1"], copy_to_model(z, sp.group), sp.cd))
    (h,) = _row_product(h, [g["dense2"]], sp)
    h = transfer(h).reshape(-1, conv_mod.SMALL, conv_mod.SMALL, conv_mod.C2)
    h = transfer(conv_mod.convt3x3_s2(copy_to_model(h, sp.group), g["convt1"].w,
                                      g["convt1"].b, compute_dtype=sp.cd))
    h = _cin_conv(h, g["convt2"], 1, True, (2, 1), 2 * h.shape[1], sp)
    return vae_mod.VAEOutputs(mu, lv, z, h.reshape(h.shape[0], -1))


def _tp_loss_fn(params, xs, cfg: AssocConfig, sps, *, use_pallas, seed=None, eps=None,
                data_group=None, parity_mode: bool = False, remat: bool = False):
    """The joint objective with split towers; the loss terms are those of
    the single-device step (``assoc.joint_objective``: the fused loss
    kernel where ``use_pallas``, the ordered plain losses in
    ``parity_mode``). ``remat`` recomputes each tower in the backward, its
    collectives included."""
    xs, cond = assoc_mod.split_cond(xs, cfg)
    k = len(cfg.modalities)
    seeds = assoc_mod.modality_seeds(seed, k) if eps is None else [None] * k
    eps = [None] * k if eps is None else eps
    outs = []
    for p, x, m, sp, s, e in zip(params.modalities, xs, cfg.modalities, sps, seeds, eps):
        fwd = functools.partial(
            _tp_conv_forward if m.encoder == "conv" else _tp_modality_forward, p, m=m, sp=sp,
            seed=s, cond=vae_mod.prepare_cond(cond, m, x.shape[0], device=x.device))

        def f(x, e, fwd=fwd):
            return fwd(x, eps=e)

        outs.append(checkpoint(f, x, e, use_reentrant=False) if remat else f(x, e))
    return assoc_mod.joint_objective(outs, xs, cfg, use_pallas=use_pallas,
                                     parity_mode=parity_mode, data_group=data_group)


# ---------------------------------------------------------------------------
# Gradient hygiene: pad masks
# ---------------------------------------------------------------------------


def _pad_masks(cfg: AssocConfig, n: int, r: int, device) -> dict:
    """{parameter index: keep mask} of the contraction-split weights: the
    rows (input channels) past the layer's true input width are pads,
    whose gradients (fed by the softplus(0) of the partner's pad columns)
    are zeroed. Each mask broadcasts along its weight's split dim."""
    roles = tp_roles(cfg)
    out = {}
    for i, (key, p) in enumerate(assoc_mod.AssocVAE(cfg, device="meta").named_parameters()):
        _, k, net, name, leaf = key.split(".")
        role = roles[int(k)][net][name]
        if leaf == "w" and role in CONTRACTED:
            d = CONTRACTED[role]
            rows = slices.pad_len(p.shape[d], n) // n
            keep = torch.arange(r * rows, (r + 1) * rows, device=device) < p.shape[d]
            shape = [1] * p.ndim
            shape[d] = rows
            out[i] = keep.view(shape)
    return out


def _splits(cfg: AssocConfig, tc: TrainConfig, mesh) -> list:
    """Each modality's ``_Split`` on this rank of ``mesh``: what
    ``_tp_loss_fn`` reads besides the weights and the batch."""
    group, rank = mesh.get_group(AXIS), mesh.get_local_rank(AXIS)
    return [_Split(group=group, rank=rank, block_fn=_block_fn(tc, m.transfer),
                   fused=bool(tc.use_pallas) and m.transfer == "softplus",
                   cd=tc.compute_dtype) for m in cfg.modalities]


def tp_grads(cfg: AssocConfig, tc: TrainConfig, mesh):
    """``grads(model, state, xs, eps) -> (grads, metrics)``: the gradient of
    the step's objective with respect to this rank's TP shard ``model``
    (pads masked), before any reduction over the data group, and the
    detached metrics. ε folds the data rank (``step_seed_of_rank``) where
    the mesh has a data axis. The core of the TP and TP × FSDP steps."""
    n, data_axis = _mesh_info(mesh)
    data_group = mesh.get_group(data_axis) if data_axis else None
    sps = _splits(cfg, tc, mesh)
    masks = _pad_masks(cfg, n, mesh.get_local_rank(AXIS), mesh_mod.mesh_device(mesh))

    def grads(model, state, xs, eps):
        total, metrics = _tp_loss_fn(
            model, list(xs), cfg, sps, use_pallas=bool(tc.use_pallas), eps=eps,
            data_group=data_group, parity_mode=tc.parity_mode, remat=tc.remat,
            seed=step_mod.step_seed_of_rank(state.seed, state.step, data_group),
        )
        total, metrics = step_mod.apply_objective_weights(total, metrics, cfg, tc, state.step)
        gs = list(torch.autograd.grad(total, list(model.parameters())))
        for i, keep in masks.items():
            gs[i] = gs[i] * keep
        return gs, {k: v.detach() for k, v in metrics.items()}

    return grads


def _make_step(cfg: AssocConfig, tc: TrainConfig, mesh):
    _, data_axis = _mesh_info(mesh)
    group = mesh.get_group(AXIS)
    data_group = mesh.get_group(data_axis) if data_axis else None
    opt = make_optimizer(tc, slices.split_norm(
        [d is not None for d in tp_param_specs(cfg).values()], group))
    grads_of = tp_grads(cfg, tc, mesh)

    def one(state, xs, eps):
        grads, metrics = grads_of(state.params, state, xs, eps)
        if data_group is not None:
            grads = step_mod.all_reduce_mean(grads, data_group)
            metrics = step_mod.mean_metrics(metrics, data_group)
        metrics["grad_norm"] = opt.norm_fn(grads)
        opt.update(grads, state.opt_state, list(state.params.parameters()))
        return state._replace(step=state.step + 1), metrics

    return step_mod.stacked_steps(one, tc.steps_per_call)


def make_tp_train_step(cfg: AssocConfig, tc: TrainConfig, mesh):
    """The TP step under the ``tp_shard`` names: ``step_fn(tstate, xs,
    eps=None) -> (tstate', metrics)`` with the state in the TP layout. On a
    ``("model",)`` mesh ``xs`` are whole batches (``replicate_batch``); on a
    ``("data", "model")`` mesh a rank's rows of each global batch, over the
    data axis (``shard_tp_batch``). Rejects what ``check_tp_shard`` names."""
    check_tp_shard(cfg, tc)
    return _make_step(cfg, tc, mesh)


def make_gspmd_tp_train_step(cfg: AssocConfig, tc: TrainConfig, mesh):
    """The TP step under the GSPMD names (exported by the package as
    ``make_tp_train_step``): :func:`make_tp_train_step`'s contract, for
    what the JAX package's GSPMD TP takes (``check_tp``): conv towers,
    ``remat`` and ``parity_mode`` too."""
    check_tp(cfg, tc)
    return _make_step(cfg, tc, mesh)


def shard_tp_batch(mesh, arrays, *, leading_scan_axis: bool = False) -> tuple:
    """A rank's batch of this layout: its rows over the data axis of a 2-D
    mesh, the whole batch on a ``("model",)`` mesh."""
    _, data_axis = _mesh_info(mesh)
    if data_axis is None:
        return mesh_mod.replicate_batch(mesh, arrays)
    return mesh_mod.shard_batch(mesh, arrays, leading_scan_axis=leading_scan_axis,
                                batch_axes=data_axis)


def tp_loop(tc: TrainConfig, data, mesh, step_fn, state: TrainState, **kw):
    """``dp_train_loop``'s epochs over ``step_fn`` on this layout's batches:
    whole on a ``("model",)`` mesh, sharded over ``data`` on a 2-D one."""
    _, data_axis = _mesh_info(mesh)
    shard = (0, 1) if data_axis is None else mesh_mod.shard_index(mesh, (data_axis,))
    return _epoch_loop(tc, data, mesh, step_fn, state, shard=shard, **kw)


def tp_train_loop(cfg: AssocConfig, tc: TrainConfig, data, mesh, *, epochs: int = 10,
                  state: TrainState | None = None, display_step: int = 1,
                  on_metrics=None, shuffle: bool = True):
    """``dp_train_loop`` with the TP step of the ``tp_shard`` names;
    ``state`` in the TP layout."""
    step_fn = make_tp_train_step(cfg, tc, mesh)
    return tp_loop(tc, data, mesh, step_fn,
                   init_tp_train_state(cfg, tc, mesh) if state is None else state,
                   epochs=epochs, display_step=display_step, on_metrics=on_metrics,
                   shuffle=shuffle)


def gspmd_tp_train_loop(cfg: AssocConfig, tc: TrainConfig, data, mesh, *, epochs: int = 10,
                        state: TrainState | None = None, display_step: int = 1,
                        on_metrics=None, shuffle: bool = True):
    """``tp_train_loop`` under the GSPMD names (exported by the package as
    ``tp_train_loop``): the step of :func:`make_gspmd_tp_train_step`."""
    step_fn = make_gspmd_tp_train_step(cfg, tc, mesh)
    return tp_loop(tc, data, mesh, step_fn,
                   init_tp_train_state(cfg, tc, mesh) if state is None else state,
                   epochs=epochs, display_step=display_step, on_metrics=on_metrics,
                   shuffle=shuffle)
