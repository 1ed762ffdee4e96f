"""Tensor parallelism that keeps the kernels (counterpart of
vae_assoc_tpu/parallel/tp_shard.py, under the names of its tp.py too).

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

Widths the model group does not divide are zero-padded to its next
multiple (500 over 8 ranks is 8 × 63 with 4 pad columns). A pad column's
activation is softplus(0), but its only consumer is a pad row of the
row-split partner, zero from the start and kept zero by masking its
gradient every step (``_mask_pad_rows``), so the padded model computes the
unpadded function. Column-split leftovers drop their pad columns after the
gather, which zeroes those columns' gradients.

**The collectives** are ``torch.autograd.Function``s with Megatron's
gradients (``torch.distributed.nn.functional.all_reduce`` would all-reduce
the cotangent too, and every rank computes the same loss after the sum, so
the gradients would come back W times too large):

- ``_reduce_from_model`` (g): all-reduce forward, identity backward, after
  a row-split product;
- ``_copy_to_model`` (f): identity forward, all-reduce backward, where a
  replicated activation enters a column-split layer;
- ``_gather_columns``: all-gather of the column slices forward, this
  rank's slice of the cotangent backward.

Replicated leaves get the whole gradient on every rank (the loss after
each all-reduce is replicated), and split leaves their exact slice. Clipping
compares the norm of the whole gradient: the split leaves' squares summed
over the model group, the replicated leaves' counted once
(``_tp_norm``).

**DP × TP** runs on a 2-D ``("data", "model")`` mesh (``make_tp_mesh(n,
data_parallel=D)``): batches shard over ``data``, the blocks split over
``model``, and every weight's gradient is averaged over the data group in
one all-reduce; ε folds the data rank, one stream per data shard, so the
2-D step follows the DP step at the same global batch. In pure TP the
batch is whole on every rank and the ε stream is the single-device one.

Rejected, as in the JAX package: conv towers (``parallel/zero.py`` and
``parallel/dp.py`` keep their kernels), ``parity_mode`` and ``remat``.
Conditional models ride (the condition widens the unsplit input rows of
the first column-split layer); a non-softplus modality, or
``use_pallas`` off, runs its blocks on the plain ``networks.decode_mlp``.
The heads are plain products, as the JAX layout's; ε and the loss terms
are the single-device step's (the sampler and loss kernels where
``use_pallas``).

The JAX package's GSPMD ``tp.py`` names (``tp_param_specs``,
``shard_params``, ``shard_tp_batch``, ``init_tp_train_state``, …) are this
layout in the port: GSPMD could not split a ``pallas_call``, explicit
collectives can. DTensor is not used: its dispatch never reaches a
``ctypes`` kernel.
"""

from __future__ import annotations

import functools
from types import SimpleNamespace

import torch
import torch.distributed as dist
from torch import nn

from vae_assoc_tpu_torch.configs import (
    TRANSFER_FNS,
    AssocConfig,
    TrainConfig,
    gener_widths,
    recog_widths,
)
from vae_assoc_tpu_torch.models import assoc as assoc_mod
from vae_assoc_tpu_torch.models import networks
from vae_assoc_tpu_torch.models import vae as vae_mod
from vae_assoc_tpu_torch.ops import sampling
from vae_assoc_tpu_torch.ops.collectives import all_gather_rows
from vae_assoc_tpu_torch.parallel import mesh as mesh_mod
from vae_assoc_tpu_torch.parallel.dp import _epoch_loop
from vae_assoc_tpu_torch.parallel.zero import _opt_lists, _with_lists
from vae_assoc_tpu_torch.train import step as step_mod
from vae_assoc_tpu_torch.train.step import TrainState, init_train_state, make_optimizer

AXIS = mesh_mod.MODEL_AXIS

# Leaf roles. COL/COLSPLIT: weight [in, out] split by columns, the bias with
# it. ROW: weight split by rows, bias replicated (added after the sum).
# REPL: replicated. COL and COLSPLIT differ only in how the forward reads
# them (a pair block, or a gather of the columns).
COL, ROW, COLSPLIT, REPL = "col", "row", "colsplit", "repl"


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


def _check_encoders(cfg: AssocConfig) -> None:
    for m in cfg.modalities:
        if m.encoder != "mlp":
            raise ValueError(
                f"tensor parallelism splits MLP towers only; modality {m.name!r} has "
                f"encoder={m.encoder!r}. Conv towers scale with their kernels under "
                "parallel/zero.py (sharded state) or parallel/dp.py."
            )


def check_tp_shard(cfg: AssocConfig, tc: TrainConfig) -> None:
    """Reject what the layout does not cover, naming what does."""
    if tc.parity_mode:
        raise ValueError(
            "tensor parallelism reorders every reduction (a sum of partial "
            "products), so the pinned-order bitwise parity cannot hold; run "
            "parity_mode on the single-device step."
        )
    if tc.remat:
        raise ValueError(
            "tensor parallelism does not implement remat (its activations are "
            "block-local); use parallel/zero.py or the single-device step for "
            "rematerialized towers."
        )
    _check_encoders(cfg)


def _pad_to(width: int, n: int) -> int:
    return -(-width // n) * n


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


@functools.lru_cache(maxsize=32)
def tp_roles(cfg: AssocConfig) -> tuple:
    """Per modality {"recog": {layer: role}, "gener": {layer: role}}."""
    return tuple({"recog": _net_roles(len(recog_widths(m.arch)), is_gener=False),
                  "gener": _net_roles(len(gener_widths(m.arch)), is_gener=True)}
                 for m in cfg.modalities)


def _split_dim(role: str, leaf: str):
    """The dim a leaf is split along (None: replicated)."""
    if role in (COL, COLSPLIT):
        return 1 if leaf == "w" else 0
    if role == ROW and leaf == "w":
        return 0
    return None


def tp_param_specs(cfg: AssocConfig) -> dict:
    """How each parameter lies in the layout: state_dict key → the dim it is
    split along over the model group (padded to a multiple of its size),
    or None where it is replicated."""
    _check_encoders(cfg)
    roles = tp_roles(cfg)
    out = {}
    for key, _ in assoc_mod.AssocVAE(cfg, device="meta").named_parameters():
        _, k, net, name, leaf = key.split(".")
        out[key] = _split_dim(roles[int(k)][net][name], leaf)
    return out


def _cut(t: torch.Tensor, dim, n: int, r: int) -> torch.Tensor:
    """Rank r's slice of ``t`` zero-padded along ``dim`` to a multiple of n
    (all of it where ``dim`` is None)."""
    t = t.detach()
    if dim is None:
        return t.clone()
    pad = _pad_to(t.shape[dim], n) - t.shape[dim]
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
                nn.Parameter(_cut(whole[key], dim, n, r).to(dev)))
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
        return None if ts is None else [_cut(t, d, n, r) for t, d in zip(ts, dims)]

    opt = _with_lists(state.opt_state, [cut(l) for l in _opt_lists(state.opt_state)])
    return TrainState(state.step, shard_params(mesh, state.params, cfg), opt, state.seed)


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
        if ts is None:
            return None
        return [_uncut(t, d, f.shape[d] if d is not None else 0, group)
                for t, d, f in zip(ts, dims, full)]

    torch._foreach_copy_(full, uncut(list(tstate.params.parameters())))
    opt = _with_lists(tstate.opt_state, [uncut(l) for l in _opt_lists(tstate.opt_state)])
    return TrainState(tstate.step, model, opt, tstate.seed)


def init_tp_train_state(cfg: AssocConfig, tc: TrainConfig, mesh, *, params=None) -> TrainState:
    """Step 0 (from ``tc.seed``, or ``params``) in the TP layout, on this
    rank's device of ``mesh``: the card unless the mesh is of CPUs."""
    _mesh_info(mesh)
    full = init_train_state(cfg, tc, device=mesh_mod.mesh_device(mesh, "init_tp_train_state"),
                             params=params)
    return shard_tp_train_state(mesh, full, cfg, tc)


# ---------------------------------------------------------------------------
# Megatron's operators
# ---------------------------------------------------------------------------


class _CopyToModel(torch.autograd.Function):
    """f: identity forward (a view, no copy), all-reduce of the cotangent
    backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.clone()  # the cotangent may be shared; the all-reduce is in place
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ReduceFromModel(torch.autograd.Function):
    """g: all-reduce forward, in place on the block's fresh product (marked
    dirty, so autograd refuses the step if anything saved it), identity
    backward."""

    @staticmethod
    def forward(ctx, x, group):
        dist.all_reduce(x, group=group)
        ctx.mark_dirty(x)
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherColumns(torch.autograd.Function):
    """[B, c] slices of the columns → [B, W·c] in rank order; the backward
    keeps this rank's columns of the cotangent."""

    @staticmethod
    def forward(ctx, x, group, rank):
        ctx.rank, ctx.cols = rank, x.shape[1]
        w = dist.get_world_size(group)
        got = all_gather_rows(x, group).view(w, x.shape[0], x.shape[1])
        return got.permute(1, 0, 2).reshape(x.shape[0], w * x.shape[1])

    @staticmethod
    def backward(ctx, g):
        return g[:, ctx.rank * ctx.cols:(ctx.rank + 1) * ctx.cols].contiguous(), None, None


def copy_to_model(x, group):
    return _CopyToModel.apply(x, group)


def reduce_from_model(x, group):
    return _ReduceFromModel.apply(x, group)


def gather_columns(x, group, rank: int):
    return _GatherColumns.apply(x, group, rank)


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


def _tp_modality_forward(p, x, m, sp: _Split, *, seed=None, eps=None, cond=None):
    """One modality's forward with split towers, the single-device step's otherwise:
    the same ε (from ``seed``, or injected), head math and condition
    concatenation as ``models.vae.vae_forward``."""
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
    if eps is not None:
        z = sampling.reparameterize(mu, lv, eps=eps)
    elif sp.fused:  # the sampler kernel draws draw_eps(seed)'s ε in place
        from vae_assoc_tpu_torch.kernels.sampling import reparameterize_fused

        z = reparameterize_fused(mu, lv, seed)
    else:
        z = sampling.reparameterize(mu, lv, eps=vae_mod.draw_eps(seed, x.shape[0], m, x.device))
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


def _tp_loss_fn(params, xs, cfg: AssocConfig, sps, *, use_pallas, seed=None, eps=None,
                data_group=None):
    """The joint objective with split towers; the loss terms are those of
    the single-device step (``assoc.joint_objective``: the fused loss
    kernel where ``use_pallas``)."""
    xs, cond = assoc_mod.split_cond(xs, cfg)
    k = len(cfg.modalities)
    seeds = assoc_mod.modality_seeds(seed, k) if eps is None else [None] * k
    eps = [None] * k if eps is None else eps
    outs = [
        _tp_modality_forward(p, x, m, sp, seed=s, eps=e,
                             cond=vae_mod.prepare_cond(cond, m, x.shape[0], device=x.device))
        for p, x, m, sp, s, e in zip(params.modalities, xs, cfg.modalities, sps, seeds, eps)
    ]
    return assoc_mod.joint_objective(outs, xs, cfg, use_pallas=use_pallas,
                                     data_group=data_group)


# ---------------------------------------------------------------------------
# Gradient hygiene: pad masks and the norm of the whole gradient
# ---------------------------------------------------------------------------


def _pad_row_masks(cfg: AssocConfig, n: int, r: int, device) -> dict:
    """{parameter index: [rows, 1] keep mask} of the row-split weights: the
    rows past the layer's true input width are pads, whose gradients (fed
    by the softplus(0) of the partner's pad columns) are zeroed."""
    roles = tp_roles(cfg)
    out = {}
    for i, (key, p) in enumerate(assoc_mod.AssocVAE(cfg, device="meta").named_parameters()):
        _, k, net, name, leaf = key.split(".")
        if leaf == "w" and roles[int(k)][net][name] == ROW:
            rows = _pad_to(p.shape[0], n) // n
            keep = torch.arange(r * rows, (r + 1) * rows, device=device) < p.shape[0]
            out[i] = keep[:, None]
    return out


def _tp_norm(dims, group):
    """The norm of the whole gradient: split leaves' squares summed over
    the model group, replicated leaves' counted once."""
    split = [i for i, d in enumerate(dims) if d is not None]
    repl = [i for i, d in enumerate(dims) if d is None]

    def norm(grads):
        sq = step_mod.global_norm([grads[i] for i in split]).square()
        dist.all_reduce(sq, group=group)
        return torch.sqrt(sq + step_mod.global_norm([grads[i] for i in repl]).square())

    return norm


def _splits(cfg: AssocConfig, tc: TrainConfig, mesh) -> list:
    """Each modality's ``_Split`` on this rank of ``mesh``: what
    ``_tp_loss_fn`` reads besides the weights and the batch."""
    group, rank = mesh.get_group(AXIS), mesh.get_local_rank(AXIS)
    return [_Split(group=group, rank=rank, block_fn=_block_fn(tc, m.transfer),
                   fused=bool(tc.use_pallas) and m.transfer == "softplus",
                   cd=tc.compute_dtype) for m in cfg.modalities]


def make_tp_train_step(cfg: AssocConfig, tc: TrainConfig, mesh):
    """The TP step: ``step_fn(tstate, xs, eps=None) -> (tstate', metrics)``
    with the state in the TP layout. On a ``("model",)`` mesh ``xs`` are
    whole batches (``replicate_batch``); on a ``("data", "model")`` mesh a
    rank's rows of each global batch, over the data axis (``shard_tp_batch``)."""
    check_tp_shard(cfg, tc)
    n, data_axis = _mesh_info(mesh)
    group = mesh.get_group(AXIS)
    rank = mesh.get_local_rank(AXIS)
    data_group = mesh.get_group(data_axis) if data_axis else None
    dims = list(tp_param_specs(cfg).values())
    opt = make_optimizer(tc, _tp_norm(dims, group))
    sps = _splits(cfg, tc, mesh)
    masks = _pad_row_masks(cfg, n, rank, mesh_mod.mesh_device(mesh))

    def one(state, xs, eps):
        params = list(state.params.parameters())
        total, metrics = _tp_loss_fn(
            state.params, list(xs), cfg, sps, use_pallas=bool(tc.use_pallas), eps=eps,
            data_group=data_group,
            seed=step_mod.step_seed_of_rank(state.seed, state.step, data_group),
        )
        total, metrics = step_mod.apply_objective_weights(total, metrics, cfg, tc, state.step)
        grads = list(torch.autograd.grad(total, params))
        metrics = {k: v.detach() for k, v in metrics.items()}
        if data_group is not None:
            grads = step_mod.all_reduce_mean(grads, data_group)
            metrics = step_mod.mean_metrics(metrics, data_group)
        for i, keep in masks.items():
            grads[i] = grads[i] * keep
        metrics["grad_norm"] = opt.norm_fn(grads)
        opt.update(grads, state.opt_state, params)
        return state._replace(step=state.step + 1), metrics

    return step_mod.stacked_steps(one, tc.steps_per_call)


def replicate_batch(mesh, arrays, *, leading_scan_axis: bool = False) -> tuple:
    """Every batch array whole on this rank's device (pure TP)."""
    del leading_scan_axis
    dev = mesh_mod.mesh_device(mesh)
    return tuple(torch.as_tensor(a).to(dev, torch.float32).contiguous() for a in arrays)


def shard_tp_batch(mesh, arrays, *, leading_scan_axis: bool = False) -> tuple:
    """A rank's batch of this layout: its rows over the data axis of a 2-D
    mesh, the whole batch on a ``("model",)`` mesh."""
    _, data_axis = _mesh_info(mesh)
    if data_axis is None:
        return replicate_batch(mesh, arrays)
    return mesh_mod.shard_batch(mesh, arrays, leading_scan_axis=leading_scan_axis,
                                batch_axes=data_axis)


def tp_train_loop(cfg: AssocConfig, tc: TrainConfig, data, mesh, *, epochs: int = 10,
                  state: TrainState | None = None, display_step: int = 1,
                  on_metrics=None, shuffle: bool = True):
    """``dp_train_loop`` with the TP step: batches whole on a ``("model",)``
    mesh, sharded over ``data`` on a 2-D one; ``state`` in the TP layout."""
    _, data_axis = _mesh_info(mesh)
    if state is None:
        state = init_tp_train_state(cfg, tc, mesh)
    shard = (0, 1) if data_axis is None else mesh_mod.shard_index(mesh, (data_axis,))
    return _epoch_loop(tc, data, mesh, make_tp_train_step(cfg, tc, mesh), state,
                       shard=shard, epochs=epochs, display_step=display_step,
                       on_metrics=on_metrics, shuffle=shuffle)
