"""GPipe pipeline parallelism over deep MLP towers (counterpart of
vae_assoc_tpu/parallel/pp.py).

- **Mesh.** A 1-D ``("stage",)`` mesh of S ranks, or ``("stage", "data")``
  for DP × PP with data the minor axis (rank s·D + d), ``make_pp_mesh``.
- **Layout.** Each net keeps its boundary layers replicated, ``h1`` (whose
  input width differs from the hidden width) and the heads, and
  stage-shards its homogeneous middle h2..hL: stage s holds the block
  ``mid`` of ``w`` [nper, W, W] and ``b`` [nper, W], which is shard s of
  the JAX package's stacked [S, nper, W, W] leaf (``_stack_net``). The
  middle's weight and optimizer memory drop by S.
- **Schedule.** JAX's ``_ring`` as written: M microbatches, M + S − 1
  ticks. At each tick every stage applies its block to the activation it
  holds, stage 0 ingests microbatch t (past M the last one again, filler
  whose results are never captured), stage S−1 captures microbatch
  t − (S−1), and the ring shifts one stage forward
  (``ops.collectives.ring_shift``, over an all-gather). Every stage runs
  the same operations and selects with masks, as JAX's ``jnp.where``
  does, so every rank's backward meets the same collectives in the same
  order.
- **Gradients.** The port has no vma types, so each replicated value's
  reduction is explicit, Megatron's pair over the stage group: the ring's
  input h0 enters through ``copy_to_model`` (identity forward, all-reduce
  backward: only stage 0 ingests, so h1's gradient becomes complete on
  every stage), and the masked captures leave through
  ``reduce_from_model`` (all-reduce forward, identity backward: JAX's
  masked ``psum`` broadcast). The heads, the sampling and the loss then run
  replicated and their gradients are complete on every rank; summing them
  again would give S times the gradient. Autograd's reverse of the ring is
  the reverse pipeline.
- **Clipping** compares the norm of the whole gradient: the middle's
  squares summed over the stage group, the replicated leaves' counted once
  (JAX's ``_pp_global_norm``).
- **DP × PP.** The batch shards over ``data``: each pipeline replica runs
  the ring on its rows, the gradients are averaged over the data group in
  one all-reduce, and ε folds the data rank only, as the DP step's does,
  so the step follows the pure-DP step. In pure PP the batch is whole on
  every stage and ε is the single-device step's.

The towers run the plain formulation, as the JAX package's PP does: the
fused stack kernels run a whole tower a launch and have no stage boundary
to cut at, so ``use_pallas`` is rejected, as there.

``shard_pp_train_state`` / ``gather_pp_train_state`` convert between this
layout and the whole TrainState, so checkpoints, evaluation and serving
round-trip; the gather is a collective over the stage group.
"""

from __future__ import annotations

from types import SimpleNamespace

import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.device_mesh import init_device_mesh

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
from vae_assoc_tpu_torch.ops.collectives import copy_to_model, reduce_from_model, ring_shift
from vae_assoc_tpu_torch.parallel import mesh as mesh_mod
from vae_assoc_tpu_torch.parallel import slices
from vae_assoc_tpu_torch.parallel.dp import _epoch_loop
from vae_assoc_tpu_torch.train import step as step_mod
from vae_assoc_tpu_torch.train.step import TrainState, init_train_state, make_optimizer

STAGE_AXIS = "stage"
DATA_AXIS = mesh_mod.DATA_AXIS


def make_pp_mesh(n_stages=None, *, data_parallel: int = 1, device_type: str = "cuda"):
    """The pipeline's mesh: 1-D ``("stage",)`` over the process group, or
    2-D ``("stage", "data")`` of ``n_stages`` × ``data_parallel`` when
    ``data_parallel > 1`` (DP × PP: S pipeline stages of D data shards),
    data the minor axis so each stage's data shards are consecutive ranks.
    The default group is joined first where it is not yet; the card unless
    the caller names the CPU."""
    networks.cuda_or_raise(device_type, "make_pp_mesh")
    if data_parallel <= 1:
        return mesh_mod.make_mesh(n_stages, data_axis=STAGE_AXIS, device_type=device_type)
    if n_stages is None:
        raise ValueError("data_parallel > 1 needs an explicit n_stages")
    mesh_mod.init_distributed(device_type=device_type)
    need, world = n_stages * data_parallel, dist.get_world_size()
    if need != world:
        raise ValueError(
            f"PP×DP needs {n_stages}×{data_parallel}={need} devices, but the process group "
            f"has {world} processes (one device each)"
        )
    return init_device_mesh(device_type, (n_stages, data_parallel),
                            mesh_dim_names=(STAGE_AXIS, DATA_AXIS))


def _mesh_axes(mesh) -> tuple:
    """(stages S, the data axis or None) of a mesh of this layout."""
    names = tuple(mesh.mesh_dim_names or ())
    if names not in ((STAGE_AXIS,), (STAGE_AXIS, DATA_AXIS)):
        raise ValueError(
            f"PP runs over a ('{STAGE_AXIS}',) or ('{STAGE_AXIS}', '{DATA_AXIS}') mesh "
            f"(make_pp_mesh); got axes {names}"
        )
    s = mesh.size(0)
    if s < 2:
        raise ValueError(f"PP needs >= 2 stages, got {s} (use the plain step)")
    return s, (DATA_AXIS if len(names) == 2 else None)


def _net_widths(m, net: str) -> tuple:
    return recog_widths(m.arch) if net == "recog" else gener_widths(m.arch)


def check_pp(cfg: AssocConfig, tc: TrainConfig, n_stages: int) -> None:
    """Reject what the pipeline cannot express, naming the way out."""
    if tc.use_pallas:
        raise ValueError(
            "PP cannot run the fused stack kernels (use_pallas): they run a whole tower "
            "per launch and have no stage boundary to cut at. Use use_pallas=False here "
            "(the ring's products are plain), or parallel/zero.py to shard the state "
            "while keeping the kernels."
        )
    for m in cfg.modalities:
        if m.encoder != "mlp":
            raise ValueError(
                f"PP covers MLP towers only; modality {m.name!r} uses encoder={m.encoder!r}. "
                "Use DP or ZeRO for conv towers."
            )
        for net in ("recog", "gener"):
            widths = _net_widths(m, net)
            depth = len(widths)
            if depth < 1 + n_stages:
                raise ValueError(
                    f"PP over {n_stages} stages needs depth >= {1 + n_stages} hidden layers "
                    f"per net (h1 stays replicated; h2..hL split across stages); "
                    f"{m.name}/{net} has {depth}. Deepen the arch dict "
                    "(configs.validate_arch) or use DP or ZeRO."
                )
            if len(set(widths)) != 1:
                raise ValueError(
                    f"PP pipelines a homogeneous middle: all hidden widths of "
                    f"{m.name}/{net} must be equal, got {widths}"
                )
            if (depth - 1) % n_stages:
                raise ValueError(
                    f"{m.name}/{net}: {depth - 1} pipelined layers (h2..h{depth}) not "
                    f"divisible by {n_stages} stages"
                )


def _resolve_n_micro(tc: TrainConfig, n_stages: int, n_micro=None, n_data: int = 1) -> int:
    """The microbatch count: ``n_micro``, 2·S by default, checked against
    the stages and the per-data-shard batch."""
    m = 2 * n_stages if n_micro is None else int(n_micro)
    if m < n_stages:
        raise ValueError(
            f"n_micro={m} < {n_stages} stages leaves devices permanently idle; use at "
            "least S (>= 2S recommended: bubble = (S-1)/(M+S-1))"
        )
    if tc.batch_size % n_data:
        raise ValueError(
            f"global batch {tc.batch_size} not divisible by the {n_data}-way data axis"
        )
    local = tc.batch_size // n_data
    if local % m:
        raise ValueError(
            f"per-data-shard batch {local} (= {tc.batch_size}/{n_data}) not divisible by "
            f"n_micro={m}"
        )
    return m


# ---------------------------------------------------------------------------
# The layout: whole TrainState ⇄ this stage's TrainState
# ---------------------------------------------------------------------------


class _Mid(nn.Module):
    """One stage's block of a net's middle layers: ``w`` [nper, W, W],
    ``b`` [nper, W] (zeros, to be filled)."""

    def __init__(self, nper: int, width: int, *, device):
        super().__init__()
        self.w = nn.Parameter(torch.zeros(nper, width, width, device=device))
        self.b = nn.Parameter(torch.zeros(nper, width, device=device))


class PPParams(nn.Module):
    """One stage's weights: per modality ``recog`` {h1, mid, out_mean,
    out_logvar} and ``gener`` {h1, mid, out}, the JAX layout's tree with
    ``mid`` this stage's block (zeros, to be filled)."""

    def __init__(self, cfg: AssocConfig, n_stages: int, *, device):
        super().__init__()

        def lin(n_in, n_out):
            return networks.Linear(n_in, n_out, device=device)

        mods = []
        for m in cfg.modalities:
            n_in, n_z = m.arch["n_input"], m.arch["n_z"]
            nets = {}
            for net, first, heads in (("recog", n_in, {"out_mean": n_z, "out_logvar": n_z}),
                                      ("gener", n_z, {"out": n_in})):
                widths = _net_widths(m, net)
                w = widths[0]
                layers = {"h1": lin(first + m.n_cond, w),
                          "mid": _Mid((len(widths) - 1) // n_stages, w, device=device)}
                layers.update({k: lin(w, n) for k, n in heads.items()})
                nets[net] = nn.ModuleDict(layers)
            mods.append(nn.ModuleDict(nets))
        self.modalities = nn.ModuleList(mods)


def _mid_source(key: str, cfg: AssocConfig, n_stages: int, stage: int) -> list:
    """The whole model's keys that stage ``stage``'s ``mid`` leaf ``key``
    stacks, in order (h2..hL cut into S blocks)."""
    _, k, net, _, leaf = key.split(".")
    depth = len(_net_widths(cfg.modalities[int(k)], net))
    nper = (depth - 1) // n_stages
    first = 2 + stage * nper
    return [f"modalities.{k}.{net}.h{i}.{leaf}" for i in range(first, first + nper)]


def _pp_keys(cfg: AssocConfig, n_stages: int) -> list:
    return [k for k, _ in PPParams(cfg, n_stages, device="meta").named_parameters()]


def shard_pp_train_state(mesh, state: TrainState, cfg: AssocConfig,
                         tc: TrainConfig) -> TrainState:
    """A whole TrainState (fresh, or restored from a checkpoint), the same on
    every rank, → this stage's: the middle layers of the weights and of
    every optimizer list stacked into its block, the rest as it is. The
    stacking copies values, so Adam on the blocks is the same arithmetic."""
    n, _ = _mesh_axes(mesh)
    check_pp(cfg, tc, n)
    stage = mesh.get_local_rank(STAGE_AXIS)
    names = [k for k, _ in state.params.named_parameters()]
    keys = _pp_keys(cfg, n)

    def cut(ts):
        by = dict(zip(names, (t.detach() for t in ts)))
        return [torch.stack([by[s] for s in _mid_source(k, cfg, n, stage)])
                if ".mid." in k else by[k].clone() for k in keys]

    model = PPParams(cfg, n, device=next(state.params.parameters()).device)
    with torch.no_grad():
        torch._foreach_copy_(list(model.parameters()), cut(state.params.parameters()))
    return TrainState(state.step, model, state.opt_state.map_lists(cut), state.seed)


@torch.no_grad()
def gather_pp_train_state(pstate: TrainState, cfg: AssocConfig, tc: TrainConfig,
                          mesh) -> TrainState:
    """Inverse of :func:`shard_pp_train_state`, on every rank: the stages'
    blocks gathered (one all-gather over the stage group) and unstacked to
    h2..hL, a whole TrainState that checkpoints, evaluates and serves like
    any. A collective over the mesh (every rank calls it)."""
    n, _ = _mesh_axes(mesh)
    group = mesh.get_group(STAGE_AXIS)
    keys = _pp_keys(cfg, n)
    mids = [i for i, k in enumerate(keys) if ".mid." in k]
    model = assoc_mod.AssocVAE(cfg, device=next(pstate.params.parameters()).device)
    names = [k for k, _ in model.named_parameters()]
    lists = [list(pstate.params.parameters())] + [
        l for l in pstate.opt_state.lists() if l is not None]
    shapes = [(n * lst[i].shape[0],) + tuple(lst[i].shape[1:]) for lst in lists for i in mids]
    got = iter(slices.gather_full([lst[i].reshape(-1) for lst in lists for i in mids], shapes,
                                  n, group))

    def uncut(ts):
        by = dict(zip(keys, ts))
        for i in mids:
            whole = next(got)
            for s in range(n):
                for j, src in enumerate(_mid_source(keys[i], cfg, n, s)):
                    by[src] = whole[s * whole.shape[0] // n + j]
        return [by[k].clone() for k in names]

    torch._foreach_copy_(list(model.parameters()), uncut(lists[0]))
    it = iter(lists[1:])
    return TrainState(pstate.step, model, pstate.opt_state.map_lists(lambda _: uncut(next(it))),
                      pstate.seed)


def init_pp_train_state(cfg: AssocConfig, tc: TrainConfig, mesh, *, params=None) -> TrainState:
    """Step 0 (from ``tc.seed``, or ``params``) in this layout, on this
    rank's device of ``mesh``: the card unless the mesh is of CPUs."""
    _mesh_axes(mesh)
    full = init_train_state(cfg, tc, params=params,
                            device=mesh_mod.mesh_device(mesh, "init_pp_train_state"))
    return shard_pp_train_state(mesh, full, cfg, tc)


# ---------------------------------------------------------------------------
# The pipelined forward
# ---------------------------------------------------------------------------


def _ring(mid, h0, sp, transfer):
    """[B, W] activations through the stage-sharded middle layers: this
    stage's block ``mid`` on each microbatch it holds, M + S − 1 ticks of
    GPipe fill and drain, the last stage's captures summed to every stage."""
    n, m, stage = sp.n_stages, sp.n_micro, sp.rank
    h0 = copy_to_model(h0, sp.group)
    b, w = h0.shape
    feeds = h0.reshape(m, b // m, w)
    first = torch.tensor(stage == 0, device=h0.device)
    last = torch.tensor(stage == n - 1, device=h0.device)
    layers = [SimpleNamespace(w=mid.w[i], b=mid.b[i]) for i in range(mid.w.shape[0])]
    buf = h0.new_zeros(b // m, w)
    caps = []
    for t in range(m + n - 1):
        h = torch.where(first, feeds[min(t, m - 1)], buf)
        for layer in layers:
            h = transfer(networks.linear(layer, h, sp.cd))
        if t >= n - 1:
            caps.append(torch.where(last, h, torch.zeros_like(h)))
        if t < m + n - 2:  # the last tick's shift would feed no one
            buf = ring_shift(h, sp.group, stage)
    return reduce_from_model(torch.cat(caps), sp.group)


def _pp_vae_forward(p, x, m, sp, *, seed=None, eps=None, cond=None):
    """One modality's encoder → sample → decoder with pipelined middles; the
    boundary layers are ``networks.encode_mlp`` / ``decode_mlp``'s math, ε
    the single-device step's (injected, or ``draw_eps(seed)``)."""
    transfer = TRANSFER_FNS[m.transfer]
    x_in = x.float() if cond is None else torch.cat([x.float(), cond], dim=1)
    r, g = p.recog, p.gener
    h = transfer(networks.linear(r["h1"], x_in, sp.cd))
    h = _ring(r["mid"], h, sp, transfer)
    mu = networks.linear(r["out_mean"], h, sp.cd)
    lv = networks.linear(r["out_logvar"], h, sp.cd)
    if eps is None:
        eps = vae_mod.draw_eps(seed, x.shape[0], m, x.device)
    z = sampling.reparameterize(mu, lv, eps=eps)
    z_in = z if cond is None else torch.cat([z, cond], dim=1)
    h = transfer(networks.linear(g["h1"], z_in, sp.cd))
    h = _ring(g["mid"], h, sp, transfer)
    return vae_mod.VAEOutputs(mu, lv, z, networks.linear(g["out"], h, sp.cd))


def _pp_loss(params, xs, cfg: AssocConfig, sp, *, seed=None, eps=None,
             parity_mode: bool = False, data_group=None):
    """The joint objective on this layout: the plain path of
    ``assoc.assoc_loss_fn`` with the pipelined per-modality forward."""
    xs, cond = assoc_mod.split_cond(xs, cfg)
    k = len(cfg.modalities)
    seeds = assoc_mod.modality_seeds(seed, k) if eps is None else [None] * k
    eps = [None] * k if eps is None else eps
    outs = [_pp_vae_forward(p, x, m, sp, seed=s, eps=e,
                            cond=vae_mod.prepare_cond(cond, m, x.shape[0], device=x.device))
            for p, x, m, s, e in zip(params.modalities, xs, cfg.modalities, seeds, eps)]
    return assoc_mod.joint_objective(outs, xs, cfg, parity_mode=parity_mode,
                                     data_group=data_group)


# ---------------------------------------------------------------------------
# The step
# ---------------------------------------------------------------------------


def make_pp_train_step(cfg: AssocConfig, tc: TrainConfig, mesh, *, n_micro=None):
    """The pipeline-parallel step: ``step_fn(pstate, xs, eps=None) ->
    (pstate', metrics)`` with the contract of ``make_dp_train_step``,
    except that the batch follows the mesh (``shard_pp_batch``): whole on
    every rank of a ``("stage",)`` mesh (the parallel axis is depth, not
    the batch), a rank's rows over ``data`` of a ``("stage", "data")`` one.
    The state is in this layout (``init_pp_train_state``). ``n_micro``
    (2·S by default) is the GPipe microbatch count per data shard; the
    bubble is (S−1)/(n_micro+S−1)."""
    n, data_axis = _mesh_axes(mesh)
    check_pp(cfg, tc, n)
    data_group = mesh.get_group(data_axis) if data_axis else None
    sp = SimpleNamespace(group=mesh.get_group(STAGE_AXIS), rank=mesh.get_local_rank(STAGE_AXIS),
                         n_stages=n, cd=tc.compute_dtype,
                         n_micro=_resolve_n_micro(tc, n, n_micro,
                                                  mesh.size(1) if data_axis else 1))
    opt = make_optimizer(tc, slices.split_norm([".mid." in k for k in _pp_keys(cfg, n)],
                                               sp.group))

    def one(state, xs, eps):
        params = list(state.params.parameters())
        total, metrics = _pp_loss(
            state.params, list(xs), cfg, sp, eps=eps, parity_mode=tc.parity_mode,
            seed=step_mod.step_seed_of_rank(state.seed, state.step, data_group),
            data_group=data_group)
        total, metrics = step_mod.apply_objective_weights(total, metrics, cfg, tc, state.step)
        grads = list(torch.autograd.grad(total, params))
        metrics = {k: v.detach() for k, v in metrics.items()}
        if data_group is not None:
            grads = step_mod.all_reduce_mean(grads, data_group)
            metrics = step_mod.mean_metrics(metrics, data_group)
        metrics["grad_norm"] = opt.norm_fn(grads)
        opt.update(grads, state.opt_state, params)
        return state._replace(step=state.step + 1), metrics

    return step_mod.stacked_steps(one, tc.steps_per_call)


def shard_pp_batch(mesh, xs, *, leading_scan_axis: bool = False, batch_axes=None) -> tuple:
    """A rank's batch of this layout on its device: whole on a ``("stage",)``
    mesh, its rows over ``data`` (whole over ``stage``) on a DP × PP mesh.
    ``batch_axes`` is ``shard_batch``'s; the mesh owns the placement, so
    any value but its data axis is rejected."""
    _, data_axis = _mesh_axes(mesh)
    if batch_axes is not None and batch_axes != data_axis:
        raise ValueError(
            f"shard_pp_batch takes the batch placement from the PP mesh (data axis: "
            f"{data_axis!r}); got batch_axes={batch_axes!r}"
        )
    if data_axis is None:
        return mesh_mod.replicate_batch(mesh, xs)
    return mesh_mod.shard_batch(mesh, xs, leading_scan_axis=leading_scan_axis,
                                batch_axes=data_axis)


def pp_train_loop(cfg: AssocConfig, tc: TrainConfig, data, mesh, *, epochs: int = 10,
                  state: TrainState | None = None, display_step: int = 1,
                  on_metrics=None, shuffle: bool = True, n_micro=None):
    """``dp_train_loop`` with the PP step: batches whole on a ``("stage",)``
    mesh, sharded over ``data`` under DP × PP; ``state`` in this layout."""
    _, data_axis = _mesh_axes(mesh)
    step_fn = make_pp_train_step(cfg, tc, mesh, n_micro=n_micro)
    if state is None:
        state = init_pp_train_state(cfg, tc, mesh)
    shard = (0, 1) if data_axis is None else mesh_mod.shard_index(mesh, (data_axis,))
    return _epoch_loop(tc, data, mesh, step_fn, state, shard=shard, epochs=epochs,
                       display_step=display_step, on_metrics=on_metrics, shuffle=shuffle)
