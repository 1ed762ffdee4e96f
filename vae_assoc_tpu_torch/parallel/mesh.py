"""Process groups, device meshes and batch sharding (counterpart of
vae_assoc_tpu/parallel/mesh.py).

The JAX package drives every device of a host from one process; here each
process drives one device and joins a ``torch.distributed`` process group,
so a mesh of N devices is N processes. ``make_mesh`` lays them out as a
``DeviceMesh`` with the JAX axis names: a 1-D ``("data",)`` mesh, or a 2-D
``("data", "model")`` one whose model groups are consecutive ranks.

The backend is chosen, never fallen back to: NCCL for a mesh of CUDA
devices, gloo for one of CPUs (the tests' multi-process meshes), or what
``init_distributed(backend=)`` names. A rank's device is
``cuda:<rank mod the visible devices>``, so two ranks on one card share it
(over gloo: NCCL refuses two ranks on one device).

``shard_batch`` gives a rank the rows ``[r·B/W, (r+1)·B/W)`` of a global
batch, the order of JAX's ``P("data")``, so rank r holds what JAX's device
r holds; ``replicate`` broadcasts a state from the mesh's first rank.
"""

from __future__ import annotations

import os
import tempfile
import time
from datetime import timedelta
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from vae_assoc_tpu_torch.models.networks import cuda_or_raise

DATA_AXIS = "data"
MODEL_AXIS = "model"
BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


def local_device(device_type: str = "cuda", what: str = "local_device") -> torch.device:
    """This process's device: ``cuda:<rank mod the visible devices>``
    (``cuda:0`` outside a process group), or the CPU. Without a GPU
    ``"cuda"`` raises, naming ``what`` asked for it."""
    device = cuda_or_raise(device_type, what)
    if device.type != "cuda":
        return torch.device("cpu")
    rank = dist.get_rank() if dist.is_initialized() else 0
    return torch.device("cuda", rank % torch.cuda.device_count())


def init_distributed(backend: Optional[str] = None, *, init_method: str = "env://",
                     rank: Optional[int] = None, world_size: Optional[int] = None,
                     device_type: str = "cuda", timeout_s: float = 600.0) -> None:
    """Join the default process group, unless this process has joined one.

    ``backend`` defaults to NCCL for ``device_type="cuda"`` (which raises
    without a card) and gloo for ``"cpu"``. ``init_method`` is
    torch.distributed's: ``"env://"`` reads ``MASTER_ADDR``/``MASTER_PORT``,
    ``RANK`` and ``WORLD_SIZE`` as torchrun sets them; ``"file://<path>"``
    (a fresh path all ranks share) or ``"tcp://host:port"`` need ``rank``
    and ``world_size``. A CUDA process binds its device first."""
    if dist.is_initialized():
        return
    device = cuda_or_raise(device_type, "init_distributed")
    backend = backend or BACKENDS[device.type]
    kw = {}
    if rank is not None:
        kw.update(rank=rank, world_size=world_size)
    if device.type == "cuda":
        r = rank if rank is not None else int(os.environ.get("RANK", 0))
        torch.cuda.set_device(r % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=init_method,
                            timeout=timedelta(seconds=timeout_s), **kw)


def make_mesh(n_devices: Optional[int] = None, *, data_axis: str = DATA_AXIS,
              model_axis: Optional[str] = None, model_parallel: int = 1,
              device_type: str = "cuda") -> DeviceMesh:
    """A 1-D ``(data_axis,)`` mesh over the process group (the default), or a
    2-D ``(data_axis, model_axis)`` mesh of ``n // model_parallel`` ×
    ``model_parallel``, each model group consecutive ranks.

    ``n_devices`` must be the group's size (every process is one device);
    the default group is joined first, with ``init_distributed``'s
    defaults, where it is not yet. ``device_type`` is the card unless the
    caller names the CPU; without a GPU ``"cuda"`` raises."""
    cuda_or_raise(device_type, "make_mesh")
    init_distributed(device_type=device_type)
    world = dist.get_world_size()
    n = world if n_devices is None else n_devices
    if n != world:
        raise ValueError(
            f"requested {n} devices, but the process group has {world} processes "
            "(one device each)"
        )
    if model_axis is None:
        return init_device_mesh(device_type, (n,), mesh_dim_names=(data_axis,))
    if n % model_parallel:
        raise ValueError(f"{n} devices not divisible by model_parallel={model_parallel}")
    return init_device_mesh(device_type, (n // model_parallel, model_parallel),
                            mesh_dim_names=(data_axis, model_axis))


def make_multihost_mesh(*, dcn_axis: str = "replica", data_axis: str = DATA_AXIS,
                        device_type: str = "cuda") -> DeviceMesh:
    """A 2-level ``(dcn_axis, data_axis)`` mesh: hosts × each host's devices,
    from ``LOCAL_WORLD_SIZE`` (as torchrun sets it; the whole group on one
    host without it). Pass ``batch_axes=(dcn_axis, data_axis)`` to
    ``make_dp_train_step`` so the batch shards over both levels."""
    cuda_or_raise(device_type, "make_multihost_mesh")
    init_distributed(device_type=device_type)
    world = dist.get_world_size()
    local = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    if world % local:
        raise ValueError(f"{world} processes are not whole hosts of {local}")
    return init_device_mesh(device_type, (world // local, local),
                            mesh_dim_names=(dcn_axis, data_axis))


def mesh_device(mesh: DeviceMesh, what: str = "mesh_device") -> torch.device:
    """The device this process drives in ``mesh``."""
    return local_device(mesh.device_type, what)


class BatchSpec(NamedTuple):
    """Where a batch shards: its batch dimension and the mesh axes over it
    (the counterpart of the JAX package's PartitionSpec)."""

    dim: int
    axes: tuple


def batch_spec(mesh: DeviceMesh, *, leading_scan_axis: bool = False,
               batch_axes=None) -> BatchSpec:
    """The batch dim of [B, D] (or [N, B, D]) arrays, sharded over
    ``batch_axes`` (the first mesh axis by default; a tuple spans several)."""
    axes = batch_axes if batch_axes is not None else mesh.mesh_dim_names[0]
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    unknown = [a for a in axes if a not in mesh.mesh_dim_names]
    if unknown:
        raise ValueError(f"batch axes {unknown} are not axes of the mesh "
                         f"{mesh.mesh_dim_names}")
    return BatchSpec(1 if leading_scan_axis else 0, axes)


def shard_index(mesh: DeviceMesh, axes) -> tuple:
    """(this rank's index, the number of shards) over mesh ``axes``, the
    first axis outermost, as JAX orders ``P(("replica", "data"))``."""
    index, count = 0, 1
    for a in axes:
        size = mesh.size(mesh.mesh_dim_names.index(a))
        index, count = index * size + mesh.get_local_rank(a), count * size
    return index, count


def shard_rows(batch: int, index: int, count: int) -> slice:
    """Rows ``[index·B/count, (index+1)·B/count)`` of a global batch of B."""
    if batch % count:
        raise ValueError(f"global batch {batch} not divisible by {count} devices")
    per = batch // count
    return slice(index * per, (index + 1) * per)


def shard_batch(mesh: DeviceMesh, arrays, *, leading_scan_axis: bool = False,
                batch_axes=None) -> tuple:
    """This rank's rows of each global batch array (numpy or tensor) on its
    device, batch-dim sharded as :func:`batch_spec` says."""
    spec = batch_spec(mesh, leading_scan_axis=leading_scan_axis, batch_axes=batch_axes)
    index, count = shard_index(mesh, spec.axes)
    dev = mesh_device(mesh)
    out = []
    for a in arrays:
        t = torch.as_tensor(np.asarray(a) if not isinstance(a, torch.Tensor) else a)
        rows = shard_rows(t.shape[spec.dim], index, count)
        t = t[:, rows] if spec.dim else t[rows]
        out.append(t.to(dev, torch.float32).contiguous())
    return tuple(out)


def replicate_batch(mesh: DeviceMesh, arrays, *, leading_scan_axis: bool = False) -> tuple:
    """Every batch array whole on this rank's device: the placement of a
    layout whose ranks split the model, not the batch (pure TP, PP)."""
    del leading_scan_axis
    dev = mesh_device(mesh)
    return tuple(torch.as_tensor(a).to(dev, torch.float32).contiguous() for a in arrays)


def _tensors(tree) -> list:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, torch.nn.Module):
        return list(tree.parameters()) + list(tree.buffers())
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensors(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensors(v)]
    if hasattr(tree, "__dict__"):
        return _tensors(vars(tree))
    return []


@torch.no_grad()
def replicate(mesh: DeviceMesh, tree):
    """Broadcast every tensor of ``tree`` (a TrainState, a module, lists and
    dicts of tensors) from the mesh's first rank to all of it, in place, in
    one bucket; returns ``tree``. Python numbers are the same on every rank
    by construction (the step, the seed)."""
    tensors = _tensors(tree)
    if not tensors:
        return tree
    flat = torch.cat([t.detach().reshape(-1).float() for t in tensors])
    src = int(mesh.mesh.reshape(-1)[0])
    dist.broadcast(flat, src=src)
    for t, v in zip(tensors, flat.split([t.numel() for t in tensors])):
        t.copy_(v.view_as(t))
    return tree


def spawn(fn, world_size: int, args=(), *, device_type: str = "cuda",
          backend: Optional[str] = None, timeout_s: float = 300.0) -> list:
    """Run ``fn(rank, *args)`` in ``world_size`` fresh processes that form a
    process group over a file store, and return their results by rank.

    A local launcher for the multi-process layouts: ranks on the card (the
    default, which raises without one), or gloo processes on the CPU where
    the caller names it (the tests). ``fn`` must be importable by name (the
    processes start from a fresh interpreter) and its result picklable.
    Raises if a process fails or the run outlasts ``timeout_s``; every
    process is stopped before it returns."""
    import multiprocessing as mp
    import pickle

    cuda_or_raise(device_type, "spawn")
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp:
        store = os.path.join(tmp, "store")
        procs = [ctx.Process(target=_spawned, args=(fn, r, world_size, args, device_type,
                                                    backend, store, tmp, timeout_s))
                 for r in range(world_size)]
        for p in procs:
            p.start()
        try:
            # Stop waiting at the first failure: the other ranks would wait
            # in a collective for it until the group's timeout.
            deadline = time.monotonic() + timeout_s
            while (any(p.is_alive() for p in procs) and time.monotonic() < deadline
                   and not any(p.exitcode for p in procs)):
                time.sleep(0.05)
            if not any(p.exitcode for p in procs) and any(p.is_alive() for p in procs):
                raise TimeoutError(f"{world_size} ranks did not finish in {timeout_s} s")
            bad = [(r, p.exitcode) for r, p in enumerate(procs) if p.exitcode]
            if bad:
                errs = [open(os.path.join(tmp, f"err{r}")).read()
                        if os.path.exists(os.path.join(tmp, f"err{r}")) else f"exit code {c}"
                        for r, c in bad]
                raise RuntimeError(f"ranks {[r for r, _ in bad]} failed:\n" + "\n".join(errs))
            out = []
            for r in range(world_size):
                with open(os.path.join(tmp, f"out{r}"), "rb") as f:
                    out.append(pickle.load(f))  # written by this function's processes
            return out
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                p.join()


def _spawned(fn, rank, world_size, args, device_type, backend, store, tmp, timeout_s):
    import pickle
    import traceback

    try:
        torch.set_num_threads(1)
        init_distributed(backend, init_method=f"file://{store}", rank=rank,
                         world_size=world_size, device_type=device_type,
                         timeout_s=timeout_s)
        try:
            result = fn(rank, *args)
        finally:
            dist.destroy_process_group()
        with open(os.path.join(tmp, f"out{rank}"), "wb") as f:
            pickle.dump(result, f)
    except BaseException:
        with open(os.path.join(tmp, f"err{rank}"), "w") as f:
            f.write(f"rank {rank}:\n{traceback.format_exc()}")
        raise
