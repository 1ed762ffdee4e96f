"""Parallel layouts over torch.distributed that keep the kernels
(counterpart of vae_assoc_tpu/parallel/).

``mesh``: process groups, device meshes and batch sharding. ``dp``: data
parallelism. ``zero``: ZeRO-sharded state, also under the reference's FSDP
names (``fsdp``). ``tp``: Megatron tensor parallelism around the stack
kernels (and channel splits of conv towers), and DP × TP on a 2-D mesh;
the module's own step names are the reference's ``tp_shard`` ones
(namespaced as ``tp_shard`` here too, with its refusals), and at this
level ``make_tp_train_step`` and ``tp_train_loop`` are its GSPMD ``tp``
ones, which take conv towers, ``remat`` and ``parity_mode``.
``tp_fsdp``: the TP shards cut into ZeRO's slices over the data axis.
``pp``: the GPipe ring over deep MLP towers, and DP × PP. ``slices``: the
flat padded slices the sharded-state layouts store.
"""

from vae_assoc_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    batch_spec,
    init_distributed,
    make_mesh,
    make_multihost_mesh,
    replicate,
    shard_batch,
)
from vae_assoc_tpu_torch.parallel.dp import (
    dp_train_loop,
    init_dp_train_state,
    make_dp_train_step,
)
from vae_assoc_tpu_torch.parallel.fsdp import (
    fsdp_param_specs,
    fsdp_train_loop,
    init_fsdp_train_state,
    make_fsdp_train_step,
    shard_fsdp_train_state,
)
from vae_assoc_tpu_torch.parallel.zero import (
    gather_zero_train_state,
    init_zero_train_state,
    make_zero_train_step,
    shard_zero_train_state,
    zero_train_loop,
)
from vae_assoc_tpu_torch.parallel.tp_fsdp import (
    gather_tp_fsdp_train_state,
    init_tp_fsdp_train_state,
    make_tp_fsdp_train_step,
    shard_tp_fsdp_train_state,
    tp_fsdp_param_specs,
    tp_fsdp_train_loop,
)
from vae_assoc_tpu_torch.parallel.pp import (
    STAGE_AXIS,
    check_pp,
    gather_pp_train_state,
    init_pp_train_state,
    make_pp_mesh,
    make_pp_train_step,
    pp_train_loop,
    shard_pp_batch,
    shard_pp_train_state,
)
from vae_assoc_tpu_torch.parallel.tp import (
    gspmd_tp_train_loop as tp_train_loop,
    init_tp_train_state,
    make_gspmd_tp_train_step as make_tp_train_step,
    shard_params,
    shard_tp_batch,
    shard_tp_train_state,
    tp_param_specs,
)
from vae_assoc_tpu_torch.parallel import tp as tp_shard

__all__ = [
    "make_mesh",
    "make_multihost_mesh",
    "batch_spec",
    "shard_batch",
    "replicate",
    "init_distributed",
    "DATA_AXIS",
    "MODEL_AXIS",
    "make_dp_train_step",
    "init_dp_train_state",
    "dp_train_loop",
    "fsdp_param_specs",
    "shard_fsdp_train_state",
    "make_fsdp_train_step",
    "init_fsdp_train_state",
    "fsdp_train_loop",
    "tp_fsdp_param_specs",
    "shard_tp_fsdp_train_state",
    "gather_tp_fsdp_train_state",
    "make_tp_fsdp_train_step",
    "init_tp_fsdp_train_state",
    "tp_fsdp_train_loop",
    "shard_zero_train_state",
    "gather_zero_train_state",
    "make_zero_train_step",
    "init_zero_train_state",
    "zero_train_loop",
    "STAGE_AXIS",
    "make_pp_mesh",
    "check_pp",
    "shard_pp_batch",
    "shard_pp_train_state",
    "gather_pp_train_state",
    "make_pp_train_step",
    "init_pp_train_state",
    "pp_train_loop",
    "tp_param_specs",
    "shard_params",
    "shard_tp_batch",
    "shard_tp_train_state",
    "make_tp_train_step",
    "init_tp_train_state",
    "tp_train_loop",
    "tp_shard",
]
