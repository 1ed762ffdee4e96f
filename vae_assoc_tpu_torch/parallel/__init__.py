"""Parallel layouts over torch.distributed that keep the kernels
(counterpart of vae_assoc_tpu/parallel/).

``mesh``: process groups, device meshes and batch sharding. ``dp``: data
parallelism. ``zero``: ZeRO-sharded state, also under the reference's FSDP
names (``fsdp``). ``tp``: Megatron tensor parallelism around the stack
kernels, and DP × TP on a 2-D mesh; its names are the reference's
``tp_shard`` ones (namespaced as ``tp_shard`` here too) and, at this
level, its GSPMD ``tp`` ones. The pipeline and the TP × FSDP composition
are not ported yet.
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
from vae_assoc_tpu_torch.parallel.tp import (
    init_tp_train_state,
    make_tp_train_step,
    shard_params,
    shard_tp_batch,
    shard_tp_train_state,
    tp_param_specs,
    tp_train_loop,
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
    "shard_zero_train_state",
    "gather_zero_train_state",
    "make_zero_train_step",
    "init_zero_train_state",
    "zero_train_loop",
    "tp_param_specs",
    "shard_params",
    "shard_tp_batch",
    "shard_tp_train_state",
    "make_tp_train_step",
    "init_tp_train_state",
    "tp_train_loop",
    "tp_shard",
]
