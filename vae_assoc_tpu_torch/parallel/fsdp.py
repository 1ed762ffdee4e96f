"""Fully-sharded data parallelism (counterpart of vae_assoc_tpu/parallel/fsdp.py).

In the port these names are the ZeRO layout of ``parallel/zero.py``: every
parameter and optimizer leaf flattened, padded and sharded over the
``("data",)`` mesh, the weights all-gathered once a step, the gradients
reduce-scattered, Adam on the local slices. The JAX package needed a
second, GSPMD layout only because its partitioner cannot split a
``pallas_call``, so its FSDP ran the jnp model path alone; a layout of
explicit collectives around the unchanged model keeps every kernel, so
the port has one implementation and keeps both sets of names. It takes
``use_pallas`` and ``encoder="conv_pallas"``, which the JAX package's
FSDP rejects.

``torch.distributed.fsdp.fully_shard`` is not used: its hooks unshard the
parameters only through ``nn.Module.__call__``, and the port's model is
read as a parameter tree (``assoc_loss_fn(params, ...)``); the kernels
take plain contiguous fp32 tensors, not DTensor shards.
"""

from __future__ import annotations

from vae_assoc_tpu_torch.configs import AssocConfig, TrainConfig
from vae_assoc_tpu_torch.models.assoc import AssocVAE
from vae_assoc_tpu_torch.parallel import slices, zero
from vae_assoc_tpu_torch.train.step import TrainState


def fsdp_param_specs(cfg: AssocConfig, n_shards: int) -> dict:
    """How each parameter lies in the layout: its state_dict key →
    (full shape, length of a rank's flat slice), the slice being
    ``ceil(numel / n_shards)`` (the flat tensor padded with zeros)."""
    return {k: (tuple(p.shape), slices.pad_len(p.numel(), n_shards) // n_shards)
            for k, p in AssocVAE(cfg, device="meta").named_parameters()}


def shard_fsdp_train_state(mesh, state: TrainState, cfg: AssocConfig,
                           tc: TrainConfig) -> TrainState:
    """``zero.shard_zero_train_state``."""
    return zero.shard_zero_train_state(mesh, state, cfg, tc)


def init_fsdp_train_state(cfg: AssocConfig, tc: TrainConfig, mesh, *,
                          params=None) -> TrainState:
    """``zero.init_zero_train_state``."""
    return zero.init_zero_train_state(cfg, tc, mesh, params=params)


def make_fsdp_train_step(cfg: AssocConfig, tc: TrainConfig, mesh):
    """``zero.make_zero_train_step``."""
    return zero.make_zero_train_step(cfg, tc, mesh)


def fsdp_train_loop(cfg: AssocConfig, tc: TrainConfig, data, mesh, **kw):
    """``zero.zero_train_loop``."""
    return zero.zero_train_loop(cfg, tc, data, mesh, **kw)
