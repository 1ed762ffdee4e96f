"""Faults that a test plants in a rank of the data-parallel driver
(``traffic/train_dp.run(ctx, plant=...)``): each rank calls the function
first, and the fault holds in that process until it ends."""

from __future__ import annotations


def state_unchanged():
    """The optimizer's update skipped: every step returns its state unchanged."""
    from vae_assoc_tpu_torch.train import step

    step.Optimizer.update = lambda self, grads, state, params, **kw: None


def half_batch():
    """Each rank's means taken over the first half of its rows."""
    from vae_assoc_tpu_torch.models import assoc

    whole = assoc.assoc_loss_fn

    def half(params, xs, cfg, **kw):
        return whole(params, [x[: x.shape[0] // 2] for x in xs], cfg, **kw)

    assoc.assoc_loss_fn = half


def no_allreduce():
    """The exchange between ranks left out: each rank steps on its own
    gradient and logs its own metrics."""
    from vae_assoc_tpu_torch.train import step

    step.all_reduce_mean = lambda tensors, group: list(tensors)
    step.mean_metrics = lambda metrics, group: metrics


def loads_jax():
    """A rank that loads a module named as the JAX package's top level."""
    import sys
    import types

    sys.modules["jax"] = types.ModuleType("jax")
