"""Training samples a second of the host-bound small-batch step: a metric
of its own, so that host noise does not widen the kernel-bound cells'
bound (readers.samples_per_s)."""

from portbench.readers import samples_per_s as read  # noqa: F401
