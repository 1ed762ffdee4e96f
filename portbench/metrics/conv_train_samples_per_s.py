"""Training samples a second of the conv training cell, which the host
bounds: a metric of its own, so that its host noise does not widen the
bound of the kernel-bound cells (readers.samples_per_s)."""

from portbench.readers import samples_per_s as read  # noqa: F401
