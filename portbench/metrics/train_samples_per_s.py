"""Training samples a second of the kernel-bound training cells
(readers.samples_per_s)."""

from portbench.readers import samples_per_s as read  # noqa: F401
