"""The whole step's share of the card's peak in the kernel-bound training cells (readers.mfu)."""

from portbench.readers import mfu as read  # noqa: F401
