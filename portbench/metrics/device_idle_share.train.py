"""Idle share of the traced window in the kernel-bound training cells (readers.idle_share)."""

from portbench.readers import idle_share as read  # noqa: F401
