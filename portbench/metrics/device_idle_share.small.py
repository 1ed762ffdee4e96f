"""Idle share of the traced window in the small-batch cells (readers.idle_share)."""

from portbench.readers import idle_share as read  # noqa: F401
