"""Idle share of the traced window in config 5's one-card cell (readers.idle_share)."""

from portbench.readers import idle_share as read  # noqa: F401
