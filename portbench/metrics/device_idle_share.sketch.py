"""Idle share of the traced window in the Sketch-RNN training cell (readers.idle_share)."""

from portbench.readers import idle_share as read  # noqa: F401
