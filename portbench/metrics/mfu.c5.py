"""The whole step's share of the card's peak in config 5's one-card cell (readers.mfu)."""

from portbench.readers import mfu as read  # noqa: F401
