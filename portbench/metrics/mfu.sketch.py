"""The whole step's share of the card's peak in the Sketch-RNN training cell
(readers.mfu; the step's FLOPs counted over reference/sketch_rnn.py)."""

from portbench.readers import mfu as read  # noqa: F401
