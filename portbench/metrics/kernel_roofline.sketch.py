"""The step's least time over the device's busy time a step in the
Sketch-RNN training cell (readers.step_roofline)."""

from portbench.readers import step_roofline as read  # noqa: F401
