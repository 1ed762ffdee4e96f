"""The step's least time over the device's busy time a step in config 5's
one-card cell (readers.step_roofline)."""

from portbench.readers import step_roofline as read  # noqa: F401
