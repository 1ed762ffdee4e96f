"""Median of the program's ``train.step`` spans in the small-batch cells:
the host time of one ``_one_step`` (forward, backward, optimizer)."""

from portbench.spantrace import median_span_ms


def read(obs):
    return median_span_ms(obs, "train.step")
