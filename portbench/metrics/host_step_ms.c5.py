"""Median of the program's ``train.step`` spans in config 5's one-card cell:
the host time of one step (a replay of the captured step)."""

from portbench.spantrace import median_span_ms


def read(obs):
    return median_span_ms(obs, "train.step")
