"""Median of the program's ``train.step`` spans in the kernel-bound
training cells: the host time of one ``_one_step``."""

from portbench.spantrace import median_span_ms


def read(obs):
    return median_span_ms(obs, "train.step")
