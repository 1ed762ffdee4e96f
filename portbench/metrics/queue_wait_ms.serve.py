"""Median of the program's ``batcher.queue`` spans: a request's wait from
``MicroBatcher.submit`` to the start of the dispatch that carries it."""

from portbench.spantrace import median_span_ms


def read(obs):
    return median_span_ms(obs, "batcher.queue")
