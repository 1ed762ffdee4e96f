"""Median host time of a ``Predictor.cross_generate`` call in the window
(bucketing, host to device copies, the kernels, the copy back), timed by
the wrapper the harness sets on the predictor it built."""

import statistics


def read(obs):
    d = obs.get("dispatch_s")
    return None if not d else statistics.median(d) * 1e3
