"""Requests answered in the window over the change of ``/statz``'s
``dispatches`` across it: the rows the micro-batcher coalesces into one
device call."""


def read(obs):
    d = obs.get("dispatches")
    return None if not d else obs["completed"] / d
