"""The change of the ``lstm_fwd``, ``lstm_bwd`` and ``mixture_loss`` launch
counters across the traced window, per training step (a replay adds the
captured step's counts)."""


def read(obs):
    n = obs.get("sketch_launches")
    return None if n is None or not obs.get("trace_steps") else n / obs["trace_steps"]
