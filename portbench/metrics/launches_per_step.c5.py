"""Kernels the card ran in config 5's one-card traced window, the program's
and PyTorch's, per training step."""


def read(obs):
    tr = obs.get("trace")
    return None if not tr or not obs.get("trace_steps") else tr["launches"] / obs["trace_steps"]
