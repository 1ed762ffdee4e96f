"""Seconds from the start of the run's process to the start of its window:
imports, the kernel library's build or load, inputs and weights, the
output check's program side, and the warm-up."""


def read(obs):
    return obs["setup_s"]
