"""The mixture loss's least time a step over the ``mixture_loss`` kernel's
device time a step, in percent: its compulsory bytes (the head output and
the targets read once, the gradient written once) over the memory rate
(reference/sketch_rnn.py::mixture_bytes)."""


def read(obs):
    ks = obs.get("kernel_s")
    if not ks or not ks["mixture_loss"] or "mixture_least_step_s" not in obs:
        return None
    return 100.0 * obs["mixture_least_step_s"] * obs["trace_steps"] / ks["mixture_loss"]
