"""The recurrences' least time a step over the ``lstm_*`` kernels' device
time a step, in percent. The least time is the larger of their FLOPs over
the bf16 peak (per LSTM and direction 2·B·N·(n_in + H)·4H forward, twice
that backward) and their compulsory bytes over the memory rate (weights
once; gate pre-activations and the h and c sequences written once and read
once): counted from the work, not the launches (reference/sketch_rnn.py)."""


def read(obs):
    ks = obs.get("kernel_s")
    if not ks or "lstm_least_step_s" not in obs:
        return None
    lstm = ks["lstm_fwd"] + ks["lstm_bwd"]
    return 100.0 * obs["lstm_least_step_s"] * obs["trace_steps"] / lstm if lstm else None
