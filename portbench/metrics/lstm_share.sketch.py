"""The ``lstm_fwd`` and ``lstm_bwd`` kernels' device time over the device's
busy time in the traced window, in percent: the recurrences' share of the
work (traffic/train_sketch.py sums the kernels by name)."""


def read(obs):
    tr, ks = obs.get("trace"), obs.get("kernel_s")
    if not tr or not tr["busy_s"] or not ks:
        return None
    lstm = ks["lstm_fwd"] + ks["lstm_bwd"]
    return 100.0 * lstm / tr["busy_s"] if lstm else None
