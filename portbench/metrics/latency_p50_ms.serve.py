"""Median latency of the requests due in the window, from when each was due
to the last byte of its answer; a request that failed counts as never
answered. Per-layer: on a shared host its runs spread by more than any
bound holds, so ``serve_within_100ms`` is the cell's end-to-end metric."""

from portbench.traffic.loadgen import percentile


def read(obs):
    lat = obs.get("latencies_s")
    return None if not lat else percentile(lat, 50) * 1e3
