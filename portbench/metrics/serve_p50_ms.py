"""Median latency of the requests due in the window, from when each was due
to the last byte of its answer; a request that failed counts as never
answered."""

from portbench.traffic.loadgen import percentile


def read(obs):
    lat = obs.get("latencies_s")
    return None if not lat else percentile(lat, 50) * 1e3
