"""95th percentile of the latencies ``latency_p50_ms.serve`` takes the median of."""

from portbench.traffic.loadgen import percentile


def read(obs):
    lat = obs.get("latencies_s")
    return None if not lat else percentile(lat, 95) * 1e3
