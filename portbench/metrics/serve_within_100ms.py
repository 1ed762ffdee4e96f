"""Share of the requests due in the window whose answer came within 100 ms
of its due time, in %, the last byte of the answer counted; a request that
failed or never came counts as late. 100 ms is the limit within which a
response feels immediate to its user (Card, Moran and Newell 1983)."""

LIMIT_S = 0.1


def read(obs):
    lat = obs.get("latencies_s")
    if not lat:
        return None
    return 100.0 * sum(x is not None and x <= LIMIT_S for x in lat) / len(lat)
