"""Open-loop load generator for the HTTP serving cells: a child process of its own.

    python3 portbench/traffic/loadgen.py --port P --seed S --rate R --seconds T \
        [--pool N] [--sample K] [--warm W] [--src image --dst trajectory]

Imports numpy and the standard library only. It makes ``--pool`` request
images from the seed (``pool_images``, which the harness calls too, for
the reference), sends ``--warm`` requests one after another, reads
``/statz``, prints ``ready``, waits for a line on its standard input,
prints ``start`` and then sends one request of one row each at times given
by Poisson gaps at ``--rate`` a second for ``--seconds``: an open loop,
every request on a new connection at its due time, whether or not earlier
ones were answered. Every seed sends at the same times (``schedule``), its
own sequence of pool images. A request's latency runs from its due time to the last
byte of its answer, so a late send counts against the server's time.
Answers are awaited up to ``GRACE_S`` past the window's close.

The last line of its output is one JSON object: every request's latency in
seconds (null where it failed or never came), how late the sends ran, the
change of ``/statz``'s ``dispatches`` over the window, and ``--sample``
answers chosen from the seed with their pool indices.
"""

from __future__ import annotations

import argparse
import asyncio
import gc
import json
import math
import sys
import time

import numpy as np

GAP_STREAM = 20260917  # the fixed stream of the gaps' multiset
GRACE_S = 60.0


def pool_images(seed: int, n: int, d: int = 784) -> np.ndarray:
    """[n, d] request images as a client sends them: each has its own ink
    share in U(0.05, 0.5); an inked pixel is one of the levels 64/255 … 1,
    written to four decimals."""
    rng = np.random.default_rng([int(seed), 3])
    ink = rng.random((n, 1)) * 0.45 + 0.05
    on = rng.random((n, d)) < ink
    level = np.round(np.floor(rng.random((n, d)) * 192.0 + 64.0) / 255.0, 4)
    return np.where(on, level, 0.0)


def schedule(rate: float, seconds: float) -> np.ndarray:
    """Due offsets [n] in seconds: exponential gaps with mean 1/rate from a
    fixed stream, scaled to fill ``seconds``. Every seed gets these same
    arrivals: the order of bursts sets the tail, and a seed that changed it
    would change the work."""
    n = max(1, int(round(rate * seconds)))
    gaps = np.random.default_rng(GAP_STREAM).exponential(1.0, n)
    gaps *= seconds / gaps.sum()
    return np.cumsum(gaps) - gaps[0]


def percentile(values, q: float) -> float:
    """Nearest-rank percentile; None (a request never answered) ranks last."""
    v = sorted(math.inf if x is None else x for x in values)
    return v[max(0, math.ceil(q / 100.0 * len(v)) - 1)]


async def _http(host, port, method, path, body=b""):
    reader, writer = await asyncio.open_connection(host, port)
    try:
        writer.write(f"{method} {path} HTTP/1.1\r\nHost: {host}\r\nContent-Type: application/json\r\n"
                     f"Content-Length: {len(body)}\r\nConnection: close\r\n\r\n".encode() + body)
        await writer.drain()
        data = await reader.read()
    finally:
        writer.close()
    head, _, payload = data.partition(b"\r\n\r\n")
    status = int(head.split(b" ", 2)[1]) if head else 0
    return status, payload


async def _drive(args, bodies, order, due):
    host, port = "127.0.0.1", args.port
    route = "/v1/cross_generate"
    for i in range(args.warm):
        await _http(host, port, "POST", route, bodies[i % len(bodies)])
    _, statz = await _http(host, port, "GET", "/statz")
    d0 = json.loads(statz)["dispatches"]
    n = len(due)
    lat, late, answers = [None] * n, np.zeros(n), [None] * n

    async def one(i, t_due):
        try:
            status, payload = await _http(host, port, "POST", route, bodies[order[i]])
        except OSError:
            return
        if status == 200:
            lat[i] = time.perf_counter() - t_due
            answers[i] = payload

    print("ready", flush=True)
    sys.stdin.readline()
    gc.collect()
    gc.disable()  # no collector pause in the generator makes a send late
    print("start", flush=True)
    loop_t0 = time.perf_counter()
    tasks = []
    for i, off in enumerate(due):
        t_due = loop_t0 + off
        wait = t_due - time.perf_counter()
        if wait > 2e-3:  # the loop's timers tick in milliseconds: sleep, then yield
            await asyncio.sleep(wait - 1e-3)
        while time.perf_counter() < t_due:
            await asyncio.sleep(0)
        late[i] = time.perf_counter() - t_due
        tasks.append(asyncio.create_task(one(i, t_due)))
    sent_s = time.perf_counter() - loop_t0
    await asyncio.wait(tasks, timeout=GRACE_S)
    window_s = time.perf_counter() - loop_t0
    gc.enable()
    _, statz = await _http(host, port, "GET", "/statz")
    d1 = json.loads(statz)["dispatches"]
    done = [i for i in range(n) if answers[i] is not None]
    rng = np.random.default_rng([args.seed, 5])
    pick = sorted(rng.choice(done, size=min(args.sample, len(done)), replace=False).tolist()) if done else []
    return {
        "latencies_s": lat, "sent_s": sent_s, "window_s": window_s,
        "late_s": {"p50": float(np.percentile(late, 50)), "p99": float(np.percentile(late, 99)),
                   "max": float(late.max())},
        "dispatches": d1 - d0, "completed": len(done), "attempted": n,
        "sample": {"request": pick, "pool": [int(order[i]) for i in pick],
                   "outputs": [json.loads(answers[i])["outputs"][0] for i in pick]},
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--port", type=int, required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--rate", type=float, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--pool", type=int, default=1024)
    p.add_argument("--sample", type=int, default=256)
    p.add_argument("--warm", type=int, default=64)
    p.add_argument("--src", default="image")
    p.add_argument("--dst", default="trajectory")
    args = p.parse_args(argv)
    images = pool_images(args.seed, args.pool)
    bodies = [json.dumps({"inputs": [row], "src": args.src, "dst": args.dst}).encode()
              for row in images.tolist()]
    due = schedule(args.rate, args.seconds)
    order = np.random.default_rng([args.seed, 6]).integers(0, args.pool, len(due))
    out = asyncio.run(_drive(args, bodies, order, due))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
