"""Find the knee of a serving cell: the highest offered rate whose backlog does not grow.

    python3 portbench/sweep_serve.py --workload c3-serve-http-poisson \
        --rates 500 1000 2000 --seconds 8 --seed 7 [--out FILE]

Builds the cell's server once (as a run's set-up does) and offers each rate
in turn for ``--seconds`` through the load generator. Each window is judged
by two tests, and the knee is given under each:

- backlog: every request is answered, and the median latency of the last
  quarter of the requests (by due time) is at most twice that of the first
  quarter: a backlog that grows over the window raises the later
  latencies;
- tail: the backlog test, and besides no request waits a second or more
  and the answers end within a second of the last send. A connection that
  the listen queue dropped waits for TCP's retransmission (1 s, then 3, 7,
  15 s), which a user sees as a stall.

``--repeats`` windows are offered at each rate, in the order given; a rate
holds under a test when every window does, and the knee is the highest rate
up to which every rate held. Prints one JSON line per window, then both
knees.
The cell's rate is fixed in its mix at about 0.8 of the tail knee.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import calibrate, run  # noqa: E402
from portbench.traffic import loadgen, serve_http  # noqa: E402


def backlog_held(result: dict) -> bool:
    lat = result["latencies_s"]
    if any(x is None for x in lat):
        return False
    q = max(1, len(lat) // 4)
    return statistics.median(lat[-q:]) <= 2.0 * statistics.median(lat[:q])


def tail_held(result: dict, seconds: float) -> bool:
    return (backlog_held(result) and result["window_s"] <= seconds + 1.0
            and not any(x >= 1.0 for x in result["latencies_s"]))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", default="c3-serve-http-poisson")
    p.add_argument("--rates", type=float, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=8.0)
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--repeats", type=int, default=1)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    from vae_assoc_tpu_torch.utils.compile_cache import enable_compile_cache

    enable_compile_cache(run._cache_env(ROOT) / "build")
    ctx = calibrate.context(args.workload, args.seed, args.seconds)
    server, port, _, times = serve_http.start_server(ctx)
    rows, knee, knee_backlog = [], None, None
    ok = ok_backlog = True
    try:
        for rate in args.rates:
            for _ in range(args.repeats):
                n0 = len(times)
                r = serve_http.generate(port, args.seed, rate, args.seconds, ctx.mix)
                lat = r["latencies_s"]
                held, backlog = tail_held(r, args.seconds), backlog_held(r)
                ok, ok_backlog = ok and held, ok_backlog and backlog
                row = {"rate_per_s": rate, "tail_held": held, "backlog_held": backlog,
                       "waits_1s": sum(x is not None and x >= 1.0 for x in lat),
                       "attempted": r["attempted"],
                       "answered": r["completed"], "p50_ms": loadgen.percentile(lat, 50) * 1e3,
                       "p95_ms": loadgen.percentile(lat, 95) * 1e3,
                       "p99_ms": loadgen.percentile(lat, 99) * 1e3,
                       "rows_per_dispatch": r["completed"] / max(1, r["dispatches"]),
                       "dispatch_ms_p50": statistics.median(t for _, t in times[n0:]) * 1e3,
                       "late_s": r["late_s"], "window_s": r["window_s"]}
                rows.append(row)
                print(json.dumps(row), flush=True)
            if ok:
                knee = rate
            if ok_backlog:
                knee_backlog = rate
    finally:
        server.close()
    out = {"workload": args.workload, "knee_per_s": knee, "knee_backlog_per_s": knee_backlog,
           "rates": rows}
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(out))
    print(json.dumps({"knee_per_s": knee, "knee_backlog_per_s": knee_backlog}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
