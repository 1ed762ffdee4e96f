"""The program's own spans in a traced window: the span metrics, and the device's idle time named by span.

The program (``vae_assoc_tpu_torch/utils/spans.py``) records its spans while
a ``torch.profiler`` trace runs, so the harness's traced window (``--trace
1``) carries them with no change to ``portbench/traffic/``; the measured
window runs with no profiler and records none. A reader drains them once after the run
(``drained``) and keeps them in the run's observations for the next. A
program without the recorder gives no spans, and every reader here None;
so does a window whose spans overflowed the recorder's buffer, whose
medians would lean to its start.

``summarize`` is ``trace.summarize`` given the spans as well: an idle gap
of the device whose middle lies in a CUDA runtime call keeps that call's
name, exactly as there; one that ``trace.summarize`` calls "host outside
CUDA calls" takes the name of the innermost span (the latest to start)
that contains its middle, and only the gaps under no span keep the old
name. Every other number is ``trace.summarize``'s. It is a temporary fork:
it walks the profile's events a second time and borrows
``trace.summarize``'s private helpers, until ``trace.summarize`` takes
the spans as an optional argument itself and this copy and
``_device_gaps`` go.

    python3 portbench/spantrace.py --workload <cell> --seed <n> [--seconds 5] [--pairs 2]

runs a cell's traced window (the profiler on) in turns with the program's
spans on and off, and prints one JSON line: each window's rate (training:
samples/s; serving: median latency, ms), and for the windows with spans on
the breakdown by span, the share of the idle time that a span names, the
span metrics and ``call_edge_idle_ms``.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from collections import defaultdict
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import trace  # noqa: E402

HOST = "host outside CUDA calls"
EDGES = "window edges"


def drained(obs):
    """The program's spans of the run (drained from its recorder at the
    first call, kept in ``obs``), or None where the program has no
    recorder, recorded nothing, or dropped spans for want of room."""
    if "program_spans" not in obs:
        try:
            from vae_assoc_tpu_torch.utils import spans
        except ImportError:
            obs["program_spans"] = None
        else:
            lost = spans.dropped()
            recorded = spans.drain()
            obs["program_spans"] = None if lost else recorded or None
    return obs["program_spans"]


def _median_ms(durations_ns):
    return statistics.median(durations_ns) / 1e6 if durations_ns else None


def median_span_ms(obs, name):
    """Median duration of the spans named ``name``, in ms, or None."""
    recorded = drained(obs)
    if not recorded:
        return None
    return _median_ms([s.end_ns - s.start_ns for s in recorded if s.name == name])


def http_ms(obs):
    """Median over the requests that waited on the micro-batcher of their
    ``http.request`` span less its ``http.wait``: the front end's own time
    (accept hand-over, thread start, parse, serialise, send), in ms."""
    recorded = drained(obs)
    if not recorded:
        return None
    wait = defaultdict(int)
    for s in recorded:
        if s.name == "http.wait":
            wait[s.parent] += s.end_ns - s.start_ns
    return _median_ms([s.end_ns - s.start_ns - wait[s.id] for s in recorded
                       if s.name == "http.request" and s.id in wait])


def _device_gaps(prof):
    """The device's idle gaps between its merged busy intervals, and the
    host events, as ``trace.summarize`` reads them (µs after the trace's
    start)."""
    device, host = [], []
    for e in prof.events():
        a, b = e.time_range.start, e.time_range.end
        if e.device_type == trace.DeviceType.CUDA:
            device.append((a, b))
        else:
            host.append((a, b, e.name))
    merged = trace._merge(device)
    host.sort()
    return [(merged[i][1], merged[i + 1][0]) for i in range(len(merged) - 1)], host


def summarize(prof, window_s: float, spans=None) -> dict:
    """``trace.summarize``; given the window's spans (``time.time_ns()``'s
    clock), its idle gaps named by span as the module says, and besides:
    ``named_s`` and ``unnamed_s``, the idle seconds in no CUDA call that a
    span names or that none does; ``call_edge_idle_s``, idle seconds whose
    middle lies in no ``train.step`` span; ``calls``, the ``train.call``
    spans."""
    out = trace.summarize(prof, window_s)
    if spans is None:
        return out
    origin = prof.profiler.kineto_results.trace_start_ns()
    on_trace = sorted(((s.start_ns - origin) / 1e3, (s.end_ns - origin) / 1e3, s.name)
                      for s in spans)
    gaps, host = _device_gaps(prof)
    mids = [(a + b) / 2 for a, b in gaps]
    by_call = trace._innermost(mids, host)
    by_span = trace._innermost(mids, on_trace)
    in_step = trace._innermost(mids, [s for s in on_trace if s[2] == "train.step"])
    idle = defaultdict(float)
    idle.update({k: v for k, v in out["idle_gaps"] if k == EDGES})
    named = unnamed = edge = 0.0
    for (a, b), call, name, step in zip(gaps, by_call, by_span, in_step):
        d = (b - a) * 1e-6
        idle[call or name or HOST] += d
        if call is None:
            named += d if name else 0.0
            unnamed += 0.0 if name else d
        edge += 0.0 if step else d
    out["idle_gaps"] = trace._top(idle)
    out.update(named_s=named, unnamed_s=unnamed, call_edge_idle_s=edge,
               calls=sum(s.name == "train.call" for s in spans))
    return out


# -- the tool: traced windows with spans on and off --------------------------------


def _context(workload, seed, seconds):
    from portbench import run

    c = run.load_cell(ROOT, workload)
    return c, run.Context(model=c["config"]["model"],
                          conv_channels=tuple(c["config"].get("assumed", {}).get(
                              "conv_channels", (32, 64))),
                          mix=c["mix"], limits=c["limits"], seed=seed, seconds=seconds,
                          trace=True, device="cuda", t_start=time.perf_counter())


def _spanned(prof, window_s, recorded):
    obs = {"program_spans": recorded or None}
    s = summarize(prof, window_s, recorded)
    return {"breakdown": s["idle_gaps"], "busy_s": s["busy_s"], "window_s": window_s,
            "named_s": s["named_s"], "unnamed_s": s["unnamed_s"],
            "call_edge_idle_ms": 1e3 * s["call_edge_idle_s"] / s["calls"] if s["calls"] else None,
            "host_step_ms": median_span_ms(obs, "train.step"),
            "queue_wait_ms": median_span_ms(obs, "batcher.queue"),
            "http_ms": http_ms(obs),
            "spans": {n: sum(x.name == n for x in recorded)
                      for n in sorted({x.name for x in recorded})}}


def _train_windows(ctx, pairs, seconds):
    from portbench.traffic import train
    from vae_assoc_tpu_torch.train import train_loop_fused
    from vae_assoc_tpu_torch.utils import spans

    cfg, tc, data, _, state = train.build(ctx)
    state, _ = train_loop_fused(cfg, tc, data, epochs=1, state=state)  # each call syncs
    samples = (data[0].shape[0] // tc.batch_size // tc.steps_per_call) * tc.steps_per_call \
        * tc.batch_size
    out = []
    for k in range(2 * pairs):
        on = k % 4 in (0, 3)  # on, off, off, on, ...
        spans.follow_profiler() if on else spans.disable()
        spans.drain()
        prof = trace.profiler(True)
        prof.start()
        t0, calls = time.perf_counter(), 0
        while time.perf_counter() - t0 < seconds:
            state, _ = train_loop_fused(cfg, tc, data, epochs=1, state=state)
            calls += 1
        window_s = time.perf_counter() - t0
        prof.stop()
        row = {"spans_on": on, "samples_per_s": calls * samples / window_s}
        if on:
            row.update(_spanned(prof, window_s, spans.drain()))
        out.append(row)
    spans.follow_profiler()
    return out


def _serve_windows(ctx, pairs, seconds):
    from portbench.traffic import loadgen, serve_http
    from vae_assoc_tpu_torch.utils import spans

    server, port, _, _ = serve_http.start_server(ctx)
    out = []
    try:
        for k in range(2 * pairs):
            on = k % 4 in (0, 3)
            spans.follow_profiler() if on else spans.disable()
            spans.drain()
            prof = trace.profiler(True)
            result = serve_http.generate(port, ctx.seed + k, ctx.mix["rate_per_s"], seconds,
                                         ctx.mix, before=prof.start)
            window_s = time.perf_counter() - result["t0"]
            prof.stop()
            lat = result["latencies_s"]
            row = {"spans_on": on, "serve_p50_ms": loadgen.percentile(lat, 50) * 1e3,
                   "failed": sum(x is None for x in lat)}
            if on:
                row.update(_spanned(prof, window_s, spans.drain()))
            out.append(row)
    finally:
        server.close()
        spans.follow_profiler()
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=5.0, help="each traced window")
    p.add_argument("--pairs", type=int, default=2, help="windows with spans on, and off")
    args = p.parse_args(argv)
    from portbench import run

    cache = run._cache_env(ROOT)
    import torch

    if not torch.cuda.is_available():
        print("spantrace: needs a CUDA card", file=sys.stderr)
        return 2
    from vae_assoc_tpu_torch.utils.compile_cache import enable_compile_cache

    enable_compile_cache(cache / "build")
    c, ctx = _context(args.workload, args.seed, args.seconds)
    windows = (_train_windows if c["mix"]["kind"] == "train" else _serve_windows)(
        ctx, args.pairs, args.seconds)
    print(json.dumps({"workload": args.workload, "seed": args.seed,
                      "device": torch.cuda.get_device_name(), "windows": windows}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
