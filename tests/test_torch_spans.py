"""The port's span and counter recorder (utils/spans.py) on the CPU: off by
default, the spans of the training loop and of a served request, request
ids across the micro-batcher, the buffer's bound, one clock with
torch.profiler, the counters of the kernels and of /statz, and the idle
breakdown that names gaps by span (portbench/spantrace.py)."""

import importlib.util
import json
import socket
import threading
import urllib.request
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from portbench import spantrace, trace
from vae_assoc_tpu_torch import configs as tcfg
from vae_assoc_tpu_torch import serve as tserve
from vae_assoc_tpu_torch import serve_http as thttp
from vae_assoc_tpu_torch.kernels import _launches
from vae_assoc_tpu_torch.models.assoc import init_assoc
from vae_assoc_tpu_torch.train import loop as tloop
from vae_assoc_tpu_torch.utils import spans

N_IN = (24, 10)
STEP_CHILDREN = ["step.forward", "step.backward", "step.optimizer"]
REQUEST_SPANS = {"http.request", "http.read", "http.wait", "http.write", "batcher.queue"}


def _cfg():
    arch = lambda n: dict(n_input=n, n_z=4, n_hidden_recog_1=16, n_hidden_recog_2=12,  # noqa: E731
                          n_hidden_gener_1=12, n_hidden_gener_2=16)
    return tcfg.AssocConfig([
        tcfg.ModalityConfig("image", arch(N_IN[0]), recon="bernoulli"),
        tcfg.ModalityConfig("trajectory", arch(N_IN[1]), recon="gaussian"),
    ])


def _data(n=64):
    rng = np.random.default_rng(0)
    return [torch.from_numpy(rng.uniform(0, 1, (n, N_IN[0])).astype(np.float32)),
            torch.from_numpy(rng.normal(size=(n, N_IN[1])).astype(np.float32))]


@pytest.fixture
def recorder():
    """A clean recorder, back in its default state after the test."""
    spans.follow_profiler()
    spans.drain()
    yield spans
    spans.follow_profiler()
    spans.drain()


@pytest.fixture(scope="module")
def predictor():
    return tserve.Predictor(init_assoc(5, _cfg(), device="cpu"), _cfg(), device="cpu",
                            use_pallas=True)


def _post(port, x):
    """POST one cross_generate request and read the answer to the end of
    the stream: the server closes it after the request's span is recorded."""
    body = json.dumps({"inputs": x.tolist(), "src": "image", "dst": "trajectory"}).encode()
    with socket.create_connection(("127.0.0.1", port), timeout=60) as sock:
        sock.sendall(b"POST /v1/cross_generate HTTP/1.1\r\nHost: x\r\nConnection: close\r\n"
                     b"Content-Type: application/json\r\nContent-Length: %d\r\n\r\n"
                     % len(body) + body)
        data = b"".join(iter(lambda: sock.recv(65536), b""))
    head, _, payload = data.partition(b"\r\n\r\n")
    assert head.split(b" ")[1] == b"200", head
    return json.loads(payload)


def _train(fused, epochs=1):
    tc = tcfg.TrainConfig(batch_size=16, use_pallas=True, seed=3)
    loop = tloop.train_loop_fused if fused else tloop.train_loop
    return loop(_cfg(), tc, _data(), epochs=epochs)


def _by_name(recorded):
    out = {}
    for s in recorded:
        out.setdefault(s.name, []).append(s)
    return out


def test_off_by_default_records_nothing(recorder, predictor):
    assert not spans.recording()
    _train(fused=True)
    with thttp.ModelServer(predictor, max_batch=16, warm=False) as server:
        _post(server.start(port=0), np.zeros((1, N_IN[0]), np.float32))
        assert server.batcher.counters["requests"] == 1  # counters stay on
    assert spans.drain() == [] and spans.dropped() == 0


@pytest.mark.parametrize("fused", [True, False], ids=["train_loop_fused", "train_loop"])
def test_training_spans_nest(recorder, fused):
    spans.enable()
    _train(fused, epochs=2)
    got = _by_name(spans.drain())
    (call,) = got["train.call"]
    assert len(got["train.shuffle"]) == 2 and all(s.parent == call.id for s in got["train.shuffle"])
    sync = got["train.sync"]  # one closing copy (fused) or one an epoch
    assert len(sync) == (1 if fused else 2) and all(s.parent == call.id for s in sync)
    steps = got["train.step"]
    assert len(steps) == 2 * 4 and all(s.parent == call.id for s in steps)
    for name in STEP_CHILDREN:
        kids = got[name]
        assert sorted(s.parent for s in kids) == sorted(s.id for s in steps)
        for k in kids:
            step = next(s for s in steps if s.id == k.parent)
            assert step.start_ns <= k.start_ns <= k.end_ns <= step.end_ns
    assert call.start_ns <= min(s.start_ns for s in steps)
    assert max(s.end_ns for s in sync) <= call.end_ns


def test_request_spans_share_its_id(recorder, predictor):
    with thttp.ModelServer(predictor, max_batch=16, max_wait_ms=1.0, warm=False) as server:
        port = server.start(port=0)
        spans.enable()
        _post(port, np.zeros((1, N_IN[0]), np.float32))
    got = _by_name(spans.drain())  # closing the server joined the batcher's worker
    (req,) = got["http.request"]
    assert req.request is not None
    for name in REQUEST_SPANS:
        (s,) = got[name]
        assert s.request == req.request, name
    for name in ("http.read", "http.wait", "http.write"):
        s = got[name][0]
        assert s.parent == req.id and req.start_ns <= s.start_ns <= s.end_ns <= req.end_ns
    (dispatch,) = got["batcher.dispatch"]
    queue = got["batcher.queue"][0]
    assert queue.attrs == {"dispatch": dispatch.id} and queue.end_ns == dispatch.start_ns
    wait = got["http.wait"][0]
    assert wait.start_ns <= queue.start_ns and dispatch.end_ns <= wait.end_ns
    for name in ("predictor.h2d", "predictor.run", "predictor.d2h"):
        assert [s.parent for s in got[name]] == [dispatch.id]


def test_coalesced_requests_name_one_dispatch(recorder, predictor):
    spans.enable()
    ids, futs, go = [spans.new_request(), spans.new_request()], [], threading.Barrier(2)

    def client(rid):
        with spans.span("client", request=rid):
            go.wait()
            futs.append(mb.submit(np.zeros((1, N_IN[0]), np.float32), 0, 1))

    with tserve.MicroBatcher(predictor, max_batch=16, max_wait_ms=500.0) as mb:
        threads = [threading.Thread(target=client, args=(r,)) for r in ids]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        for f in futs:
            f.result(timeout=60)
        assert mb.dispatches == 1
    got = _by_name(spans.drain())
    (dispatch,) = got["batcher.dispatch"]
    queued = got["batcher.queue"]
    assert sorted(s.request for s in queued) == sorted(ids)
    assert {s.attrs["dispatch"] for s in queued} == {dispatch.id}


def test_buffer_bound_and_dropped_count(recorder, monkeypatch):
    monkeypatch.setattr(spans, "CAPACITY", 3)
    spans.enable()
    for _ in range(5):
        with spans.span("x"):
            pass
    spans.record("y", 1, 2)
    assert spans.dropped() == 3
    obs = {}
    assert spantrace.drained(obs) is None  # a window that overflowed gives no metric
    assert spans.dropped() == 0
    with spans.span("x"):  # room again once drained
        pass
    assert len(spans.drain()) == 1


def test_an_undrained_period_goes_when_the_next_records(recorder):
    a = torch.randn(8, 8)
    for name in ("first", "second"):
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
            with spans.span(name):
                a @ a
        with spans.span("between"):  # recording is off: nothing recorded
            pass
    assert [s.name for s in spans.drain()] == ["second"]
    spans.enable()
    with spans.span("kept"):
        pass
    spans.disable()
    with spans.span("off"):
        pass
    assert [s.name for s in spans.drain()] == ["kept"]  # drained before the next period


def test_counters_from_many_threads():
    c = spans.Counters(("n",))

    def add():
        for _ in range(2000):
            c.add("n", shared=True)

    threads = [threading.Thread(target=add) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert c.snapshot() == {"n": 8000}
    c.reset()
    assert c == {"n": 0}


def test_kernel_launch_counters_are_counter_groups():
    assert isinstance(_launches.SERVING, spans.Counters)
    assert isinstance(_launches.TRAINING, spans.Counters)
    _launches.reset()
    _launches.count(_launches.TRAINING, "wgrad")
    assert _launches.snapshot()["wgrad"] == 1
    with pytest.raises(KeyError):
        _launches.count(_launches.SERVING, "no_such_kernel")
    _launches.reset()
    assert not any(_launches.snapshot().values())


def test_spans_follow_the_profiler_on_its_clock(recorder):
    a = torch.randn(128, 128)
    prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])
    prof.start()
    assert spans.recording()
    with spans.span("outer"):
        a @ a
    prof.stop()
    assert not spans.recording()
    (outer,) = spans.drain()
    origin = prof.profiler.kineto_results.trace_start_ns()
    mm = [origin + e.time_range.start * 1000 for e in prof.events() if e.name == "aten::mm"]
    assert mm and all(outer.start_ns <= t <= outer.end_ns for t in mm)


def test_statz_keeps_dispatches_and_adds_counters(predictor):
    with thttp.ModelServer(predictor, max_batch=16, warm=False) as server:
        port = server.start(port=0)
        _post(port, np.zeros((3, N_IN[0]), np.float32))
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/statz", timeout=60) as r:
            statz = json.loads(r.read())
    assert statz["dispatches"] == 1 and statz["requests"] == 1 and statz["rows"] == 3
    assert statz["padded_rows"] == 16 - 3  # the min_batch floor: 16 rows computed
    assert statz["errors"] == 0 and statz["min_batch"] == 16


def test_failed_dispatch_counts_errors(predictor, monkeypatch):
    def boom(*a, **k):
        raise RuntimeError("device lost")

    with tserve.MicroBatcher(predictor, max_batch=16, max_wait_ms=1.0) as mb:
        monkeypatch.setattr(mb.predictor, "cross_generate", boom)
        with pytest.raises(RuntimeError, match="device lost"):
            mb.cross_generate(np.zeros((2, N_IN[0]), np.float32), 0, 1)
        assert mb.counters["errors"] == 1 and mb.dispatches == 0


# -- the breakdown by span ---------------------------------------------------------------

T0 = 1_000_000_000  # the synthetic trace's start, ns


def _event(name, a, b, device=False):
    kind = trace.DeviceType.CUDA if device else trace.DeviceType.CPU
    return SimpleNamespace(name=name, device_type=kind, time_range=SimpleNamespace(start=a, end=b))


def _prof(events):
    return SimpleNamespace(events=lambda: events,
                           profiler=SimpleNamespace(kineto_results=SimpleNamespace(
                               trace_start_ns=lambda: T0)))


def _span(name, a_us, b_us, sid=1):
    return spans.Span(name, T0 + a_us * 1000, T0 + b_us * 1000, sid, None, 0, None, None)


# Device busy 0-10, 20-30, 50-60, 90-100 µs; gaps 10-20 (middle in a
# cudaMemcpyAsync), 30-50 (in no call), 60-90 (in no call).
EVENTS = [_event("k", 0, 10, True), _event("k", 20, 30, True), _event("k", 50, 60, True),
          _event("k", 90, 100, True), _event("cudaMemcpyAsync", 12, 18),
          _event("cudaLaunchKernel", 48, 49)]


def test_summarize_without_spans_is_the_trace_summary():
    assert spantrace.summarize(_prof(EVENTS), 1e-4) == trace.summarize(_prof(EVENTS), 1e-4)


def test_summarize_names_only_the_gaps_outside_cuda_calls():
    plain = trace.summarize(_prof(EVENTS), 1e-4)
    assert dict(plain["idle_gaps"]) == pytest.approx(
        {"host outside CUDA calls": 50e-6, "cudaMemcpyAsync": 10e-6, "window edges": 0.0})
    recorded = [_span("train.call", 5, 95, 1), _span("train.step", 8, 45, 2),
                _span("step.forward", 25, 44, 3), _span("train.step", 55, 70, 4)]
    named = spantrace.summarize(_prof(EVENTS), 1e-4, recorded)
    assert {k: named[k] for k in ("busy_s", "launches", "device_ops")} == \
        {k: plain[k] for k in ("busy_s", "launches", "device_ops")}
    # 10-20: the CUDA call keeps it; 30-50 (middle 40): step.forward, the
    # latest to start; 60-90 (middle 75): only train.call holds it.
    assert dict(named["idle_gaps"]) == pytest.approx(
        {"cudaMemcpyAsync": 10e-6, "step.forward": 20e-6, "train.call": 30e-6,
         "window edges": 0.0})
    assert named["named_s"] == pytest.approx(50e-6) and named["unnamed_s"] == 0.0
    assert named["call_edge_idle_s"] == pytest.approx(30e-6) and named["calls"] == 1
    outside = spantrace.summarize(_prof(EVENTS), 1e-4, [_span("train.step", 55, 70)])
    assert dict(outside["idle_gaps"])["host outside CUDA calls"] == pytest.approx(50e-6)
    assert outside["unnamed_s"] == pytest.approx(50e-6)


def test_span_readers_return_none_without_spans(monkeypatch):
    assert spantrace.median_span_ms({"program_spans": None}, "train.step") is None
    assert spantrace.http_ms({"program_spans": None}) is None
    obs = {"program_spans": [_span("train.step", 0, 2000), _span("train.step", 0, 4000)]}
    assert spantrace.median_span_ms(obs, "train.step") == pytest.approx(3.0)
    req = spans.Span("http.request", 0, 5_000_000, 7, None, 0, 1, None)
    wait = spans.Span("http.wait", 1_000_000, 4_000_000, 8, 7, 0, 1, None)
    assert spantrace.http_ms({"program_spans": [req, wait]}) == pytest.approx(2.0)


def test_a_torch_without_the_profiler_flag_is_refused(monkeypatch):
    """The recorder follows PyTorch's profiler flag; without it, importing
    fails loudly rather than leaving every span silently off."""
    monkeypatch.delattr(torch.autograd.profiler, "_is_profiler_enabled")
    spec = importlib.util.spec_from_file_location("spans_without_flag", spans.__file__)
    with pytest.raises(ImportError, match="_is_profiler_enabled"):
        spec.loader.exec_module(importlib.util.module_from_spec(spec))


def test_off_span_is_one_shared_no_op(recorder):
    spans.disable()
    assert spans.span("a") is spans.span("b", request=1)  # nothing allocated
    with spans.span("a") as s:
        assert s.id is None
    spans.record("c", 1, 2)
    assert spans.drain() == []
