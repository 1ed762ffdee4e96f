"""Spans and counters: the port's one record of where host time goes and what was counted.

A span is a named interval of host time on one thread::

    with spans.span("train.step"):
        ...

It records its name, its start and end (``time.perf_counter_ns()``), its
own id, the id of the span open around it on the same thread, the
thread's native id, and the id of the request it serves (given, or taken
from the span around it). Spans stay in a bounded in-memory buffer until
``drain()``, which returns them with their times on the wall clock
(``time.time_ns()``) that ``torch.profiler`` traces are laid on, so a span
and the CUDA calls made inside it share one timeline. Spans past the
buffer's capacity are dropped and counted (``dropped()``), and a reader
that finds any dropped knows its spans are not the whole window.

Recording is on after ``enable()``, off after ``disable()``, and by
default follows PyTorch's profiler: while a ``torch.profiler`` trace runs
anywhere in the process, spans are recorded, so a profiled run carries the
program's spans without asking for them. When recording is off, ``span()``
tests one flag and returns a shared no-op context: it records and
allocates nothing. Spans that one period of recording left undrained are
dropped, uncounted, when the next period records its first span, so a
profile that nobody drains holds no memory past the next.

Counters are always on. A :class:`Counters` group is a dict of counters
that an object or a module owns (the micro-batcher's, the kernel launch
tables). An add is a plain integer add, safe where one thread writes the
counter or the caller holds a lock; ``shared=True`` takes the group's lock
for a counter that several threads write.
"""

from __future__ import annotations

import itertools
import threading
import time
import types
from typing import NamedTuple

import torch.autograd.profiler as _torch_profiler

CAPACITY = 1 << 18
"""Spans the buffer holds until drained; later ones are dropped and counted."""


class Span(NamedTuple):
    """One recorded span; ``start_ns`` and ``end_ns`` on ``time.time_ns()``'s clock."""

    name: str
    start_ns: int
    end_ns: int
    id: int
    parent: int | None
    thread: int
    request: int | None
    attrs: dict | None


# -- counters -------------------------------------------------------------------


class Counters(dict):
    """Named integer counters: a dict whose ``add`` is the way to count."""

    def __init__(self, names=()):
        super().__init__((n, 0) for n in names)
        self._lock = threading.Lock()

    def add(self, name: str, n: int = 1, *, shared: bool = False) -> None:
        """Add ``n`` to ``name``. A plain add: one thread writes the counter,
        or the caller holds a lock around it; ``shared=True`` takes the
        group's lock for a counter that several threads write."""
        if shared:
            with self._lock:
                self[name] = self.get(name, 0) + n
        else:
            self[name] = self.get(name, 0) + n

    def snapshot(self) -> dict:
        """A copy of every count, taken under the group's lock."""
        with self._lock:
            return dict(self)

    def reset(self) -> None:
        """Set every count to zero."""
        with self._lock:
            for k in self:
                self[k] = 0


# -- spans ----------------------------------------------------------------------

if not hasattr(_torch_profiler, "_is_profiler_enabled"):
    raise ImportError("torch.autograd.profiler has no _is_profiler_enabled flag, which the "
                      "span recorder follows: this PyTorch is not one it knows")

_ALWAYS = types.SimpleNamespace(_is_profiler_enabled=True)
_NEVER = types.SimpleNamespace(_is_profiler_enabled=False)
_FOLLOW = _torch_profiler
_gate = _FOLLOW
"""What ``span()`` tests: its ``_is_profiler_enabled`` attribute. Following
the profiler it is PyTorch's profiler module, whose process-wide flag a
running ``torch.profiler`` trace sets; ``enable()`` and ``disable()`` put a
constant in its place."""

_lock = threading.Lock()  # the buffer's; taken only while recording
_buf: list = []
_clock: list = []  # (time_ns, perf_counter_ns) pairs since the buffer was emptied
_dropped = 0  # spans dropped since the buffer was emptied
_lapsed = False  # some span() found recording off since the buffer last took a span
_ids = itertools.count(1)
_requests = itertools.count(1)


class _Thread(threading.local):
    """Each thread's open spans, and its native id, read once: reading it
    is a system call, which some container runtimes make cost microseconds."""

    def __init__(self):
        self.stack = []
        self.tid = threading.get_native_id()


_tls = _Thread()


def enable() -> None:
    """Record spans from now on."""
    global _gate
    _gate = _ALWAYS


def disable() -> None:
    """Record no spans, not even under a running profiler, until
    ``enable()`` or ``follow_profiler()``."""
    global _gate
    _gate = _NEVER


def follow_profiler() -> None:
    """Record spans while a ``torch.profiler`` trace runs: the default."""
    global _gate
    _gate = _FOLLOW


def recording() -> bool:
    """Whether ``span()`` records now."""
    return _gate._is_profiler_enabled


def new_request() -> int:
    """A fresh request id for the span that starts serving a request."""
    return next(_requests)


def current_request() -> int | None:
    """The request id of the innermost open span on this thread, or None."""
    st = _tls.stack
    return st[-1][1] if st else None


def dropped() -> int:
    """Spans dropped for want of room since the buffer was last emptied."""
    return _dropped


def _record(rec: tuple) -> None:
    global _dropped, _lapsed
    with _lock:
        if _lapsed and _gate._is_profiler_enabled:
            # The first span of a new period of recording: what an earlier
            # period left undrained is not this one's.
            _buf.clear()
            _clock.clear()
            _dropped, _lapsed = 0, False
        if len(_buf) >= CAPACITY:
            _dropped += 1
            return
        if not _buf:
            _clock.append((time.time_ns(), time.perf_counter_ns()))
        _buf.append(rec)


class _NullSpan:
    """The shared context ``span()`` returns when recording is off."""

    id = None

    def __enter__(self):
        global _lapsed
        _lapsed = True
        return self

    def __exit__(self, *exc):
        return False


_NULL = _NullSpan()


class _OpenSpan:
    __slots__ = ("name", "request", "start", "id", "parent", "_st")

    def __init__(self, name, request, start_ns):
        self.name, self.request, self.start = name, request, start_ns

    def __enter__(self):
        st = self._st = _tls.stack
        if st:
            self.parent, parent_request = st[-1]
            if self.request is None:
                self.request = parent_request
        else:
            self.parent = None
        self.id = next(_ids)
        st.append((self.id, self.request))
        if self.start is None:
            self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        self._st.pop()
        _record((self.name, self.start, end, self.id, self.parent, _tls.tid, self.request,
                 None))
        return False


def span(name: str, request: int | None = None, start_ns: int | None = None):
    """A context manager that records ``name`` from its entry (or from
    ``start_ns``, a ``time.perf_counter_ns()`` reading taken earlier, on any
    thread) to its exit. ``request`` ties it to a request; by default it
    takes the request of the span around it. Off, a shared no-op context."""
    if not _gate._is_profiler_enabled:
        return _NULL
    return _OpenSpan(name, request, start_ns)


def record(name: str, start_ns: int, end_ns: int, request: int | None = None,
           **attrs) -> None:
    """Record a span whose ends were read earlier (``perf_counter_ns``), on
    no thread's stack: a wait that began on one thread and ended on
    another. ``attrs`` ride along (a dispatch's id, say). Records nothing
    while recording is off."""
    if _gate._is_profiler_enabled:
        _record((name, start_ns, end_ns, next(_ids), None, _tls.tid, request,
                 attrs or None))


def drain() -> list:
    """Every span recorded since the last drain, oldest first, with its
    times moved onto ``time.time_ns()``'s clock; empties the buffer and
    sets ``dropped()`` to zero."""
    global _buf, _clock, _dropped
    now = (time.time_ns(), time.perf_counter_ns())
    with _lock:
        buf, clock = _buf, _clock + [now]
        _buf, _clock, _dropped = [], [], 0
    # The offset between the clocks, read when the buffer began to fill and
    # now, averaged: perf_counter_ns has no fixed origin.
    offset = sum(u - p for u, p in clock) // len(clock)
    return [Span(n, s + offset, e + offset, i, p, t, r, a) for n, s, e, i, p, t, r, a in buf]

