"""Serving: batched inference over frozen weights, with power-of-two bucketing.

Counterpart of vae_assoc_tpu/serve.py. The `Predictor` pads each request
batch up to a power-of-two bucket and chunks anything past ``MAX_BUCKET``
(bucketing.py, shared verbatim with the JAX package), runs the transform /
generate / cross-generate endpoints on its device, and slices the padding
off. Weights stay on the device; requests move only activations. With
``use_pallas`` the towers run the hand-written CUDA MLP kernels
(kernels/mlp.py); on a CPU device the same calls run their plain twins.

    pred = Predictor.load(path, device="cuda")   # a save_model directory
    traj = pred.cross_generate(imgs, "image", "trajectory")   # any batch size

`MicroBatcher` coalesces concurrent cross_generate requests into one
bucketed call per route, with the JAX package's semantics.
"""

from __future__ import annotations

import copy
import functools
import queue
import threading
import time
from concurrent.futures import Future
from typing import Sequence, Union

import numpy as np
import torch

from vae_assoc_tpu_torch import bucketing
from vae_assoc_tpu_torch.configs import AssocConfig, TrainConfig
from vae_assoc_tpu_torch.models import assoc as assoc_mod
from vae_assoc_tpu_torch.models.networks import cuda_or_raise, dtype_name
from vae_assoc_tpu_torch.utils import spans


class Predictor:
    """Inference endpoints over frozen params with shape-bucketed batching.

    ``params_or_model`` is the port's :class:`AssocVAE` (moved to
    ``device``) or a JAX param tree as numpy (convert.from_jax_numpy).
    ``device="cuda"`` without a GPU raises: nothing falls back to the CPU.
    """

    def __init__(self, params_or_model, cfg: AssocConfig, *, device="cuda",
                 compute_dtype="float32", use_pallas=False):
        device = cuda_or_raise(device, "Predictor")
        if isinstance(params_or_model, torch.nn.Module):
            model = params_or_model.to(device)
        else:
            from vae_assoc_tpu_torch import convert

            model = convert.from_jax_numpy(params_or_model, cfg, device)
        self.params = model
        self.cfg = cfg
        self.device = device
        self.compute_dtype = dtype_name(compute_dtype)
        self.use_pallas = use_pallas
        self._kw = dict(cfg=cfg, compute_dtype=self.compute_dtype,
                        use_pallas=use_pallas)

    # -- constructors ------------------------------------------------------------
    @classmethod
    def from_checkpoint(cls, path: str, cfg: AssocConfig, *,
                        train_config: TrainConfig | None = None, step: int | None = None,
                        device="cuda", **kw) -> "Predictor":
        """The weights of a whole-state checkpoint (utils/checkpoint.save),
        of ``step`` or the latest."""
        from vae_assoc_tpu_torch.train.step import init_train_state
        from vae_assoc_tpu_torch.utils import checkpoint as ckpt

        tc = train_config or TrainConfig()
        state = ckpt.restore(path, init_train_state(cfg, tc, device=device), step=step)
        return cls(state.params, cfg, device=device, **kw)

    @classmethod
    def load(cls, path: str, *, step: int | None = None, device="cuda",
             **kw) -> "Predictor":
        """One-call load of a self-describing directory: a ``save_model``
        directory (model_config.json and whole-state checkpoints; ``step``
        or the latest) or a ``save_params`` one (model_config.json and
        params.pt).

        Compute dtype and kernel choice default to the recorded training
        settings (override via **kw)."""
        from vae_assoc_tpu_torch.utils import checkpoint as ckpt

        model, cfg, tc = ckpt.load_params(path, step=step, device=device)
        tc = tc or TrainConfig()
        kw.setdefault("compute_dtype", tc.compute_dtype)
        kw.setdefault("use_pallas", tc.use_pallas)
        return cls(model, cfg, device=device, **kw)

    @classmethod
    def from_model(cls, model, **kw) -> "Predictor":
        """A snapshot of a live ``AssocVariationalAutoEncoder``'s weights, on
        its device unless ``device`` is given.

        The weights are copied: the model's optimizer updates them in
        place, so a predictor that aliased them would change with the next
        ``partial_fit``."""
        kw.setdefault("device", model.device)
        return cls(copy.deepcopy(model.state.params), model.config, **kw)

    # -- device calls: numpy in, numpy out -------------------------------------
    def _t(self, a) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(self.device)

    # Spans: predictor.h2d (the copies in), predictor.run (the model's
    # enqueue), predictor.d2h (the copy out, which waits for the card).
    @torch.inference_mode()
    def _transform(self, xs):
        with spans.span("predictor.h2d"):
            ts = [self._t(x) for x in xs]
        with spans.span("predictor.run"):
            outs = assoc_mod.transform(self.params, ts, **self._kw)
        with spans.span("predictor.d2h"):
            return tuple(o.cpu().numpy() for o in outs)

    @torch.inference_mode()
    def _generate(self, z, modality, cond=None):
        with spans.span("predictor.h2d"):
            zt, c = self._t(z), None if cond is None else self._t(cond)
        with spans.span("predictor.run"):
            out = assoc_mod.generate(self.params, zt, modality=modality, cond=c, **self._kw)
        with spans.span("predictor.d2h"):
            return out.cpu().numpy()

    @torch.inference_mode()
    def _cross(self, x, src, dst, cond=None):
        with spans.span("predictor.h2d"):
            xt, c = self._t(x), None if cond is None else self._t(cond)
        with spans.span("predictor.run"):
            out = assoc_mod.cross_generate(self.params, xt, src=src, dst=dst, cond=c,
                                           **self._kw)
        with spans.span("predictor.d2h"):
            return out.cpu().numpy()

    # -- endpoints --------------------------------------------------------------
    def _cond(self, cond, batch):
        """Normalize the request condition (bucketing.check_cond, the one
        serving-side gate)."""
        return bucketing.check_cond(cond, self.cfg.n_cond, batch)

    def transform(self, xs: Sequence[np.ndarray]):
        """Per-modality latent means at any batch size. Conditional models:
        pass the condition as the trailing xs entry (labels or one-hot)."""
        xs = list(xs)
        k = len(self.cfg.modalities)
        if self.cfg.n_cond and len(xs) == k + 1:
            xs[k] = self._cond(xs[k], np.asarray(xs[0]).shape[0])
        return bucketing.chunked_multi_call(self._transform, xs)

    def generate(self, z, modality: Union[int, str], *, cond=None):
        modality = self.cfg.modality_index(modality)
        cond = self._cond(cond, np.asarray(z).shape[0])
        return bucketing.chunked_cond_call(
            lambda zp, cp: self._generate(zp, modality, cp), z, cond
        )

    def reconstruct(self, x, modality: Union[int, str], *, cond=None):
        i = self.cfg.modality_index(modality)
        return self.cross_generate(x, i, i, cond=cond)

    def cross_generate(self, x, src: Union[int, str], dst: Union[int, str],
                       *, cond=None):
        src = self.cfg.modality_index(src)
        dst = self.cfg.modality_index(dst)
        cond = self._cond(cond, np.asarray(x).shape[0])
        return bucketing.chunked_cond_call(
            lambda xp, cp: self._cross(xp, src, dst, cp), x, cond
        )

    def warmup(self, buckets: Sequence[int] = (64, 256, 1024), *,
               all_endpoints: bool = False) -> None:
        """Build the kernel library and run each endpoint once per bucket.

        Nothing is compiled per shape here; this moves the one-time kernel
        build and CUDA's lazy module loading off the request threads. A
        ``conv_pallas`` modality runs the conv kernels whatever
        ``use_pallas`` says, so it needs the library too."""
        kernels = self.use_pallas or any(
            m.encoder == "conv_pallas" for m in self.cfg.modalities)
        if kernels and self.device.type == "cuda":
            from vae_assoc_tpu_torch.kernels import _build

            _build.load()
        bucketing.warmup_endpoints(
            self, self.cfg, buckets, all_endpoints=all_endpoints
        )


def _device_rows(n: int) -> int:
    """Rows the bucketed endpoints compute for an ``n``-row call: whole
    ``MAX_BUCKET`` chunks, and the rest padded to its bucket."""
    full, rest = divmod(n, bucketing.MAX_BUCKET)
    return full * bucketing.MAX_BUCKET + (bucketing._bucket(rest) if rest else 0)


def _join_futures(futs):
    """Future resolving to the row-concatenation of `futs` results.

    First chunk exception wins; chunk order is preserved regardless of
    completion order.
    """
    agg: Future = Future()
    results = [None] * len(futs)
    state = {"pending": len(futs)}
    lock = threading.Lock()

    def _cb(i, f):
        exc = f.exception()
        with lock:
            if agg.done():
                return
            if exc is not None:
                agg.set_exception(exc)
                return
            results[i] = f.result()
            state["pending"] -= 1
            if state["pending"] == 0:
                agg.set_result(np.concatenate(results, axis=0))

    for i, f in enumerate(futs):
        f.add_done_callback(functools.partial(_cb, i))
    return agg


class MicroBatcher:
    """Coalesce concurrent cross_generate requests into batched device calls.

    A background thread drains the request queue, groups requests by
    (src, dst) route, concatenates their rows, runs ONE bucketed
    `Predictor.cross_generate` per route, and scatters the result slices
    back to per-request futures.

        with MicroBatcher(pred, max_wait_ms=2.0) as mb:
            fut = mb.submit(x, "image", "trajectory")   # non-blocking
            y = mb.cross_generate(x2, 0, 1)             # blocking sugar

    Results are identical to direct Predictor calls; order within a batch
    is kept per request. A request waits at most ~max_wait_ms for
    co-travelers; max_batch bounds the rows per device call; every
    dispatch is padded to at least min_batch rows.

    ``counters`` (utils/spans.Counters): ``requests`` and ``rows``
    submitted, ``dispatches`` (device calls made), ``padded_rows`` (rows
    the dispatches computed beyond their requests': the min_batch floor and
    the power-of-two bucket) and ``errors`` (requests whose dispatch
    raised). Spans: ``batcher.queue``, one a request from ``submit`` to the
    start of the dispatch that carries it, naming that dispatch, and
    ``batcher.dispatch`` (concatenation, padding, the predictor call and
    the scatter).
    """

    _STOP = object()

    def __init__(self, predictor: Predictor, *, max_batch: int = 1024,
                 max_wait_ms: float = 2.0, min_batch: int = 0):
        self.predictor = predictor
        self.max_batch = int(max_batch)
        self.min_batch = int(min_batch)
        if self.min_batch > self.max_batch:
            raise ValueError(
                f"min_batch {self.min_batch} > max_batch {self.max_batch}: "
                "dispatch padding would exceed the per-call row cap"
            )
        self.max_wait = max_wait_ms / 1e3
        self._q: queue.Queue = queue.Queue()
        self.counters = spans.Counters(("requests", "rows", "dispatches", "padded_rows",
                                        "errors"))
        self._closed = False
        # Serializes the closed-check+enqueue against close(), so no request
        # lands behind the STOP sentinel.
        self._lock = threading.Lock()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    @property
    def dispatches(self) -> int:
        """Device calls made."""
        return self.counters["dispatches"]

    def _enqueue(self, route, chunks):
        """Atomically (w.r.t. close) enqueue one future per chunk. While
        spans are recorded each item carries its submit time and request."""
        futs = [Future() for _ in chunks]
        tag = (time.perf_counter_ns(), spans.current_request()) if spans.recording() else None
        with self._lock:
            if self._closed:
                raise RuntimeError("MicroBatcher is closed")
            for x, fut in zip(chunks, futs):
                self._q.put((route, x, fut, tag))
            self.counters.add("requests")
            self.counters.add("rows", sum(x.shape[0] for x in chunks))
        return futs

    def submit(self, x, src: Union[int, str], dst: Union[int, str], *,
               cond=None):
        """Enqueue one request; returns a concurrent.futures.Future.

        Requests larger than max_batch are split into max_batch-row chunks
        enqueued atomically; the returned future resolves to the
        re-concatenated result (or the first chunk's exception).
        Conditional models: the cond columns ride the queue hstacked onto x
        and `_dispatch` splits them off again.
        """
        x = np.asarray(x)
        if x.ndim != 2:
            raise ValueError(f"expected [n, features] request, got {x.shape}")
        n_c = self.predictor.cfg.n_cond
        if n_c:
            c = bucketing.normalize_cond(cond, n_c, x.shape[0])
            x = np.concatenate([x.astype(np.float32), c], axis=1)
        elif cond is not None:
            raise ValueError("model is unconditional; drop `cond`")
        route = (
            self.predictor.cfg.modality_index(src),
            self.predictor.cfg.modality_index(dst),
        )
        if x.shape[0] <= self.max_batch:
            return self._enqueue(route, [x])[0]
        chunks = [x[lo : lo + self.max_batch]
                  for lo in range(0, x.shape[0], self.max_batch)]
        return _join_futures(self._enqueue(route, chunks))

    def cross_generate(self, x, src, dst, *, cond=None):
        """Blocking convenience wrapper over `submit`."""
        return self.submit(x, src, dst, cond=cond).result()

    def _worker(self):
        while True:
            item = self._q.get()
            if item is self._STOP:
                return
            batch = [item]
            rows = item[1].shape[0]
            deadline = time.monotonic() + self.max_wait
            while rows < self.max_batch:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                try:
                    nxt = self._q.get(timeout=remaining)
                except queue.Empty:
                    break
                if nxt is self._STOP:
                    self._flush(batch)
                    return
                batch.append(nxt)
                rows += nxt[1].shape[0]
            self._flush(batch)

    def _flush(self, batch):
        routes: dict = {}
        for route, x, fut, tag in batch:
            routes.setdefault(route, []).append((x, fut, tag))
        for (src, dst), items in routes.items():
            chunk, rows = [], 0
            for item in items:
                x = item[0]
                if chunk and rows + x.shape[0] > self.max_batch:
                    self._dispatch(src, dst, chunk)
                    chunk, rows = [], 0
                chunk.append(item)
                rows += x.shape[0]
            if chunk:
                self._dispatch(src, dst, chunk)

    def _dispatch(self, src, dst, items):
        with spans.span("batcher.dispatch") as d:
            if d.id is not None:
                for _, _, tag in items:
                    if tag is not None:
                        spans.record("batcher.queue", tag[0], d.start, request=tag[1],
                                     dispatch=d.id)
            self._dispatch_rows(src, dst, items)

    def _dispatch_rows(self, src, dst, items):
        try:
            big = np.concatenate([x for x, _, _ in items], axis=0)
            rows = big.shape[0]
            if big.shape[0] < self.min_batch:
                big = np.concatenate(
                    [big, np.zeros((self.min_batch - big.shape[0],)
                                   + big.shape[1:], big.dtype)], axis=0
                )
            n_c = self.predictor.cfg.n_cond
            if n_c:
                big, cond = big[:, :-n_c], big[:, -n_c:]
                out = self.predictor.cross_generate(big, src, dst, cond=cond)
            else:
                out = self.predictor.cross_generate(big, src, dst)
            self.counters.add("dispatches")
            self.counters.add("padded_rows", _device_rows(big.shape[0]) - rows)
        except Exception as e:  # the worker must survive; callers get the error
            self.counters.add("errors", len(items))
            for _, fut, _ in items:
                if not fut.done():
                    fut.set_exception(e)
            return
        lo = 0
        for x, fut, _ in items:
            # A caller may have cancelled its future; that must not poison
            # the other requests of this chunk.
            if not fut.done():
                fut.set_result(out[lo : lo + x.shape[0]])
            lo += x.shape[0]

    def close(self):
        """Flush in-flight requests and stop the worker thread. Idempotent."""
        with self._lock:
            if not self._closed:
                self._closed = True
                self._q.put(self._STOP)
        self._thread.join()
        while not self._q.empty():
            item = self._q.get_nowait()
            if item is not self._STOP and not item[2].done():
                item[2].set_exception(RuntimeError("MicroBatcher is closed"))

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
