"""Stdlib HTTP serving front end over `serve.Predictor` + `MicroBatcher`.

Counterpart of vae_assoc_tpu/serve_http.py, with the same routes, status
codes and power-of-two checks, plus a ``--device`` flag. Dependency-free
(http.server + json) and threaded; cross_generate and reconstruct requests
go through the `MicroBatcher`, so concurrent small requests coalesce into
batched device calls.

    python -m vae_assoc_tpu_torch.serve_http /path/to/model_dir --device cuda
    python -m vae_assoc_tpu_torch.serve_http /path/to/artifact --from-export \\
        --compile-cache /path/to/cache

Endpoints (JSON in / JSON out):

  GET  /healthz                  → {"status": "ok", "modalities": [...]}
  GET  /statz                    → {"dispatches": N, "requests": ..., "rows": ...,
                                    "padded_rows": ..., "errors": ...,
                                    "min_batch": ..., "max_batch": ..., "n_cond": ...}
  POST /v1/transform             {"inputs": [[...], ...] per modality}
                                 → {"latents": [[...], ...] per modality}
  POST /v1/generate              {"latents": [[...]], "modality": "image"}
                                 → {"outputs": [[...]]}
  POST /v1/reconstruct           {"inputs": [[...]], "modality": "image"}
                                 → {"outputs": [[...]]}
  POST /v1/cross_generate        {"inputs": [[...]], "src": "image",
                                  "dst": "trajectory"}
                                 → {"outputs": [[...]]}

Errors return 400 with {"error": "..."} for malformed requests (unknown
modality, wrong feature width, bad JSON); 404 for unknown routes.

Spans (utils/spans.py), each request's under its own request id:
``http.request`` from the moment the server hands the accepted connection
over (thread start-up counted) to the last byte written; under it
``http.read`` (the body and ``json.loads``), ``http.wait`` (blocked on the
micro-batcher) and ``http.write`` (``json.dumps`` and the send).
"""

from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np

from vae_assoc_tpu_torch import bucketing
from vae_assoc_tpu_torch.bucketing import MAX_BUCKET
from vae_assoc_tpu_torch.serve import MicroBatcher, Predictor
from vae_assoc_tpu_torch.utils import spans


def _pad_rows(x: np.ndarray, n: int) -> np.ndarray:
    if x.shape[0] >= n:
        return x
    return np.concatenate(
        [x, np.zeros((n - x.shape[0],) + x.shape[1:], x.dtype)], axis=0
    )


def _as_2d(obj, name: str) -> np.ndarray:
    """Parse a JSON field as a [rows, features] float array or raise a
    client-addressable ValueError."""
    x = np.asarray(obj, np.float32)
    if x.ndim != 2:
        raise ValueError(f"{name} must be a 2-D [rows, features] array, "
                         f"got shape {x.shape}")
    return x


class ModelServer:
    """Owns the Predictor + MicroBatcher and serves them over HTTP.

    The batcher pads every dispatch to at least `min_batch` rows, so the
    reachable bucket set is the finite {min_batch, 2·min_batch, …,
    max_batch}; `warm=True` (default) runs every endpoint over that set
    before the server binds, which builds the kernel library and loads the
    CUDA modules off the request threads.
    """

    def __init__(self, predictor: Predictor, *, max_batch: int = 1024,
                 max_wait_ms: float = 2.0, min_batch: Optional[int] = None,
                 warm: bool = True):
        # Powers of two keep every dispatch inside the warmed bucket set:
        # Predictor buckets to the next power of two, and above MAX_BUCKET
        # it chunks internally. Reject rather than silently round.
        if min_batch is None:
            min_batch = min(64, max_batch)
        for name, v in (("min_batch", min_batch), ("max_batch", max_batch)):
            if v < 1 or v & (v - 1):
                raise ValueError(f"{name} must be a power of two, got {v}")
        if max_batch > MAX_BUCKET:
            raise ValueError(
                f"max_batch {max_batch} exceeds bucketing.MAX_BUCKET "
                f"{MAX_BUCKET}: Predictor would chunk dispatches "
                "internally and residual chunks would escape the warmed "
                "bucket set"
            )
        self.predictor = predictor
        self.max_batch = max_batch
        self.batcher = MicroBatcher(
            predictor, max_batch=max_batch, max_wait_ms=max_wait_ms,
            min_batch=min_batch,
        )
        if warm:
            b, buckets = min_batch, []
            while b <= max_batch:
                buckets.append(b)
                b *= 2
            predictor.warmup(buckets, all_endpoints=True)
        self._httpd = None

    def _payload_cond(self, payload: dict, batch: int):
        """Normalize the optional 'cond' field (bucketing.check_cond)."""
        cond = payload.get("cond")
        return bucketing.check_cond(
            None if cond is None else np.asarray(cond),
            self.predictor.cfg.n_cond, batch,
        )

    # -- request handling (pure: dict in → (status, dict) out) --------------
    def handle(self, path: str, payload: dict):
        cfg = self.predictor.cfg
        try:
            if path == "/v1/transform":
                xs = [_as_2d(x, f"inputs[{i}]")
                      for i, x in enumerate(payload["inputs"])]
                if len(xs) != len(cfg.modalities):
                    raise ValueError(
                        f"expected {len(cfg.modalities)} modality input "
                        f"arrays, got {len(xs)}"
                    )
                if len({x.shape[0] for x in xs}) != 1:
                    raise ValueError(
                        "per-modality inputs must have equal row counts, "
                        f"got {[x.shape[0] for x in xs]}"
                    )
                cond = self._payload_cond(payload, xs[0].shape[0])
                if cond is not None:
                    xs = xs + [cond]
                zs = self._chunked_multi(self.predictor.transform, xs)
                return 200, {"latents": [z.tolist() for z in zs]}
            if path == "/v1/generate":
                z = _as_2d(payload["latents"], "latents")
                m = payload["modality"]
                cond = self._payload_cond(payload, z.shape[0])
                if cond is None:
                    out = self._chunked(
                        lambda c: self.predictor.generate(c, m), z
                    )
                else:
                    out = self._chunked_multi(
                        lambda ps: (self.predictor.generate(
                            ps[0], m, cond=ps[1]),),
                        [z, cond],
                    )[0]
                return 200, {"outputs": out.tolist()}
            if path == "/v1/reconstruct":
                x = _as_2d(payload["inputs"], "inputs")
                m = payload["modality"]
                cond = self._payload_cond(payload, x.shape[0])
                with spans.span("http.wait"):
                    out = self.batcher.cross_generate(x, m, m, cond=cond)
                return 200, {"outputs": out.tolist()}
            if path == "/v1/cross_generate":
                x = _as_2d(payload["inputs"], "inputs")
                cond = self._payload_cond(payload, x.shape[0])
                with spans.span("http.wait"):
                    out = self.batcher.cross_generate(
                        x, payload["src"], payload["dst"], cond=cond
                    )
                return 200, {"outputs": out.tolist()}
        except (KeyError, ValueError, TypeError, IndexError) as e:
            return 400, {"error": str(e)}
        return 404, {"error": f"no route {path}"}

    # Direct endpoints stay inside the warmed bucket set too: pad up to the
    # bucket floor and chunk above max_batch.
    def _chunked(self, fn, x):
        mb, cap = self.batcher.min_batch, self.max_batch
        if x.shape[0] <= cap:
            n = x.shape[0]
            return fn(_pad_rows(x, mb))[:n]
        return np.concatenate(
            [self._chunked(fn, x[lo : lo + cap])
             for lo in range(0, x.shape[0], cap)], axis=0
        )

    def _chunked_multi(self, fn, xs):
        mb, cap = self.batcher.min_batch, self.max_batch
        n = xs[0].shape[0]
        if n <= cap:
            return tuple(z[:n] for z in fn([_pad_rows(x, mb) for x in xs]))
        parts = [
            self._chunked_multi(fn, [x[lo : lo + cap] for x in xs])
            for lo in range(0, n, cap)
        ]
        return tuple(np.concatenate(p, axis=0) for p in zip(*parts))

    # -- lifecycle -----------------------------------------------------------
    def serve(self, host: str = "127.0.0.1", port: int = 8000,
              on_bound=None):
        """Blocking serve_forever (Ctrl-C to stop). ``on_bound`` runs after
        the socket is bound, before the accept loop."""
        with self._make_httpd(host, port):
            if on_bound is not None:
                on_bound(self._httpd.server_address[1])
            self._httpd.serve_forever()

    def start(self, host: str = "127.0.0.1", port: int = 0) -> int:
        """Background-thread server; returns the bound port."""
        self._make_httpd(host, port)
        t = threading.Thread(target=self._httpd.serve_forever, daemon=True)
        t.start()
        return self._httpd.server_address[1]

    def _make_httpd(self, host, port):
        server = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet by default
                pass

            def handle(self):
                start = accepted.pop(self.request, None)
                with spans.span("http.request", request=spans.new_request(),
                                start_ns=start):
                    super().handle()

            def _send(self, status: int, obj: dict):
                with spans.span("http.write"):
                    body = json.dumps(obj).encode()
                    self.send_response(status)
                    self.send_header("Content-Type", "application/json")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)

            def do_GET(self):
                if self.path == "/healthz":
                    self._send(200, {
                        "status": "ok",
                        "modalities": [m.name for m in
                                       server.predictor.cfg.modalities],
                    })
                elif self.path == "/statz":
                    self._send(200, {
                        **server.batcher.counters.snapshot(),
                        "min_batch": server.batcher.min_batch,
                        "max_batch": server.batcher.max_batch,
                        "n_cond": server.predictor.cfg.n_cond,
                    })
                else:
                    self._send(404, {"error": f"no route {self.path}"})

            def do_POST(self):
                try:
                    with spans.span("http.read"):
                        n = int(self.headers.get("Content-Length", 0))
                        payload = json.loads(self.rfile.read(n) or b"{}")
                except (ValueError, json.JSONDecodeError) as e:
                    self._send(400, {"error": f"bad JSON: {e}"})
                    return
                try:
                    status, obj = server.handle(self.path, payload)
                except Exception as e:  # a server bug answers 500, not a
                    # dropped connection (handle() 400s client errors)
                    status, obj = 500, {"error": f"internal: {e!r}"}
                self._send(status, obj)

        accepted = {}  # connection -> perf_counter_ns when handed over, while recording

        class Server(ThreadingHTTPServer):
            def process_request(self, request, client_address):
                if spans.recording():
                    accepted[request] = time.perf_counter_ns()
                super().process_request(request, client_address)

        self._httpd = Server((host, port), Handler)
        return self._httpd

    def close(self):
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        self.batcher.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _build_parser():
    import argparse

    p = argparse.ArgumentParser(
        prog="vae_assoc_tpu_torch.serve_http", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    p.add_argument("model_dir", help="save_model or utils.checkpoint."
                                     "save_params directory "
                                     "(model_config.json), or with "
                                     "--from-export an export_predictor "
                                     "artifact directory (manifest.json)")
    p.add_argument("--from-export", action="store_true",
                   help="serve a torch.export artifact written by "
                        "python -m vae_assoc_tpu_torch.export: loads no "
                        "model classes and restores no checkpoint")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="device the model runs on; cuda without a GPU fails")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--max-batch", type=int, default=1024)
    p.add_argument("--min-batch", type=int, default=None,
                   help="dispatch-padding floor; with --max-batch it bounds "
                        "the bucket set warmed at startup (default: "
                        "min(64, max_batch))")
    p.add_argument("--max-wait-ms", type=float, default=2.0)
    p.add_argument("--no-warm", action="store_true",
                   help="skip the startup warmup (the first requests then "
                        "build the kernel library)")
    p.add_argument("--compile-cache", default=None, metavar="DIR",
                   help="build cache directory for the kernel library (and "
                        "the UJI parser); a restarted server loads the "
                        "library from it instead of running nvcc again")
    return p


def main(argv=None) -> int:
    args = _build_parser().parse_args(argv)
    if args.compile_cache:
        from vae_assoc_tpu_torch.utils.compile_cache import enable_compile_cache

        print(f"compile cache: {enable_compile_cache(args.compile_cache)}",
              flush=True)
    if args.from_export:
        from vae_assoc_tpu_torch.export import ExportedPredictor

        pred = ExportedPredictor.load(args.model_dir, device=args.device)
    else:
        pred = Predictor.load(args.model_dir, device=args.device)
    with ModelServer(pred, max_batch=args.max_batch,
                     min_batch=args.min_batch,
                     max_wait_ms=args.max_wait_ms,
                     warm=not args.no_warm) as server:
        # Graceful SIGTERM: stop accepting, let serve() return, and let the
        # context exit drain the MicroBatcher. httpd.shutdown() must run on
        # another thread: from the signal handler (main thread, inside
        # serve_forever's poll loop) it would wait on itself.
        import signal

        def _on_term(signum, frame):
            print(f"signal {signum}: draining in-flight requests and "
                  "shutting down", flush=True)
            httpd = server._httpd
            if httpd is None:  # SIGTERM before the socket bound
                raise SystemExit(0)
            threading.Thread(target=httpd.shutdown, daemon=True).start()

        signal.signal(signal.SIGTERM, _on_term)

        def _announce(port):
            print(f"serving {args.model_dir} on http://{args.host}:{port} "
                  f"({args.device})", flush=True)

        try:
            server.serve(args.host, args.port, on_bound=_announce)
        except KeyboardInterrupt:
            pass
    print("server closed", flush=True)
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
