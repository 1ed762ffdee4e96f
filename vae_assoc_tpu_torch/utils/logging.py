"""Structured metrics logging: a JSONL stream with optional console echo.

Counterpart of vae_assoc_tpu/utils/logging.py. One JSON object per record
({"step"/"epoch", every loss term, samples/s}) so that runs compare by
machine. The JSONL is the source of truth; TensorBoard event files are an
optional tee (``tensorboard_dir=``) written through
``torch.utils.tensorboard`` when the ``tensorboard`` package imports, and a
named error otherwise.
"""

from __future__ import annotations

import json
import os
import time
from typing import IO, Optional


class MetricsLogger:
    """Append-only JSONL metrics writer with optional console echo.

        with MetricsLogger(path, echo=True) as log:
            log.write(epoch=3, **metrics)
    """

    def __init__(self, path: Optional[str] = None, *, echo: bool = False,
                 tensorboard_dir: Optional[str] = None):
        self.path = path
        self.echo = echo
        self._fh: Optional[IO[str]] = None
        self._tb = TensorBoardWriter(tensorboard_dir) if tensorboard_dir else None
        if path is not None:
            os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
            self._fh = open(path, "a", buffering=1)
        self._n = 0
        self._t0 = time.time()

    def write(self, **record) -> dict:
        rec = {"t": round(time.time() - self._t0, 3)}
        for k, v in record.items():
            try:
                rec[k] = float(v)
            except (TypeError, ValueError):
                rec[k] = v
        if self._fh is not None:
            self._fh.write(json.dumps(rec) + "\n")
        if self._tb is not None:
            # TensorBoard needs a monotone step: the record's epoch or step
            # if present, else the running record count. (``step`` is
            # positional-only, so a record's own "step" key passes through.)
            self._tb.write(int(rec.get("epoch", rec.get("step", self._n))), **rec)
        self._n += 1
        if self.echo:
            shown = {k: (round(v, 4) if isinstance(v, float) else v)
                     for k, v in rec.items() if k != "t"}
            print(" ".join(f"{k}={v}" for k, v in shown.items()), flush=True)
        return rec

    def close(self):
        if self._fh is not None:
            self._fh.close()
            self._fh = None
        if self._tb is not None:
            self._tb.close()
            self._tb = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class TensorBoardWriter:
    """Scalar event-file writer through ``torch.utils.tensorboard`` (opt-in).

    The ``tensorboard`` package is not a dependency of the port, so it is
    imported here; without it the constructor raises a named RuntimeError
    rather than an import traceback."""

    def __init__(self, logdir: str):
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError as e:
            raise RuntimeError(
                "TensorBoard logging requires the tensorboard package (used only "
                "as the event-file writer); install it or drop tensorboard_dir"
            ) from e
        self._writer = SummaryWriter(logdir)

    def write(self, step: int, /, **record) -> None:
        for k, v in record.items():
            if isinstance(v, (int, float)) and k != "t":
                self._writer.add_scalar(k, float(v), step)
        self._writer.flush()

    def close(self) -> None:
        self._writer.close()


def read_jsonl(path: str) -> list:
    """Load a metrics JSONL file back into a list of dicts."""
    with open(path) as fh:
        return [json.loads(line) for line in fh if line.strip()]
