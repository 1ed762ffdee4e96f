"""Streamed host→device input for datasets larger than the card's memory
(counterpart of vae_assoc_tpu/data/stream.py).

``PairedDataset`` stages everything on the device once, which suits UJI
sizes. ``prefetch_batches`` instead streams each batch from host arrays
(memory-mapped ones too): the batch's rows are gathered into pinned host
memory, copied with ``non_blocking=True`` on a side stream, and the copy
records an event. When the batch is handed out, the consumer's stream
waits on that event, so the step never reads a half-copied batch, while
the copies of the next ``prefetch`` batches overlap the step. Shapes are
static: a fixed batch size, the remainder dropped, as in the epoch loops.
"""

from __future__ import annotations

from typing import Iterator, Sequence

import numpy as np
import torch

from vae_assoc_tpu_torch.models.networks import cuda_or_raise


def prefetch_batches(data: Sequence[np.ndarray], batch_size: int, *, shuffle: bool = True,
                     seed: int = 0, epochs: int = 1, device="cuda",
                     prefetch: int = 2) -> Iterator[tuple]:
    """Yield tuples of per-modality batches on ``device``, ``prefetch``
    batches in flight ahead of the consumer.

    The batch order is the JAX package's: each epoch draws
    ``np.random.default_rng(seed).permutation(N)`` in sequence (or takes
    ``range(N)`` without ``shuffle``) and cuts it into whole batches. On
    the card a yielded batch is ready for the stream that is current when
    it is handed out; on the CPU it is a plain copy of the rows."""
    n = data[0].shape[0]
    for k, d in enumerate(data):
        if d.shape[0] != n:
            raise ValueError(f"modality {k} has {d.shape[0]} rows, expected {n}")
    nb = n // batch_size
    if nb == 0:
        raise ValueError(f"batch_size {batch_size} > dataset size {n}")
    dev = cuda_or_raise(device, "prefetch_batches")
    rng = np.random.default_rng(seed)
    copy_stream = torch.cuda.Stream(dev) if dev.type == "cuda" else None

    def put(sel):
        if copy_stream is None:
            return tuple(torch.from_numpy(np.asarray(d[sel])) for d in data), None
        host = []
        for d in data:
            buf = torch.empty((len(sel),) + tuple(d.shape[1:]),
                              dtype=torch.from_numpy(np.asarray(d[:0])).dtype,
                              pin_memory=True)
            np.take(d, sel, axis=0, out=buf.numpy(), mode="clip")  # sel is in range
            host.append(buf)
        with torch.cuda.stream(copy_stream):
            batch = tuple(h.to(dev, non_blocking=True) for h in host)
            ready = torch.cuda.Event()
            ready.record(copy_stream)
        return batch, ready

    def take(entry):
        batch, ready = entry
        if ready is not None:
            consumer = torch.cuda.current_stream(dev)
            consumer.wait_event(ready)
            for t in batch:  # memory made on the side stream, now read on this one
                t.record_stream(consumer)
        return batch

    queue = []
    for _ in range(epochs):
        order = rng.permutation(n) if shuffle else np.arange(n)
        for b in range(nb):
            queue.append(put(order[b * batch_size:(b + 1) * batch_size]))
            if len(queue) > prefetch:
                yield take(queue.pop(0))
    while queue:
        yield take(queue.pop(0))


def stream_train(step_fn, state, data, batch_size, *, epochs=1, seed=0, shuffle=True,
                 prefetch=2):
    """Drive ``step_fn(state, xs) -> (state, metrics)`` (``train.
    make_train_step``) over :func:`prefetch_batches` on the state's device.
    Returns (state, per-step metrics as numpy), read back once at the end."""
    device = next(state.params.parameters()).device
    history = []
    for xs in prefetch_batches(data, batch_size, shuffle=shuffle, seed=seed, epochs=epochs,
                               device=device, prefetch=prefetch):
        state, metrics = step_fn(state, list(xs))
        history.append(metrics)
    return state, [{k: v.detach().cpu().numpy() for k, v in m.items()} for m in history]
