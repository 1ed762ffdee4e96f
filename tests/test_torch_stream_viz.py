"""The port's streamed input (data/stream.py) and plots (utils/viz.py)
against the JAX package's.

Batches are copies of rows, so they are held bit for bit; so are the
arrays each plot draws, which both packages compute in numpy on the host
from the same inputs (the port's given as tensors).
"""

import dataclasses

import matplotlib
import numpy as np
import pytest
import torch

matplotlib.use("Agg")

from vae_assoc_tpu.data import stream as jstream  # noqa: E402
from vae_assoc_tpu.utils import viz as jviz  # noqa: E402
from vae_assoc_tpu_torch import configs as tcfg  # noqa: E402
from vae_assoc_tpu_torch.data import stream as tstream  # noqa: E402
from vae_assoc_tpu_torch.train import step as tstep  # noqa: E402
from vae_assoc_tpu_torch.utils import viz as tviz  # noqa: E402

# The first torch.sqrt a process runs on the CPU has been seen to compute one
# thread's share of a large tensor with a coarser routine (errors of 3e-4
# relative, in about one process of eight); after one small call every later
# call is exact. Every worker imports this module while collecting.
torch.sqrt(torch.ones(4))


def _data(n=37, seed=0):
    r = np.random.default_rng(seed)
    return [r.uniform(0, 1, (n, 6)).astype(np.float32),
            r.normal(size=(n, 4)).astype(np.float32)]


@pytest.mark.parametrize("shuffle,prefetch", [(True, 2), (False, 0), (True, 5)])
def test_prefetch_batches_yields_the_jax_batches_in_order(shuffle, prefetch):
    data = _data()
    kw = dict(shuffle=shuffle, seed=4, epochs=2, prefetch=prefetch)
    got = list(tstream.prefetch_batches(data, 8, device="cpu", **kw))
    want = list(jstream.prefetch_batches(data, 8, **kw))
    assert len(got) == len(want) == 8  # 4 whole batches an epoch, 5 rows dropped
    for g, w in zip(got, want):
        assert [t.device.type for t in g] == ["cpu", "cpu"]
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    with pytest.raises(ValueError, match="batch_size"):
        next(tstream.prefetch_batches(data, 64, device="cpu"))
    with pytest.raises(ValueError, match="rows"):
        next(tstream.prefetch_batches([data[0], data[1][:5]], 8, device="cpu"))


def test_prefetch_batches_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        next(tstream.prefetch_batches(_data(), 8))


def test_stream_train_equals_a_synchronous_loop():
    arch = [dict(n_input=w, n_z=2, n_hidden_recog_1=8, n_hidden_recog_2=8,
                 n_hidden_gener_1=8, n_hidden_gener_2=8) for w in (6, 4)]
    cfg = tcfg.AssocConfig([tcfg.ModalityConfig("image", arch[0], recon="bernoulli"),
                            tcfg.ModalityConfig("trajectory", arch[1], recon="gaussian")])
    tc = dataclasses.replace(tcfg.TrainConfig(batch_size=8), use_pallas=False)
    data = _data(40)
    step_fn = tstep.make_train_step(cfg, tc)
    state, hist = tstream.stream_train(step_fn, tstep.init_train_state(cfg, tc, device="cpu"),
                                       data, 8, epochs=2, seed=1)
    ref = tstep.init_train_state(cfg, tc, device="cpu")
    rng, totals = np.random.default_rng(1), []
    for _ in range(2):
        order = rng.permutation(40)
        for b in range(5):
            sel = order[b * 8:(b + 1) * 8]
            ref, m = step_fn(ref, [torch.from_numpy(d[sel]) for d in data])
            totals.append(float(m["total"]))
    assert state.step == ref.step == 10
    assert [float(h["total"]) for h in hist] == totals
    for p, q in zip(state.params.parameters(), ref.params.parameters()):
        assert torch.equal(p, q)


def _drawn(fig):
    """Every array a figure draws: images, line and scatter data."""
    out = []
    for ax in fig.axes:
        out += [np.asarray(im.get_array()) for im in ax.images]
        out += [np.asarray(line.get_xydata()) for line in ax.lines]
        for c in ax.collections:
            out.append(np.asarray(c.get_offsets()))
            if c.get_array() is not None:
                out.append(np.asarray(c.get_array()))
    return out


def _same_drawing(got, want):
    import matplotlib.pyplot as plt

    a, b = _drawn(got), _drawn(want)
    assert len(a) == len(b) > 0
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    plt.close(got)
    plt.close(want)


def _decode(z):
    return np.clip(0.5 + 0.1 * z[:, :1] + np.zeros((z.shape[0], 784)), 0, 1)


def _by_class(labels):
    return np.repeat(labels[:, None] / 4.0, 784, axis=1)


def _plots():
    """name → (port call on tensors, JAX call on arrays) of each plot."""
    r = np.random.default_rng(2)
    imgs = r.uniform(0, 1, (5, 784)).astype(np.float32)
    recon = r.uniform(0, 1, (5, 784)).astype(np.float32)
    trajs = r.uniform(-1, 1, (5, 60)).astype(np.float32)
    z = r.normal(size=(30, 4)).astype(np.float32)
    labels = r.integers(0, 3, 30)
    t = torch.from_numpy
    return {
        "reconstruction_grid": (lambda: tviz.reconstruction_grid(t(imgs), t(recon), n=4),
                                lambda: jviz.reconstruction_grid(imgs, recon, n=4)),
        "reconstruction_grid_one": (
            lambda: tviz.reconstruction_grid(t(imgs[:1]), t(recon), n=4),
            lambda: jviz.reconstruction_grid(imgs[:1], recon, n=4)),
        "trajectories_over_images": (
            lambda: tviz.trajectories_over_images(t(imgs), t(trajs), n=8),
            lambda: jviz.trajectories_over_images(imgs, trajs, n=8)),
        "latent_scatter": (lambda: tviz.latent_scatter(t(z), t(labels), dims=(1, 3)),
                           lambda: jviz.latent_scatter(z, labels, dims=(1, 3))),
        "latent_scatter_unlabeled": (lambda: tviz.latent_scatter(t(z)),
                                     lambda: jviz.latent_scatter(z)),
        # a port decoder returns a tensor
        "latent_manifold": (
            lambda: tviz.latent_manifold(lambda z: torch.from_numpy(_decode(z)), grid_n=5,
                                         n_z=20, dims=(0, 3)),
            lambda: jviz.latent_manifold(_decode, grid_n=5, n_z=20, dims=(0, 3))),
        "class_generation_grid": (
            lambda: tviz.class_generation_grid(lambda lab: torch.from_numpy(_by_class(lab)),
                                               4, samples_per_class=3),
            lambda: jviz.class_generation_grid(_by_class, 4, samples_per_class=3)),
    }


@pytest.mark.parametrize("name", list(_plots()))
def test_each_plot_draws_the_jax_plots_arrays(name):
    ours, theirs = _plots()[name]
    _same_drawing(ours(), theirs())


def test_latent_manifold_decodes_once_and_checks_its_base():
    calls = []

    def decode(z):
        calls.append(z.shape)
        return _decode(z)

    fig = tviz.latent_manifold(decode, grid_n=5, n_z=20, dims=(0, 3))
    assert calls == [(25, 20)]
    import matplotlib.pyplot as plt

    plt.close(fig)
    with pytest.raises(ValueError, match="base"):
        tviz.latent_manifold(decode, n_z=20, base=torch.zeros(3))
