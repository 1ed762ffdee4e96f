"""The port's class API (vae_assoc_tpu_torch/api.py) and metrics logging
(utils/logging.py) against the JAX package on the CPU.

Both sides hold the same weights (convert.py); the deterministic verbs
must agree at fp32 (rtol 1e-5, atol 1e-6: another summation order). The
JAX kernel path runs its Pallas kernels in interpret mode, the port's its
plain twins. Training costs are compared within the port, since the two
packages' ε streams differ by design.
"""

import sys

import jax
import numpy as np
import pytest
import torch

import vae_assoc_tpu as jv
import vae_assoc_tpu_torch as tv
from vae_assoc_tpu.utils import logging as jlog
from vae_assoc_tpu_torch import convert
from vae_assoc_tpu_torch.train import step as tstep
from vae_assoc_tpu_torch.utils import logging as tlog

RTOL, ATOL = 1e-5, 1e-6
B = 13
N_IN = (24, 12)


def _arch(n_in, hidden=16):
    return dict(n_input=n_in, n_z=4, n_hidden_recog_1=hidden, n_hidden_recog_2=hidden,
                n_hidden_gener_1=hidden, n_hidden_gener_2=hidden)


def _kw(n_cond=0):
    return dict(recon_types=["bernoulli", "gaussian"], names=["image", "trajectory"],
                n_cond=n_cond)


def _port(n_cond=0, **tc):
    return tv.AssocVariationalAutoEncoder(
        [_arch(n) for n in N_IN], train_config=tv.TrainConfig(**tc), device="cpu",
        **_kw(n_cond))


def _pair(n_cond=0, **tc):
    """(JAX model, port model) holding the JAX model's initial weights."""
    jm = jv.AssocVariationalAutoEncoder([_arch(n) for n in N_IN],
                                        train_config=jv.TrainConfig(**tc), **_kw(n_cond))
    tm = _port(n_cond, **tc)
    params = convert.from_jax_numpy(jax.tree.map(np.asarray, jm.state.params), tm.config, "cpu")
    tm.state = tstep.init_train_state(tm.config, tm.train_config, device="cpu", params=params)
    return jm, tm


def _batch(n_cond=0, batch=B, seed=1):
    r = np.random.default_rng(seed)
    xs = [r.uniform(0, 1, (batch, N_IN[0])).astype(np.float32),
          r.normal(size=(batch, N_IN[1])).astype(np.float32)]
    if n_cond:
        xs.append(r.integers(0, n_cond, batch).astype(np.int32))
    return xs


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("use_pallas", [False, True], ids=["plain", "kernels"])
@pytest.mark.parametrize("n_cond", [0, 3])
def test_deterministic_verbs_match_jax(n_cond, use_pallas):
    jm, tm = _pair(n_cond, use_pallas=use_pallas)
    xs = _batch(n_cond)
    cond = None if not n_cond else xs[2]
    for got, want in zip(tm.transform(xs), jm.transform(xs)):
        _close(got, want)
    z = np.random.default_rng(2).normal(size=(B, 4)).astype(np.float32)
    for mod in (0, "trajectory"):
        _close(tm.generate(z, mod, cond=cond), jm.generate(z, mod, cond=cond))
    for got, want in zip(tm.reconstruct(xs), jm.reconstruct(xs)):
        _close(got, want)
    for src, dst in ((0, 1), ("trajectory", "image")):
        x = xs[0 if src == 0 else 1]
        _close(tm.cross_generate(x, src, dst, cond=cond),
               jm.cross_generate(x, src, dst, cond=cond))


@pytest.mark.parametrize("use_pallas", [False, "mega", True])
def test_partial_fit_cost_is_the_train_steps(use_pallas):
    tm = _port(use_pallas=use_pallas, learning_rate=0.01)
    state = tstep.init_train_state(tm.config, tm.train_config, device="cpu")
    step = tstep.make_train_step(tm.config, tm.train_config)
    for seed in range(3):
        xs = _batch(seed=seed)
        state, m = step(state, [torch.from_numpy(x) for x in xs])
        assert tm.partial_fit(xs) == m["total"].item()
    assert tm.state.step == state.step == 3
    for p, q in zip(tm.state.params.parameters(), state.params.parameters()):
        assert torch.equal(p, q)


@pytest.mark.parametrize("tc", [{}, {"ema_decay": 0.9, "accum_steps": 2, "warmup_steps": 3,
                                     "use_pallas": "mega"}], ids=["adam", "ema_accum_mega"])
def test_save_fit_restore_fit_gives_identical_costs(tc, tmp_path):
    tm = _port(**tc)
    for seed in range(3):
        tm.partial_fit(_batch(seed=seed))
    tm.save_model(tmp_path)
    xs = _batch(seed=9)
    first = tm.partial_fit(xs)
    tm.restore_model(tmp_path)
    assert tm.state.step == 3
    assert tm.partial_fit(xs) == first


def test_load_round_trips(tmp_path):
    tm = _port(n_cond=3, use_pallas=True, compute_dtype="float32", learning_rate=0.01)
    for seed in range(2):
        tm.partial_fit(_batch(3, seed=seed))
    tm.save_model(tmp_path)
    back = tv.AssocVariationalAutoEncoder.load(tmp_path, device="cpu")
    assert back.config == tm.config and back.train_config == tm.train_config
    assert back.state.step == 2
    xs = _batch(3, seed=5)
    for got, want in zip(back.transform(xs), tm.transform(xs)):
        assert torch.equal(got, want)
    assert back.partial_fit(xs) == tm.partial_fit(xs)

    one = tv.VariationalAutoencoder(_arch(N_IN[0]), device="cpu", learning_rate=0.01)
    x = _batch()[0]
    one.partial_fit(x)
    one.save_model(tmp_path / "one")
    again = tv.VariationalAutoencoder.load(tmp_path / "one", device="cpu")
    assert torch.equal(again.transform(x), one.transform(x))
    assert torch.equal(again.reconstruct(x), one.reconstruct(x))
    assert again.partial_fit(x) == one.partial_fit(x)


def test_single_modality_verbs_match_jax():
    jm = jv.VariationalAutoencoder(_arch(N_IN[0]), recon_type="gaussian")
    tm = tv.VariationalAutoencoder(_arch(N_IN[0]), recon_type="gaussian", device="cpu")
    tm.state = tstep.init_train_state(tm.config, tm.train_config, device="cpu",
                                      params=convert.from_jax_numpy(
                                          jax.tree.map(np.asarray, jm.state.params),
                                          tm.config, "cpu"))
    x = _batch()[0]
    _close(tm.transform(x), jm.transform(x))
    _close(tm.reconstruct(x), jm.reconstruct(x))
    z = np.ones((2, 4), np.float32)
    _close(tm.generate(z), jm.generate(z))


@pytest.mark.parametrize("fused", [False, True], ids=["train_loop", "train_loop_fused"])
def test_train_fires_on_epoch_on_the_jax_epochs(fused):
    data = _batch(batch=64)
    seen = {"jax": [], "torch": []}
    kw = dict(training_epochs=5, display_step=2, fused=fused, batch_size=16, **_kw())
    _, jh = jv.train([_arch(n) for n in N_IN], data, **kw,
                     on_epoch=lambda e, h: seen["jax"].append(e))
    model, th = tv.train([_arch(n) for n in N_IN], data, device="cpu", **kw,
                         on_epoch=lambda e, h: seen["torch"].append(e))
    assert seen["torch"] == seen["jax"] == [0, 2, 4]
    assert len(th) == len(jh) == 5 and model.state.step == 5 * 4
    # The trained model keeps working through the class API, and train()
    # continues an existing model.
    model, _ = tv.train(model, data, training_epochs=1, fused=fused)
    assert model.state.step == 6 * 4 and model.transform(data)[0].shape == (64, 4)


def _jax_and_port_raise(call, tmp_path):
    types = []
    for pkg in (jv, tv):
        with pytest.raises(Exception) as e:
            call(pkg, tmp_path)
        types.append(type(e.value))
    return types


def _empty_batch(pkg, _):
    m = pkg.AssocVariationalAutoEncoder([_arch(n) for n in N_IN], **_kw(),
                                        **({"device": "cpu"} if pkg is tv else {}))
    m.partial_fit([np.zeros((0, N_IN[0]), np.float32), np.zeros((0, N_IN[1]), np.float32)])


def _label_out_of_range(pkg, _):
    m = pkg.AssocVariationalAutoEncoder([_arch(n) for n in N_IN], **_kw(3),
                                        **({"device": "cpu"} if pkg is tv else {}))
    xs = _batch(3)
    xs[2][0] = 3
    m.partial_fit(xs)


def _missing_config(pkg, tmp_path):
    kw = {"device": "cpu"} if pkg is tv else {}
    pkg.AssocVariationalAutoEncoder.load(str(tmp_path / "nothing"), **kw)


def _multi_modality_dir(pkg, tmp_path):
    kw = {"device": "cpu"} if pkg is tv else {}
    d = tmp_path / pkg.__name__
    pkg.AssocVariationalAutoEncoder([_arch(n) for n in N_IN], **_kw(), **kw).save_model(str(d))
    pkg.VariationalAutoencoder.load(str(d), **kw)


@pytest.mark.parametrize("case,want", [
    (_empty_batch, ValueError), (_label_out_of_range, ValueError),
    (_missing_config, FileNotFoundError), (_multi_modality_dir, ValueError),
], ids=["empty_batch", "label_out_of_range", "missing_model_config", "multi_modality_dir"])
def test_error_cases_raise_the_jax_types(case, want, tmp_path):
    assert _jax_and_port_raise(case, tmp_path) == [want, want]


def test_generate_and_sampled_reconstruct_draw_from_an_advancing_stream():
    tm, again = _port(seed=4), _port(seed=4)
    a, b = tm.generate(), tm.generate(modality=1)
    assert a.shape == (1, N_IN[0]) and b.shape == (1, N_IN[1])
    assert torch.equal(again.generate(), a)  # the stream is the seed's
    z = torch.randn((1, 4), generator=torch.Generator().manual_seed(5))
    assert torch.allclose(again.generate(z), tm.generate(z))  # seed + 1: the first draw
    xs = _batch()
    s1, s2 = tm.reconstruct(xs, sample=True), tm.reconstruct(xs, sample=True)
    det = tm.reconstruct(xs)
    for u, v, d, n in zip(s1, s2, det, N_IN):
        assert u.shape == d.shape == (B, n) and not torch.equal(u, v)
    cond = np.array([0, 2])
    assert _port(n_cond=3).generate(cond=cond, modality="image").shape == (2, N_IN[0])


def test_verb_outputs_do_not_alias_the_weights():
    tm = _port(learning_rate=0.1)
    xs = _batch()
    outs = [tm.transform(xs)[0], tm.reconstruct(xs)[1], tm.cross_generate(xs[0], 0, 1)]
    saved = [o.clone() for o in outs]
    tm.partial_fit(xs)
    for o, s in zip(outs, saved):
        assert torch.equal(o, s)
    assert not torch.equal(tm.transform(xs)[0], saved[0])


@pytest.mark.parametrize("cls", ["AssocVariationalAutoEncoder", "VariationalAutoencoder"])
def test_classes_default_to_cuda(cls, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    make = getattr(tv, cls)
    arg = [_arch(n) for n in N_IN] if cls.startswith("Assoc") else _arch(N_IN[0])
    for kw in ({}, {"device": "cuda"}):
        with pytest.raises(RuntimeError, match=f"{cls}\\(device='cuda'\\).*no CUDA device"):
            make(arg, **kw)
    assert make(arg, device="cpu").state.params.modalities[0].recog.h1.w.device.type == "cpu"


def test_metrics_logger_writes_the_jax_records(tmp_path, capsys):
    recs = [dict(epoch=0, total=3.5, tag="a"), dict(epoch=1, total=np.float32(2.25))]
    for mod, name in ((jlog, "jax.jsonl"), (tlog, "torch.jsonl")):
        with mod.MetricsLogger(str(tmp_path / name), echo=True) as log:
            for r in recs:
                log.write(**r)
    strip = [{k: v for k, v in r.items() if k != "t"}
             for r in tlog.read_jsonl(str(tmp_path / "torch.jsonl"))]
    assert strip == [{k: v for k, v in r.items() if k != "t"}
                     for r in jlog.read_jsonl(str(tmp_path / "jax.jsonl"))]
    assert strip[1] == {"epoch": 1.0, "total": 2.25}
    out = capsys.readouterr().out.splitlines()
    assert out[:2] == out[2:] == ["epoch=0.0 total=3.5 tag=a", "epoch=1.0 total=2.25"]


def test_tensorboard_writer(tmp_path, monkeypatch):
    try:
        import tensorboard  # noqa: F401
    except ImportError:
        pass
    else:
        with tlog.MetricsLogger(tensorboard_dir=str(tmp_path / "tb")) as log:
            log.write(step=3, total=1.0)
        assert any(p.name.startswith("events.out.tfevents")
                   for p in (tmp_path / "tb").iterdir())
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    with pytest.raises(RuntimeError, match="tensorboard package"):
        tlog.MetricsLogger(str(tmp_path / "m.jsonl"), tensorboard_dir=str(tmp_path / "tb2"))
