"""The port's whole-state checkpoints (utils/checkpoint.py), eval_params,
the Predictor's constructors over them, and the converter from the JAX
package's orbax checkpoints (scripts/jax_checkpoint_to_torch.py), on the
CPU."""

import importlib.util
import os
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vae_assoc_tpu as jv
import vae_assoc_tpu_torch as tv
from vae_assoc_tpu.train import step as jstep
from vae_assoc_tpu_torch import convert
from vae_assoc_tpu_torch import serve as tserve
from vae_assoc_tpu_torch.models.assoc import init_assoc
from vae_assoc_tpu_torch.train import step as tstep
from vae_assoc_tpu_torch.utils import checkpoint as tckpt

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_IN = (24, 12)
B = 11


def _converter():
    spec = importlib.util.spec_from_file_location(
        "jax_checkpoint_to_torch", os.path.join(REPO, "scripts", "jax_checkpoint_to_torch.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _arch(n_in):
    return dict(n_input=n_in, n_z=4, n_hidden_recog_1=16, n_hidden_recog_2=16,
                n_hidden_gener_1=16, n_hidden_gener_2=16)


def _kw():
    return dict(recon_types=["bernoulli", "gaussian"], names=["image", "trajectory"])


def _port(**tc):
    return tv.AssocVariationalAutoEncoder([_arch(n) for n in N_IN], device="cpu",
                                          train_config=tv.TrainConfig(**tc), **_kw())


def _batch(seed):
    r = np.random.default_rng(seed)
    return [r.uniform(0, 1, (B, N_IN[0])).astype(np.float32),
            r.normal(size=(B, N_IN[1])).astype(np.float32)]


def _flat_state(state) -> dict:
    """Every field of a port TrainState, as host tensors and ints."""
    opt = state.opt_state
    out = {"step": state.step, "seed": state.seed, "count": opt.adam.count,
           "ema_count": opt.ema_count, "mini_step": opt.mini_step}
    for k, v in state.params.state_dict().items():
        out[k] = v.clone()
    for name in ("mu", "nu"):
        for i, t in enumerate(getattr(opt.adam, name)):
            out[f"{name}{i}"] = t.clone()
    for name in ("ema", "acc"):
        for i, t in enumerate(getattr(opt, name) or []):
            out[f"{name}{i}"] = t.clone()
    return out


def _assert_same(a: dict, b: dict):
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], torch.Tensor):
            assert torch.equal(a[k], b[k]), k
        else:
            assert a[k] == b[k], k


def test_whole_state_round_trips_mid_cycle(tmp_path):
    # EMA and accum_steps = 2, saved after 3 micro-steps: mini_step 1, the
    # accumulator holding one gradient.
    tm = _port(ema_decay=0.9, accum_steps=2, seed=7, learning_rate=0.01)
    for s in range(3):
        tm.partial_fit(_batch(s))
    opt = tm.state.opt_state
    assert (tm.state.step, opt.mini_step, opt.adam.count, opt.ema_count) == (3, 1, 1, 1)
    want = _flat_state(tm.state)
    tckpt.save(tmp_path, tm.state)
    fresh = tstep.init_train_state(tm.config, tm.train_config, device="cpu")
    _assert_same(_flat_state(tckpt.restore(tmp_path, fresh)), want)
    # The restored state continues exactly as the saved one does.
    other = _port(ema_decay=0.9, accum_steps=2, seed=7, learning_rate=0.01)
    other.restore_model(tmp_path)
    for s in range(3, 6):
        assert other.partial_fit(_batch(s)) == tm.partial_fit(_batch(s))
    _assert_same(_flat_state(other.state), _flat_state(tm.state))


def test_restore_refuses_another_optimizer_layout(tmp_path):
    tm = _port()
    tckpt.save(tmp_path, tm.state)
    ema = tstep.init_train_state(tm.config, tv.TrainConfig(ema_decay=0.5), device="cpu")
    with pytest.raises(ValueError, match="EMA"):
        tckpt.restore(tmp_path, ema)
    with pytest.raises(FileNotFoundError, match="step 9"):
        tckpt.restore(tmp_path, tm.state, step=9)


def test_keep_prunes_to_the_newest(tmp_path):
    tm = _port()
    for s in range(5):
        tm.partial_fit(_batch(s))
        tckpt.save(tmp_path, tm.state, keep=3)
    assert tckpt.all_steps(tmp_path) == [3, 4, 5]
    assert tckpt.latest_step(tmp_path) == 5
    assert sorted(os.listdir(tmp_path)) == ["step_3", "step_4", "step_5"]


def test_saving_a_step_again_replaces_it_whole(tmp_path):
    tm = _port(learning_rate=0.1)
    tm.partial_fit(_batch(0))
    tckpt.save(tmp_path, tm.state)
    # A write cut short leaves no state file, and no step is listed for it.
    os.makedirs(tmp_path / "step_7")
    (tmp_path / "step_7" / (tckpt.STATE_FILE + ".tmp")).write_bytes(b"partial")
    assert tckpt.all_steps(tmp_path) == [1]
    tm.partial_fit(_batch(1))
    want = _flat_state(tm.state)
    tckpt.save(tmp_path, tm.state, step=1)  # the same step, newer weights
    assert os.listdir(tmp_path / "step_1") == [tckpt.STATE_FILE]
    fresh = tstep.init_train_state(tm.config, tm.train_config, device="cpu")
    _assert_same(_flat_state(tckpt.restore(tmp_path, fresh, step=1)), want)


def test_async_save_keeps_the_state_it_was_given(tmp_path):
    tm = _port(learning_rate=0.1)
    tm.partial_fit(_batch(0))
    want = _flat_state(tm.state)
    tckpt.save(tmp_path, tm.state, block=False)
    for s in range(1, 4):  # the step updates the weights in place
        tm.partial_fit(_batch(s))
    tckpt.wait(tmp_path)
    fresh = tstep.init_train_state(tm.config, tm.train_config, device="cpu")
    _assert_same(_flat_state(tckpt.restore(tmp_path, fresh)), want)


def test_predictor_load_picks_the_named_step(tmp_path):
    tm = _port(learning_rate=0.1)
    x = _batch(9)[0]
    outs = {}
    for s in (1, 2):
        tm.partial_fit(_batch(s))
        tm.save_model(tmp_path)
        outs[s] = tm.cross_generate(x, 0, 1).numpy()
    assert not np.array_equal(outs[1], outs[2])
    for step, want in ((1, outs[1]), (2, outs[2]), (None, outs[2])):
        pred = tserve.Predictor.load(tmp_path, step=step, device="cpu")
        np.testing.assert_allclose(pred.cross_generate(x, 0, 1), want, rtol=1e-6, atol=1e-7)
    pred = tserve.Predictor.from_checkpoint(tmp_path, tm.config, step=1, device="cpu")
    np.testing.assert_allclose(pred.cross_generate(x, 0, 1), outs[1], rtol=1e-6, atol=1e-7)


def test_from_model_does_not_alias(tmp_path):
    tm = _port(learning_rate=0.1)
    x = _batch(3)[0]
    pred = tserve.Predictor.from_model(tm)
    assert pred.device == tm.device
    before = pred.cross_generate(x, 0, 1)
    np.testing.assert_allclose(before, tm.cross_generate(x, 0, 1).numpy(), rtol=1e-6, atol=1e-7)
    tm.partial_fit(_batch(4))
    np.testing.assert_array_equal(pred.cross_generate(x, 0, 1), before)
    assert not np.allclose(tm.cross_generate(x, 0, 1).numpy(), before)


@pytest.mark.parametrize("count", [0, 3])
def test_eval_params_matches_jax(count):
    decay = 0.9
    jtc, ttc = jv.TrainConfig(ema_decay=decay), tv.TrainConfig(ema_decay=decay)
    jc = jv.AssocVariationalAutoEncoder([_arch(n) for n in N_IN], train_config=jtc,
                                        **_kw()).config
    js = jstep.init_train_state(jc, jtc)
    ema_tree = jax.tree.map(lambda p: p * 0.5 + 0.25, js.params)
    inner, _ = js.opt_state
    js = js._replace(opt_state=(inner, jstep.EmaState(jnp.int32(count), ema_tree)))
    tm = _port(ema_decay=decay)
    ts = convert.train_state_from_jax_numpy(
        jax.tree.map(np.asarray, js.params),
        (0, jax.tree.map(np.asarray, js.params), jax.tree.map(np.asarray, js.params)),
        0, tm.config, ttc, "cpu", ema=(count, jax.tree.map(np.asarray, ema_tree)))
    got = tstep.eval_params(ttc, ts)
    assert (got is ts.params) == (count == 0)
    want = dict(convert._flatten(jax.tree.map(np.asarray, jstep.eval_params(jtc, js))))
    for k, v in got.state_dict().items():
        np.testing.assert_allclose(v.numpy(), want[k], rtol=1e-6, atol=1e-7, err_msg=k)
    assert tstep.eval_params(tv.TrainConfig(), ts) is ts.params


def test_params_directory_of_save_params_still_loads(tmp_path):
    cfg = _port().config
    tc = tv.TrainConfig(use_pallas=True)
    model = init_assoc(5, cfg, device="cpu")
    tckpt.save_params(tmp_path, model, cfg, tc)
    back, cfg2, tc2 = tckpt.load_params(tmp_path, device="cpu")
    assert cfg2 == cfg and tc2 == tc
    for k, v in model.state_dict().items():
        assert torch.equal(back.state_dict()[k], v), k
    pred = tserve.Predictor.load(tmp_path, device="cpu")
    assert pred.use_pallas is True
    with pytest.raises(FileNotFoundError, match="no checkpoint of step 0"):
        tserve.Predictor.load(tmp_path, step=0, device="cpu")


def test_orbax_only_directory_names_the_converter(tmp_path):
    jm = jv.AssocVariationalAutoEncoder([_arch(n) for n in N_IN], **_kw())
    jm.save_model(str(tmp_path))
    for call in (lambda: tckpt.load_params(tmp_path, device="cpu"),
                 lambda: tserve.Predictor.load(tmp_path, device="cpu"),
                 lambda: tv.AssocVariationalAutoEncoder.load(tmp_path, device="cpu")):
        with pytest.raises(FileNotFoundError, match="orbax.*jax_checkpoint_to_torch.py"):
            call()


def test_converter_carries_the_whole_state(tmp_path):
    # A JAX run with EMA, warmup and accum_steps = 2 saved mid-cycle; the
    # converted state holds every number the port's state has.
    tc = dict(ema_decay=0.9, accum_steps=2, warmup_steps=2, batch_size=B, learning_rate=0.01)
    jm = jv.AssocVariationalAutoEncoder([_arch(n) for n in N_IN],
                                        train_config=jv.TrainConfig(**tc), **_kw())
    for s in range(5):
        jm.partial_fit(_batch(s))
    jm.save_model(str(tmp_path / "jax"))
    _converter().convert_dir(str(tmp_path / "jax"), str(tmp_path / "torch"))
    assert (open(tmp_path / "jax" / "model_config.json").read()
            == open(tmp_path / "torch" / "model_config.json").read())
    tm = tv.AssocVariationalAutoEncoder.load(tmp_path / "torch", device="cpu")
    multi = jm.state.opt_state
    (adam, _), ema = multi.inner_opt_state
    opt = tm.state.opt_state
    assert (tm.state.step, opt.adam.count, opt.ema_count, opt.mini_step) == (
        5, int(adam.count), int(ema.count), int(multi.mini_step)) == (5, 2, 2, 1)
    names = [k for k, _ in tm.state.params.named_parameters()]
    for got, tree in ((list(tm.state.params.parameters()), jm.state.params),
                      (opt.adam.mu, adam.mu), (opt.adam.nu, adam.nu), (opt.ema, ema.ema),
                      (opt.acc, multi.acc_grads)):
        flat = dict(convert._flatten(jax.tree.map(np.asarray, tree)))
        for name, t in zip(names, got):
            np.testing.assert_array_equal(t.detach().numpy(), flat[name], err_msg=name)


class _Unknown(NamedTuple):
    velocity: jax.Array


def test_converter_names_a_field_it_cannot_carry():
    conv = _converter()
    js = jstep.init_train_state(
        jv.AssocVariationalAutoEncoder([_arch(n) for n in N_IN], **_kw()).config,
        jv.TrainConfig())
    with pytest.raises(ValueError, match=r"opt_state\[1\]: .*_Unknown \(velocity\)"):
        conv.optimizer_parts((js.opt_state[0], _Unknown(jnp.zeros(3))))
    adam = js.opt_state[0]
    with pytest.raises(ValueError, match="schedule_count"):
        import optax

        conv.optimizer_parts((adam, optax.ScaleByScheduleState(jnp.int32(4))))
    assert conv.optimizer_parts(js.opt_state)["adam"][0] == 0
