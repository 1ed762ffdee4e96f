"""The port's evaluation (train/eval.py) and its CLI (evaluate.py) against
the JAX package on the CPU.

Both sides hold the same weights (convert.py) and, where a draw enters,
the same ε: injected into the MLL bound, and for eval_metrics the port's
own per-chunk ε handed to the JAX loss. fp32, rtol 1e-5 and atol 1e-6
(another summation order); the JAX kernel path runs its Pallas kernels in
interpret mode, the port its plain twins.
"""

import contextlib
import importlib.util
import io
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vae_assoc_tpu as jv
import vae_assoc_tpu_torch as tv
from vae_assoc_tpu import configs as jcfg
from vae_assoc_tpu import evaluate as jeval_cli
from vae_assoc_tpu.models import assoc as jassoc
from vae_assoc_tpu.train import eval as jeval
from vae_assoc_tpu_torch import configs as tcfg
from vae_assoc_tpu_torch import convert
from vae_assoc_tpu_torch import evaluate as teval_cli
from vae_assoc_tpu_torch.train import eval as teval

RTOL, ATOL = 1e-5, 1e-6
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _arch(n_in, hidden=16):
    return dict(n_input=n_in, n_z=4, n_hidden_recog_1=hidden, n_hidden_recog_2=hidden,
                n_hidden_gener_1=hidden, n_hidden_gener_2=hidden)


def _configs(n_cond=0, encoder="mlp", n_in=(24, 12)):
    a = _arch(n_in[0], 40) if encoder != "mlp" else _arch(n_in[0])
    return [c.AssocConfig(
        [c.ModalityConfig("image", a, recon="bernoulli", encoder=encoder, n_cond=n_cond),
         c.ModalityConfig("trajectory", _arch(n_in[1]), recon="gaussian", n_cond=n_cond)])
        for c in (jcfg, tcfg)]


def _models(n_cond=0, encoder="mlp", n_in=(24, 12), seed=0):
    jc, tc = _configs(n_cond, encoder, n_in)
    jp = jassoc.init_assoc(jax.random.PRNGKey(seed), jc)
    return jc, tc, jp, convert.from_jax_numpy(jax.tree.map(np.asarray, jp), tc, "cpu")


def _data(n, n_in=(24, 12), n_cond=0, seed=1):
    r = np.random.default_rng(seed)
    xs = [r.uniform(0, 1, (n, n_in[0])).astype(np.float32),
          r.normal(size=(n, n_in[1])).astype(np.float32)]
    if n_cond:
        xs.append(np.eye(n_cond, dtype=np.float32)[r.integers(0, n_cond, n)])
    return xs


def _close(got, want, rtol=RTOL, atol=ATOL):
    assert got.keys() == want.keys(), (sorted(got), sorted(want))
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=rtol, atol=atol,
                                   err_msg=k)


@pytest.mark.parametrize("encoder,use_pallas", [("mlp", False), ("mlp", True),
                                                ("conv_pallas", False)])
def test_cross_modal_mse_matches_jax(encoder, use_pallas):
    n_in = (784, 24) if encoder != "mlp" else (24, 12)
    jc, tc, jp, tp = _models(encoder=encoder, n_in=n_in)
    xs = _data(5, n_in)
    got = teval.evaluate(tp, xs, tc, use_pallas=use_pallas)
    want = jeval.evaluate(jp, [jnp.asarray(x) for x in xs], jc, use_pallas=use_pallas)
    assert sorted(got) == ["image->image", "image->trajectory", "trajectory->image",
                           "trajectory->trajectory"]
    _close(got, want)


@pytest.mark.parametrize("n_cond,use_pallas", [(0, True), (3, False)])
def test_marginal_log_likelihood_with_injected_eps_matches_jax(n_cond, use_pallas):
    jc, tc, jp, tp = _models(n_cond)
    xs = _data(7, n_cond=n_cond)
    r = np.random.default_rng(3)
    eps = [r.normal(size=(8, 7, 4)).astype(np.float32) for _ in range(2)]
    kw = dict(n_importance=8, block=4, eps=eps, use_pallas=use_pallas)
    got = teval.marginal_log_likelihood(tp, xs, tc, **kw)
    want = jeval.marginal_log_likelihood(jp, [jnp.asarray(x) for x in xs], jc, **kw)
    _close(got, want)
    for m in ("image", "trajectory"):
        assert got[f"iwae_{m}"] >= got[f"elbo_{m}"]


def test_marginal_log_likelihood_draws_are_deterministic():
    _, tc, _, tp = _models()
    xs = _data(9)
    a = teval.marginal_log_likelihood(tp, xs, tc, n_importance=12, seed=5)
    assert a == teval.marginal_log_likelihood(tp, xs, tc, n_importance=12, seed=5,
                                              use_pallas="mega")
    assert a != teval.marginal_log_likelihood(tp, xs, tc, n_importance=12, seed=6)
    assert teval._block_size(12, None) == 6 and teval._block_size(64, None) == 8
    with pytest.raises(ValueError, match="divide"):
        teval.marginal_log_likelihood(tp, xs, tc, n_importance=12, block=5)
    for m in ("image", "trajectory"):
        assert a[f"iwae_{m}"] >= a[f"elbo_{m}"]


def test_recognition_accuracy_on_separated_latents_matches_jax():
    # Four well-separated input clusters: each latent's neighbours are
    # unambiguous, so the accuracies must agree exactly.
    jc, tc, jp, tp = _models()
    r = np.random.default_rng(4)
    labels = np.repeat(np.arange(4), 6)
    centers = [r.uniform(0, 1, (4, 24)), r.normal(size=(4, 12)) * 3]
    xs = [(c[labels] + 0.01 * r.normal(size=(24, c.shape[1]))).astype(np.float32)
          for c in centers]
    got = teval.recognition_accuracy(tp, xs, labels, tc, k=3)
    want = jeval.recognition_accuracy(jp, [jnp.asarray(x) for x in xs], labels, jc, k=3)
    assert got == want
    assert sorted(got) == ["knn_image", "knn_image->trajectory", "knn_trajectory",
                           "knn_trajectory->image"]


def test_knn_ties_go_to_the_smaller_class_as_in_jax():
    # 1-D latents with distinct distances; k = 2 draws one neighbour of each
    # class for some queries, and the vote tie goes to the smaller id.
    z = np.array([[0.0], [1.1], [2.3], [3.6], [5.0], [6.5]], np.float32)
    labels = np.array([2, 0, 1, 0, 2, 1])
    got = teval._knn_classify(torch.from_numpy(z), torch.from_numpy(labels),
                              torch.from_numpy(z), 3, 2, True).numpy()
    want = np.asarray(jeval._knn_classify(jnp.asarray(z), jnp.asarray(labels),
                                          jnp.asarray(z), 3, 2, True))
    np.testing.assert_array_equal(got, want)
    assert got[0] == 0  # neighbours 1.1 (class 0) and 2.3 (class 1): a tie


@pytest.mark.parametrize("use_pallas", [False, "mega", True])
def test_eval_metrics_matches_jax_over_the_same_chunks(use_pallas):
    jc, tc, jp, tp = _models()
    n, b, seed = 50, 16, 11
    xs = _data(n)
    got = teval.eval_metrics(tp, xs, tc, batch_size=b, seed=seed, use_pallas=use_pallas)

    @jax.jit
    def jax_metrics(chunk, eps):
        _, m = jassoc.assoc_loss_fn(jp, chunk, jc, eps=eps, use_pallas=use_pallas)
        return dict(m, **jeval.cross_modal_mse(jp, chunk, jc, use_pallas=use_pallas))

    want, rows = {}, 0
    for c, lo in enumerate(range(0, n, b)):  # three full chunks and a tail of 2
        chunk = [jnp.asarray(x[lo:lo + b]) for x in xs]
        r = int(chunk[0].shape[0])
        eps = [jnp.asarray(e.numpy()) for e in teval._chunk_eps(tc, seed, c, r, "cpu")]
        for k, v in jax_metrics(chunk, eps).items():
            want[k] = want.get(k, 0.0) + r * float(v)
        rows += r
    assert rows == n
    _close(got, {k: v / n for k, v in want.items()})
    assert teval.eval_metrics(tp, xs, tc, batch_size=b, seed=seed,
                              use_pallas=use_pallas) == got
    other = teval.eval_metrics(tp, xs, tc, batch_size=b, seed=seed + 1, use_pallas=use_pallas)
    assert other["total"] != got["total"] and other["image->trajectory"] == got[
        "image->trajectory"]


def test_label_blind_cond_matches_jax():
    np.testing.assert_array_equal(teval.label_blind_cond(5, 4), jeval.label_blind_cond(5, 4))


def _cli(main, argv) -> dict:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert main(argv) == 0
    return json.loads(buf.getvalue().strip().splitlines()[-1])


def _converter():
    spec = importlib.util.spec_from_file_location(
        "jax_checkpoint_to_torch", os.path.join(REPO, "scripts", "jax_checkpoint_to_torch.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_evaluate_cli_on_a_converted_jax_model_matches_the_jax_cli(tmp_path):
    jm = jv.AssocVariationalAutoEncoder(
        [_arch(784), _arch(200)], recon_types=["bernoulli", "gaussian"],
        names=["image", "trajectory"], batch_size=16, learning_rate=0.01)
    for x in _data(16, (784, 200)), _data(16, (784, 200), seed=2):
        jm.partial_fit(x)
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "torch")
    jm.save_model(jdir)
    _converter().convert_dir(jdir, tdir)
    flags = ["--n-samples", "48", "--batch-size", "20", "--mll-samples", "4"]
    want = _cli(jeval_cli.main, [jdir, "--cpu", *flags])
    got = _cli(teval_cli.main, [tdir, "--device", "cpu", *flags, "--json",
                                str(tmp_path / "out.json")])
    assert got == json.loads((tmp_path / "out.json").read_text())
    assert sorted(got) == sorted(want)
    assert (got["step"], got["backend"], got["n_samples"]) == (2, "cpu", 48)
    for k in want:
        if k.startswith("mse_"):
            np.testing.assert_allclose(got[k], want[k], rtol=RTOL, atol=ATOL, err_msg=k)
        elif k.startswith("knn_"):
            assert abs(got[k] - want[k]) <= 1.0 / 48, k  # at most one neighbour set
        elif k not in ("model_dir", "data", "backend"):
            assert np.isfinite(got[k]), k
    for m in ("image", "trajectory"):
        assert got[f"iwae_{m}"] >= got[f"elbo_{m}"]


@pytest.mark.parametrize("flags,match", [
    (["--data", "uji"], "requires --uji-paths"),
    (["--traj-encoding", "rbf", "--rbf-centers", "50"], "feature width mismatch"),
], ids=["uji", "rbf"])
def test_evaluate_cli_refuses_the_unported_data_surface(flags, match, tmp_path):
    """What the data surface refuses: UJI without files, and features whose
    width is not the arch's (50 RBF centers give 100, the model takes 200)."""
    tv.AssocVariationalAutoEncoder([_arch(784), _arch(200)], names=["image", "trajectory"],
                                   device="cpu").save_model(tmp_path)
    with pytest.raises(SystemExit, match=match):
        teval_cli.main([str(tmp_path), "--device", "cpu", "--n-samples", "8", *flags])
    with pytest.raises(SystemExit, match="model_config.json"):
        teval_cli.main([str(tmp_path / "missing"), "--device", "cpu"])


FIXTURE = os.path.join(REPO, "tests", "fixtures", "ujipenchars2_format.txt")


def _record_data(model_dir, traj_encoding, rbf_centers):
    """Write model_config.json's "data" section as the JAX package's
    training driver does."""
    path = os.path.join(model_dir, "model_config.json")
    with open(path) as f:
        raw = json.load(f)
    raw["data"] = {"source": "uji", "traj_encoding": traj_encoding, "rbf_centers": rbf_centers}
    with open(path, "w") as f:
        json.dump(raw, f)


def test_evaluate_cli_on_uji_matches_the_jax_cli(tmp_path):
    jm = jv.AssocVariationalAutoEncoder(
        [_arch(784), _arch(200)], recon_types=["bernoulli", "gaussian"],
        names=["image", "trajectory"], batch_size=16, learning_rate=0.01)
    jm.partial_fit(_data(16, (784, 200)))
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "torch")
    jm.save_model(jdir)
    _record_data(jdir, "resample", 100)
    _converter().convert_dir(jdir, tdir)
    flags = ["--data", "uji", "--uji-paths", FIXTURE, "--batch-size", "64",
             "--mll-samples", "2"]
    want = _cli(jeval_cli.main, [jdir, "--cpu", *flags])
    got = _cli(teval_cli.main, [tdir, "--device", "cpu", *flags])
    assert sorted(got) == sorted(want)
    assert (got["data"], got["n_samples"], got["backend"]) == ("uji", 240, "cpu")
    for k in want:
        if k.startswith("mse_"):
            np.testing.assert_allclose(got[k], want[k], rtol=RTOL, atol=ATOL, err_msg=k)
        elif k.startswith("knn_"):
            assert abs(got[k] - want[k]) <= 1.0 / 240, k  # at most one neighbour set
        elif k not in ("model_dir", "data", "backend"):
            assert np.isfinite(got[k]), k


def test_evaluate_cli_resolves_the_recorded_rbf_encoding(tmp_path):
    """A model trained on 20 RBF centers (40-wide trajectory features):
    the recorded "data" section selects the encoding, an explicit
    contradicting --traj-encoding exits, and a width off the arch exits."""
    tv.AssocVariationalAutoEncoder([_arch(784), _arch(40)], names=["image", "trajectory"],
                                   device="cpu").save_model(tmp_path)
    base = [str(tmp_path), "--device", "cpu", "--data", "uji", "--uji-paths", FIXTURE,
            "--batch-size", "64"]
    with pytest.raises(SystemExit, match="feature width mismatch"):
        teval_cli.main(base)  # nothing recorded: resample, 200 wide
    _record_data(str(tmp_path), "rbf", 20)
    res = _cli(teval_cli.main, base)
    assert res["n_samples"] == 240 and np.isfinite(res["mse_image->trajectory"])
    assert res == _cli(teval_cli.main, [*base, "--traj-encoding", "rbf"])
    with pytest.raises(SystemExit, match="contradicts the recorded"):
        teval_cli.main([*base, "--traj-encoding", "resample"])
    with pytest.raises(SystemExit, match="feature width mismatch"):
        teval_cli.main([*base, "--rbf-centers", "30"])


def test_evaluate_cli_on_a_conditional_model(tmp_path):
    m = tv.AssocVariationalAutoEncoder(
        [_arch(784), _arch(200)], recon_types=["bernoulli", "gaussian"],
        names=["image", "trajectory"], n_cond=10, device="cpu",
        train_config=tv.TrainConfig(use_pallas="mega", ema_decay=0.5))
    m.partial_fit(_data(8, (784, 200)) + [np.arange(8)])
    m.save_model(tmp_path)
    res = _cli(teval_cli.main, [str(tmp_path), "--device", "cpu", "--n-samples", "40",
                                "--batch-size", "16", "--mll-samples", "2"])
    assert "knn_image->trajectory" in res and "image->trajectory" not in res
    assert all(np.isfinite(v) for k, v in res.items() if k.startswith(("mse_", "knn_", "iwae")))
