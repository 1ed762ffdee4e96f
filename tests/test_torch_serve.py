"""The port's serving path against the JAX package's: Predictor endpoints,
MicroBatcher coalescing, ModelServer request handling and HTTP, the CLI,
and the checkpoint layout. Both sides run their fused-kernel path
(`use_pallas=True`): Pallas interpret mode for JAX, the plain twins for the
port on the CPU."""

import json
import os
import queue
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import jax
import numpy as np
import pytest
import torch

from vae_assoc_tpu import configs as jcfg
from vae_assoc_tpu import serve as jserve
from vae_assoc_tpu import serve_http as jhttp
from vae_assoc_tpu.models import assoc as jassoc
from vae_assoc_tpu_torch import configs as tcfg
from vae_assoc_tpu_torch import serve as tserve
from vae_assoc_tpu_torch import serve_http as thttp
from vae_assoc_tpu_torch.configs import load_model_config
from vae_assoc_tpu_torch.utils import checkpoint as tckpt

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-5  # fp32 on both sides; only the summation order may differ
N_IN = (24, 10)
N_Z = 4


def _cfg(c, n_cond):
    def arch(n_in):
        return dict(n_input=n_in, n_z=N_Z, n_hidden_recog_1=16,
                    n_hidden_recog_2=12, n_hidden_gener_1=12,
                    n_hidden_gener_2=16)

    return c.AssocConfig([
        c.ModalityConfig("image", arch(N_IN[0]), recon="bernoulli", n_cond=n_cond),
        c.ModalityConfig("trajectory", arch(N_IN[1]), recon="gaussian", n_cond=n_cond),
    ])


@pytest.fixture(scope="module", params=[0, 3], ids=["uncond", "cond3"])
def pair(request):
    """(JAX Predictor, port Predictor) sharing one set of weights."""
    n_cond = request.param
    jc, tc = _cfg(jcfg, n_cond), _cfg(tcfg, n_cond)
    params = jassoc.init_assoc(jax.random.PRNGKey(7), jc)
    jp = jserve.Predictor(params, jc, use_pallas=True)
    tp = tserve.Predictor(jax.tree.map(np.asarray, params), tc, device="cpu",
                          use_pallas=True)
    return jp, tp


def _inputs(batch, n_cond, seed=0):
    rng = np.random.default_rng(seed + batch)
    x0 = rng.uniform(0, 1, (batch, N_IN[0])).astype(np.float32)
    x1 = rng.normal(size=(batch, N_IN[1])).astype(np.float32)
    z = rng.normal(size=(batch, N_Z)).astype(np.float32)
    cond = rng.integers(0, n_cond, batch) if n_cond else None
    return x0, x1, z, cond


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("batch", [1, 5, 70])
def test_predictor_endpoints_match_jax(pair, batch):
    jp, tp = pair
    n_cond = tp.cfg.n_cond
    x0, x1, z, cond = _inputs(batch, n_cond)
    extra = [cond] if n_cond else []
    for g, w in zip(tp.transform([x0, x1] + extra), jp.transform([x0, x1] + extra)):
        assert g.shape == (batch, N_Z)
        _close(g, w)
    for m in ("image", "trajectory"):
        _close(tp.generate(z, m, cond=cond), jp.generate(z, m, cond=cond))
    _close(tp.reconstruct(x0, "image", cond=cond), jp.reconstruct(x0, "image", cond=cond))
    got = tp.cross_generate(x1, "trajectory", "image", cond=cond)
    assert got.shape == (batch, N_IN[0]) and got.min() >= 0 and got.max() <= 1
    _close(got, jp.cross_generate(x1, "trajectory", "image", cond=cond))
    _close(tp.cross_generate(x0, 0, 1, cond=cond), jp.cross_generate(x0, 0, 1, cond=cond))


def test_microbatcher_matches_direct_calls_under_concurrency(pair):
    _, tp = pair
    n_cond = tp.cfg.n_cond
    reqs = []
    for i in range(24):
        rows = 70 if i == 5 else 1 + i % 4  # one request past max_batch
        x0, x1, _, cond = _inputs(rows, n_cond, seed=100 + i)
        reqs.append((x0, 0, 1, cond) if i % 2 else (x1, 1, 0, cond))
    with tserve.MicroBatcher(tp, max_batch=32, max_wait_ms=20.0, min_batch=8) as mb:
        with ThreadPoolExecutor(max_workers=12) as ex:
            outs = list(ex.map(
                lambda r: mb.submit(r[0], r[1], r[2], cond=r[3]).result(timeout=60),
                reqs,
            ))
        assert mb.dispatches < len(reqs) + 2, "no coalescing"
    for (x, s, d, cond), got in zip(reqs, outs):
        _close(got, tp.cross_generate(x, s, d, cond=cond))
    with pytest.raises(RuntimeError, match="closed"):
        mb.submit(reqs[0][0], 0, 1, cond=reqs[0][3])


def _payloads(n_cond):
    x0, x1, z, cond = _inputs(3, n_cond, seed=11)
    c = {} if not n_cond else {"cond": cond.tolist()}
    return [
        ("/v1/transform", {"inputs": [x0.tolist(), x1.tolist()], **c}),
        ("/v1/generate", {"latents": z.tolist(), "modality": "trajectory", **c}),
        ("/v1/generate", {"latents": z.tolist(), "modality": 0, **c}),
        ("/v1/reconstruct", {"inputs": x0.tolist(), "modality": "image", **c}),
        ("/v1/cross_generate", {"inputs": x0.tolist(), "src": "image",
                                "dst": "trajectory", **c}),
        ("/v1/cross_generate", {"inputs": x1.tolist(), "src": 1, "dst": 0, **c}),
        # client errors → 400
        ("/v1/cross_generate", {"inputs": x0.tolist(), "src": "image",
                                "dst": "nope", **c}),
        ("/v1/cross_generate", {"inputs": x0.tolist(), "src": -1, "dst": 0, **c}),
        ("/v1/cross_generate", {"inputs": x0.tolist(), **c}),
        ("/v1/cross_generate", {"inputs": x0[0].tolist(), "src": 0, "dst": 1, **c}),
        ("/v1/cross_generate", {"inputs": x1.tolist(), "src": 0, "dst": 1, **c}),
        ("/v1/transform", {"inputs": [x0.tolist()], **c}),
        ("/v1/generate", {"latents": z.tolist(), "modality": "image",
                          "cond": [[1.0, 0.0]] * 3}),
        # unknown route → 404
        ("/v1/does_not_exist", {}),
    ]


def test_model_server_handle_matches_jax(pair):
    jp, tp = pair
    with jhttp.ModelServer(jp, max_batch=64, warm=False) as js, \
            thttp.ModelServer(tp, max_batch=64, warm=False) as ts:
        for path, payload in _payloads(tp.cfg.n_cond):
            j_status, j_body = js.handle(path, payload)
            t_status, t_body = ts.handle(path, payload)
            assert t_status == j_status, (path, payload, t_body, j_body)
            assert sorted(t_body) == sorted(j_body), path
            if t_status != 200:
                continue
            for k in t_body:
                if k == "latents":
                    for g, w in zip(t_body[k], j_body[k]):
                        _close(g, w)
                else:
                    _close(t_body[k], j_body[k])


def test_model_server_validates_batch_bounds(pair):
    _, tp = pair
    for kw in (dict(max_batch=1000), dict(max_batch=64, min_batch=48),
               dict(max_batch=8192)):
        with pytest.raises(ValueError):
            thttp.ModelServer(tp, warm=False, **kw)
    with pytest.raises(ValueError, match="min_batch"):
        thttp.ModelServer(tp, max_batch=64, min_batch=128, warm=False)


def _request(url, payload=None, timeout=30):
    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(url, data=data, headers={
        "Content-Type": "application/json"}, method="GET" if data is None else "POST")
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.status, json.loads(r.read())


def test_http_round_trip(pair):
    _, tp = pair
    n_cond = tp.cfg.n_cond
    x0, _, _, cond = _inputs(5, n_cond, seed=3)
    deadline = time.monotonic() + 60
    with thttp.ModelServer(tp, max_batch=16, max_wait_ms=5.0) as server:
        base = f"http://127.0.0.1:{server.start(port=0)}"
        assert _request(base + "/healthz")[1] == {
            "status": "ok", "modalities": ["image", "trajectory"]}
        payload = {"inputs": x0.tolist(), "src": "image", "dst": "trajectory"}
        if n_cond:
            payload["cond"] = cond.tolist()
        status, body = _request(base + "/v1/cross_generate", payload)
        assert status == 200
        _close(body["outputs"], tp.cross_generate(x0, 0, 1, cond=cond))
        statz = _request(base + "/statz")[1]
        assert statz["dispatches"] >= 1 and statz["min_batch"] == 16
        assert statz["n_cond"] == n_cond
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(urllib.request.Request(
                base + "/v1/cross_generate", data=b"{not json", method="POST"),
                timeout=30)
        assert e.value.code == 400
        with pytest.raises(urllib.error.HTTPError) as e:
            _request(base + "/nope")
        assert e.value.code == 404
    assert time.monotonic() < deadline


def test_save_load_round_trip(tmp_path):
    from vae_assoc_tpu_torch.models.assoc import init_assoc

    cfg = _cfg(tcfg, 3)
    tc = tcfg.TrainConfig(compute_dtype="bfloat16", use_pallas=True)
    model = init_assoc(5, cfg, device="cpu")
    tckpt.save_params(tmp_path, model, cfg, tc)
    back, cfg2, tc2 = tckpt.load_params(tmp_path, device="cpu")
    assert cfg2 == cfg and tc2 == tc
    for k, v in model.state_dict().items():
        assert torch.equal(back.state_dict()[k], v), k
    # The JAX package reads the same model_config.json.
    assert jcfg.load_model_config(str(tmp_path))[0] == _cfg(jcfg, 3)
    pred = tserve.Predictor.load(tmp_path, device="cpu")
    assert pred.compute_dtype == "bfloat16" and pred.use_pallas is True


def test_orbax_only_directory_raises(tmp_path):
    # What the JAX package's save_model writes: the config plus orbax
    # step directories, and no params.pt.
    with open(tmp_path / "model_config.json", "w") as f:
        json.dump(jcfg.config_to_dict(_cfg(jcfg, 0)), f)
    (tmp_path / "0").mkdir()
    with pytest.raises(FileNotFoundError, match="orbax"):
        tckpt.load_params(tmp_path, device="cpu")
    with pytest.raises(FileNotFoundError, match="model_config.json"):
        load_model_config(str(tmp_path / "missing"))


def test_cli_serves_and_drains_on_sigterm(tmp_path):
    from vae_assoc_tpu_torch.models.assoc import init_assoc

    cfg = _cfg(tcfg, 0)
    tckpt.save_params(tmp_path, init_assoc(0, cfg, device="cpu"), cfg)
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.Popen(
        [sys.executable, "-m", "vae_assoc_tpu_torch.serve_http", str(tmp_path),
         "--device", "cpu", "--port", "0", "--max-batch", "8"],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True,
    )
    lines: queue.Queue = queue.Queue()
    threading.Thread(target=lambda: [lines.put(l) for l in proc.stdout],
                     daemon=True).start()
    try:
        banner = lines.get(timeout=120)  # the deadline the banner must meet
        assert banner.startswith("serving ") and "(cpu)" in banner, banner
        url = banner.split(" on ")[1].split()[0]
        x = np.zeros((2, N_IN[0]), np.float32)
        status, body = _request(url + "/v1/cross_generate",
                                {"inputs": x.tolist(), "src": 0, "dst": 1})
        assert status == 200 and np.asarray(body["outputs"]).shape == (2, N_IN[1])
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
    rest = []
    while not lines.empty():
        rest.append(lines.get_nowait())
    assert "server closed\n" in rest
