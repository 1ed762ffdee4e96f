"""The port's export (export.py) against the JAX package's: every endpoint of
a torch.export artifact against the port's plain Predictor, the JAX
Predictor and the JAX ExportedPredictor on the same weights; the
symbolic batch across buckets, oversized-batch chunking, manifest guards,
duck-typing into the HTTP ModelServer, loading without model code and
the CLI; conditional and conv models; and the build cache
(utils/compile_cache.py, kernels/_build.py) on the CPU."""

import json
import os
import subprocess
import sys
import textwrap
import urllib.request

import jax
import numpy as np
import pytest
import torch

from vae_assoc_tpu import configs as jcfg
from vae_assoc_tpu import export as jexport
from vae_assoc_tpu import serve as jserve
from vae_assoc_tpu.models import assoc as jassoc
from vae_assoc_tpu_torch import bucketing as tbucketing
from vae_assoc_tpu_torch import configs as tcfg
from vae_assoc_tpu_torch import export as texport
from vae_assoc_tpu_torch import native
from vae_assoc_tpu_torch import serve as tserve
from vae_assoc_tpu_torch import serve_http as thttp
from vae_assoc_tpu_torch.kernels import _build
from vae_assoc_tpu_torch.utils import compile_cache
from vae_assoc_tpu_torch.utils import checkpoint as tckpt

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_TOL = dict(rtol=1e-5, atol=1e-6)  # the reference's artifact-vs-Predictor tolerance
JAX_TOL = dict(rtol=1e-5, atol=1e-5)  # fp32 on both sides; summation order may differ
N_Z = 4
ENDPOINTS = {"transform", "generate_0", "generate_1", "cross_generate_0_0",
             "cross_generate_0_1", "cross_generate_1_0", "cross_generate_1_1"}


def _arch(n_in, hidden=16):
    return dict(n_input=n_in, n_z=N_Z, n_hidden_recog_1=hidden, n_hidden_recog_2=12,
                n_hidden_gener_1=12, n_hidden_gener_2=hidden)


# name: (image width, trajectory width, n_cond, the port's image encoder)
MODELS = {"uncond": (24, 10, 0, "mlp"), "cond3": (24, 10, 3, "mlp"),
          "conv": (784, 10, 0, "conv_pallas")}


def _cfg(c, model, port):
    n_img, n_traj, n_cond, encoder = MODELS[model]
    if not port and encoder == "conv_pallas":
        encoder = "conv"  # the JAX side's plain convs: what the artifact holds
    return c.AssocConfig([
        c.ModalityConfig("image", _arch(n_img), recon="bernoulli", encoder=encoder,
                         n_cond=n_cond),
        c.ModalityConfig("trajectory", _arch(n_traj), recon="gaussian", n_cond=n_cond),
    ])


def _params(model):
    """A JAX param tree as numpy, every leaf moved off its init (biases
    too), so that parity below is not trivial."""
    params = jassoc.init_assoc(jax.random.PRNGKey(5), _cfg(jcfg, model, port=False))
    rng = np.random.default_rng(6)
    return jax.tree.map(
        lambda a: (np.asarray(a) + rng.normal(scale=0.1, size=a.shape)).astype(np.float32),
        params)


@pytest.fixture(scope="module")
def port_artifacts(tmp_path_factory):
    """model -> (port Predictor, its ExportedPredictor on the CPU, artifact
    dir, the numpy tree), each exported once a module: export traces every
    endpoint."""
    made = {}

    def get(model):
        if model not in made:
            tree = _params(model)
            tp = tserve.Predictor(tree, _cfg(tcfg, model, port=True), device="cpu")
            art = tmp_path_factory.mktemp(f"artifact_{model}")
            texport.export_predictor(tp, str(art))
            made[model] = (tp, texport.ExportedPredictor.load(str(art), device="cpu"),
                           art, tree)
        return made[model]

    return get


@pytest.fixture(scope="module", params=sorted(MODELS))
def exported(request, port_artifacts, tmp_path_factory):
    """(JAX Predictor, JAX ExportedPredictor, port Predictor, port
    ExportedPredictor, artifact dir, JAX manifest) sharing one set of
    weights."""
    model = request.param
    tp, ep, art, tree = port_artifacts(model)
    jc = _cfg(jcfg, model, port=False)
    jp = jserve.Predictor(jax.tree.map(jax.numpy.asarray, tree), jc)
    jart = tmp_path_factory.mktemp(f"jax_artifact_{model}")
    jman = jexport.export_predictor(jp, str(jart))
    return jp, jexport.ExportedPredictor.load(str(jart)), tp, ep, art, jman


@pytest.fixture(scope="module")
def uncond(port_artifacts):
    """The unconditional MLP model: the reference's remaining cases."""
    return port_artifacts("uncond")


def _requests(cfg, batch, seed=0):
    """(image, trajectory, z, cond kwargs) for one request batch."""
    rng = np.random.default_rng(seed + batch)
    n_img, n_traj = (m.arch["n_input"] for m in cfg.modalities)
    img = rng.uniform(0, 1, (batch, n_img)).astype(np.float32)
    traj = rng.normal(size=(batch, n_traj)).astype(np.float32)
    z = rng.normal(size=(batch, N_Z)).astype(np.float32)
    ck = {"cond": rng.integers(0, cfg.n_cond, batch)} if cfg.n_cond else {}
    return img, traj, z, ck


def _verbs(p, img, traj, z, ck):
    """Every endpoint of a Predictor-like object, by name."""
    out = {f"transform[{i}]": a
           for i, a in enumerate(p.transform([img, traj] + list(ck.values())))}
    for j in (0, 1):
        out[f"generate_{j}"] = p.generate(z, j, **ck)
    for i, x in enumerate((img, traj)):
        for j in (0, 1):
            out[f"cross_generate_{i}_{j}"] = p.cross_generate(x, i, j, **ck)
    out["reconstruct_1"] = p.reconstruct(traj, "trajectory", **ck)
    return out


def _all_close(got, want, tol):
    assert got.keys() == want.keys()
    for name in got:
        g, w = np.asarray(got[name]), np.asarray(want[name])
        assert g.shape == w.shape, (name, g.shape, w.shape)
        np.testing.assert_allclose(g, w, err_msg=name, **tol)


def test_export_endpoint_set_matches_reference(exported):
    *_, art, jman = exported
    manifest = json.loads((art / "manifest.json").read_text())
    assert set(manifest["endpoints"]) == set(jman["endpoints"]) == ENDPOINTS
    assert manifest["platforms"] == ["cpu"] and manifest["compute_dtype"] == "float32"
    assert manifest["torch_version"] == torch.__version__
    assert all((art / f).exists() for f in manifest["endpoints"].values())


def test_export_matches_predictor_all_endpoints(exported):
    _, _, tp, ep, _, _ = exported
    req = _requests(tp.cfg, 5)  # odd n: the pad path
    _all_close(_verbs(ep, *req), _verbs(tp, *req), PORT_TOL)


def test_export_matches_jax_predictor(exported):
    jp, _, tp, ep, _, _ = exported
    req = _requests(tp.cfg, 5, seed=1)
    _all_close(_verbs(ep, *req), _verbs(jp, *req), JAX_TOL)


def test_export_matches_jax_exported_predictor(exported):
    _, jep, tp, ep, _, _ = exported
    req = _requests(tp.cfg, 3, seed=2)
    _all_close(_verbs(ep, *req), _verbs(jep, *req), JAX_TOL)


def test_export_symbolic_batch_any_bucket(uncond, rng):
    """ONE artifact serves every bucket, batch 1 included: results are
    row-slices of each other regardless of padding bucket."""
    tp, ep, _, _ = uncond
    x = rng.uniform(0, 1, (130, 24)).astype(np.float32)  # buckets 1..256
    full = ep.cross_generate(x, 0, 1)
    assert full.shape == (130, 10)
    np.testing.assert_allclose(full, tp.cross_generate(x, 0, 1), **PORT_TOL)
    for n in (1, 2, 3):
        np.testing.assert_allclose(full[:n], ep.cross_generate(x[:n], 0, 1), **PORT_TOL)


def test_export_chunks_oversized_batches(uncond, rng, monkeypatch):
    """Batches beyond MAX_BUCKET split into device-call chunks (the same
    contract as Predictor); shrink the cap so the test stays tiny."""
    tp, ep, _, _ = uncond
    monkeypatch.setattr(tbucketing, "MAX_BUCKET", 8)  # both surfaces read it here
    calls = []
    run = ep._run
    monkeypatch.setattr(ep, "_run", lambda name, *a: calls.append(a[0].shape[0]) or run(name, *a))
    x = rng.uniform(0, 1, (20, 24)).astype(np.float32)  # 8+8+4
    np.testing.assert_allclose(ep.cross_generate(x, 0, 1), tp.cross_generate(x, 0, 1),
                               **PORT_TOL)
    assert calls == [8, 8, 4]
    y = rng.normal(size=(20, 10)).astype(np.float32)
    for za, zb in zip(ep.transform([x, y]), tp.transform([x, y])):
        np.testing.assert_allclose(za, zb, **PORT_TOL)
    z = rng.normal(size=(20, N_Z)).astype(np.float32)
    np.testing.assert_allclose(ep.generate(z, 1), tp.generate(z, 1), **PORT_TOL)


def test_export_manifest_guards(uncond, tmp_path):
    _, _, art, _ = uncond
    with pytest.raises(FileNotFoundError, match="manifest"):
        texport.ExportedPredictor.load(str(tmp_path / "nowhere"), device="cpu")
    bad = tmp_path / "bad_format"
    bad.mkdir()
    mf = json.loads((art / "manifest.json").read_text())
    mf["format"] = 999
    (bad / "manifest.json").write_text(json.dumps(mf))
    with pytest.raises(ValueError, match="format"):
        texport.ExportedPredictor.load(str(bad), device="cpu")
    with pytest.raises(ValueError, match="platforms"):
        texport.export_predictor(uncond[0], str(tmp_path / "tpu"), platforms=["tpu"])


def test_export_load_expands_home(uncond, rng, monkeypatch):
    """'~'-relative artifact paths load: the manifest and the endpoint
    files are read from one expanded path."""
    tp, _, art, _ = uncond
    monkeypatch.setenv("HOME", os.path.dirname(str(art)))
    ep = texport.ExportedPredictor.load("~/" + os.path.basename(str(art)), device="cpu")
    x = rng.uniform(0, 1, (4, 24)).astype(np.float32)
    np.testing.assert_allclose(ep.cross_generate(x, 0, 1), tp.cross_generate(x, 0, 1),
                               **PORT_TOL)


def test_export_serves_over_http(uncond, rng):
    """ExportedPredictor duck-types into ModelServer + MicroBatcher: the
    full HTTP path works with no model classes behind it."""
    tp, ep, _, _ = uncond
    args = thttp._build_parser().parse_args(
        ["some_dir", "--from-export", "--compile-cache", "cache_dir"])
    assert args.from_export and args.compile_cache == "cache_dir"
    assert args.device == "cuda"
    x = rng.uniform(0, 1, (3, 24)).astype(np.float32)
    with thttp.ModelServer(ep, max_batch=8, max_wait_ms=5.0) as server:
        port = server.start()
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/v1/cross_generate",
            data=json.dumps({"inputs": x.tolist(), "src": "image",
                             "dst": "trajectory"}).encode(),
            headers={"Content-Type": "application/json"}, method="POST")
        with urllib.request.urlopen(req, timeout=30) as r:
            out = np.asarray(json.loads(r.read())["outputs"], np.float32)
        status, body = server.handle("/v1/cross_generate", {
            "inputs": np.zeros((2, 5)).tolist(), "src": "image", "dst": "trajectory"})
    np.testing.assert_allclose(out, tp.cross_generate(x, 0, 1), rtol=1e-4, atol=1e-6)
    assert status == 400 and "[batch, 24]" in body["error"]


def test_export_loads_without_model_code(uncond):
    """Self-containment: serving an artifact needs no model code and no
    checkpoint restore. Poisoning models/ AND serve/ in sys.modules after
    load proves no endpoint CALL touches either."""
    _, _, art, _ = uncond
    prog = textwrap.dedent(f"""
        import sys
        import numpy as np
        from vae_assoc_tpu_torch.export import ExportedPredictor
        ep = ExportedPredictor.load({str(art)!r}, device="cpu")
        for name in list(sys.modules):
            if "vae_assoc_tpu_torch.models" in name or name.endswith(".serve"):
                del sys.modules[name]
        sys.modules["vae_assoc_tpu_torch.models"] = None  # import would raise
        sys.modules["vae_assoc_tpu_torch.serve"] = None
        out = ep.cross_generate(np.zeros((2, 24), np.float32), 0, 1)
        assert out.shape == (2, 10), out.shape
        zs = ep.transform([np.zeros((2, 24), np.float32), np.zeros((2, 10), np.float32)])
        assert zs[0].shape == (2, {N_Z}), zs[0].shape
        assert ep.generate(np.zeros((1, {N_Z}), np.float32), 0).shape == (1, 24)
        print("SELF_CONTAINED_OK")
    """)
    r = subprocess.run([sys.executable, "-c", prog], capture_output=True, text=True,
                       timeout=300, cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO))
    assert r.returncode == 0, r.stderr[-3000:]
    assert "SELF_CONTAINED_OK" in r.stdout


def test_export_cli_roundtrip(uncond, tmp_path, rng):
    """`python -m vae_assoc_tpu_torch.export model_dir out_dir --device cpu`
    writes a loadable artifact from a save_params directory."""
    tp, _, _, _ = uncond
    save_dir = tmp_path / "saved"
    tckpt.save_params(str(save_dir), tp.params, tp.cfg)
    out_dir = tmp_path / "artifact"
    r = subprocess.run(
        [sys.executable, "-m", "vae_assoc_tpu_torch.export", str(save_dir), str(out_dir),
         "--device", "cpu"],
        capture_output=True, text=True, timeout=300, cwd=REPO,
        env=dict(os.environ, PYTHONPATH=REPO))
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.strip() == f"exported 7 endpoints (platforms=['cpu']) -> {out_dir}"
    ep = texport.ExportedPredictor.load(str(out_dir), device="cpu")
    x = rng.uniform(0, 1, (3, 24)).astype(np.float32)
    pred = tserve.Predictor.load(str(save_dir), device="cpu")
    np.testing.assert_allclose(ep.cross_generate(x, 0, 1), pred.cross_generate(x, 0, 1),
                               **PORT_TOL)


# --- port-only cases -----------------------------------------------------------------


def test_kernel_predictor_exports_the_plain_artifact(uncond, tmp_path):
    """A Predictor on the megakernel setting exports the plain formulation:
    the same outputs, bit for bit, as the artifact of a plain Predictor."""
    tp, ep, _, tree = uncond
    mega = tserve.Predictor(tree, tp.cfg, device="cpu", use_pallas="mega")
    texport.export_predictor(mega, str(tmp_path / "mega"))
    got = texport.ExportedPredictor.load(str(tmp_path / "mega"), device="cpu")
    req = _requests(tp.cfg, 6, seed=3)
    want = _verbs(ep, *req)
    for name, g in _verbs(got, *req).items():
        np.testing.assert_array_equal(g, want[name], err_msg=name)


def test_load_and_cli_default_to_the_card(uncond, tmp_path, monkeypatch):
    """ExportedPredictor.load and the export CLI run on the card unless
    told otherwise, and raise without one: nothing falls back."""
    tp, _, art, _ = uncond
    tckpt.save_params(str(tmp_path / "saved"), tp.params, tp.cfg)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        texport.ExportedPredictor.load(str(art))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        texport.main([str(tmp_path / "saved"), str(tmp_path / "out")])
    assert not (tmp_path / "out").exists()


def test_bad_request_width_raises_value_error(uncond):
    _, ep, _, _ = uncond
    with pytest.raises(ValueError, match=r"'image' expects a \[batch, 24\] input"):
        ep.cross_generate(np.zeros((2, 23), np.float32), "image", "trajectory")
    with pytest.raises(ValueError, match=r"'trajectory' expects a \[batch, 4\] latent"):
        ep.generate(np.zeros((2, 5), np.float32), "trajectory")
    with pytest.raises(ValueError, match=r"'trajectory' expects a \[batch, 10\] input"):
        ep.transform([np.zeros((2, 24), np.float32), np.zeros((2, 11), np.float32)])
    with pytest.raises(ValueError, match="expected 2 modality inputs"):
        ep.transform([np.zeros((2, 24), np.float32)])
    with pytest.raises(ValueError, match="unconditional"):
        ep.generate(np.zeros((2, N_Z), np.float32), 0, cond=np.zeros(2, int))


def test_conditional_transform_checks_arity(port_artifacts):
    tp, ep, _, _ = port_artifacts("cond3")
    img, traj, _, ck = _requests(tp.cfg, 4)
    with pytest.raises(ValueError, match=r"transform takes \[x_0..x_1, cond\], got 2"):
        ep.transform([img, traj])
    with pytest.raises(ValueError, match="every request needs `cond`"):
        ep.cross_generate(img, 0, 1)
    onehot = np.eye(tp.cfg.n_cond, dtype=np.float32)[ck["cond"]]
    np.testing.assert_allclose(ep.cross_generate(img, 0, 1, cond=onehot),
                               tp.cross_generate(img, 0, 1, **ck), **PORT_TOL)


# --- the build cache ---------------------------------------------------------------


def _run(code, env=None):
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(code)], capture_output=True,
                       text=True, timeout=300, cwd=REPO,
                       env=dict(os.environ, PYTHONPATH=REPO, **(env or {})))
    assert r.returncode == 0, r.stderr[-3000:]
    return r.stdout


def test_compile_cache_builds_the_parser_under_dir_and_reloads_it(tmp_path):
    """The UJI parser's g++ build lands under the cache directory; a second
    process with the same directory and no g++ on PATH loads it unchanged;
    moving the cache after a load raises, naming the loaded library."""
    cache = tmp_path / "cache"
    code = f"""
        import os
        from vae_assoc_tpu_torch import native
        from vae_assoc_tpu_torch.utils import enable_compile_cache
        assert enable_compile_cache({str(cache)!r}) == {str(cache)!r}
        assert native.available()
        lib = native.build()
        print(lib, os.stat(lib).st_mtime_ns)
        try:
            enable_compile_cache({str(tmp_path / 'other')!r})
        except RuntimeError as e:
            assert str(lib) in str(e), e
        else:
            raise AssertionError("no error after a load from another directory")
    """
    first = _run(code).split()
    lib = first[0]
    assert lib.startswith(str(cache / "native") + os.sep) and os.path.exists(lib)
    second = _run(code, env={"PATH": str(tmp_path / "empty")}).split()
    assert second == first  # the same library, not rebuilt


def test_enable_compile_cache_points_both_builds_at_dir(tmp_path, monkeypatch):
    for mod in (_build, native):
        monkeypatch.setattr(mod, "BUILD_DIR", mod.BUILD_DIR)
        monkeypatch.setattr(mod, "_lib", None)
    cache = tmp_path / "cache"
    assert compile_cache.enable_compile_cache(cache, min_compile_time_secs=5.0) == str(cache)
    assert cache.is_dir()
    assert _build.BUILD_DIR == cache.resolve() / "kernels"
    assert native.BUILD_DIR == cache.resolve() / "native"
    assert _build.library_path().parent.parent == _build.BUILD_DIR
    # The same directory again is no move.
    compile_cache.enable_compile_cache(str(cache))


def test_enable_compile_cache_refuses_after_a_load_and_moves_nothing(tmp_path, monkeypatch):
    class Loaded:
        _name = str(tmp_path / "elsewhere" / "0123" / _build.LIB_NAME)

    for mod in (_build, native):
        monkeypatch.setattr(mod, "BUILD_DIR", mod.BUILD_DIR)
    monkeypatch.setattr(_build, "_lib", None)
    monkeypatch.setattr(native, "_lib", Loaded())
    before = (_build.BUILD_DIR, native.BUILD_DIR)
    with pytest.raises(RuntimeError, match="0123"):
        compile_cache.enable_compile_cache(tmp_path / "cache")
    assert (_build.BUILD_DIR, native.BUILD_DIR) == before


def test_build_loads_a_built_library_without_nvcc(tmp_path, monkeypatch):
    """A warm cache needs no compiler: build() returns the library of this
    hash before it looks for nvcc; a cold one still raises."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "kernels")

    def no_nvcc():
        raise RuntimeError("nvcc not found: test")

    monkeypatch.setattr(_build, "find_nvcc", no_nvcc)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()
    lib = _build.library_path()
    assert lib.parent.parent == tmp_path / "kernels"
    lib.parent.mkdir(parents=True)
    lib.write_bytes(b"built")
    assert _build.build() == lib
