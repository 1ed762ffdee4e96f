"""Configs of the PyTorch port against the JAX package's: the shared
``model_config.json`` schema in both directions, the transfer functions,
and a port that never imports jax."""

import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vae_assoc_tpu import configs as jcfg
from vae_assoc_tpu_torch import configs as tcfg

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _conditional(c):
    """A conditional, deeper, mixed-transfer config in either package."""
    mods = [
        c.ModalityConfig("image", c.default_image_arch(depth=3),
                         recon="bernoulli", n_cond=10),
        c.ModalityConfig("trajectory", c.default_traj_arch(hidden=64),
                         recon="gaussian", transfer="gelu", n_cond=10),
    ]
    return c.AssocConfig(mods, assoc_lambda=0.5, assoc_form="infonce",
                         assoc_negatives="global")


def _jax_case(case):
    if case == "conditional":
        return _conditional(jcfg), jcfg.TrainConfig(
            compute_dtype=jnp.bfloat16, use_pallas=True, ema_decay=0.99)
    return jcfg.baseline_config(case)


def _port_case(case):
    if case == "conditional":
        return _conditional(tcfg), tcfg.TrainConfig(
            compute_dtype="bfloat16", use_pallas=True, ema_decay=0.99)
    return tcfg.baseline_config(case)


CASES = [1, 2, 3, 4, 5, "conditional"]


@pytest.mark.parametrize("case", CASES)
def test_jax_json_reads_into_port_unchanged(case):
    d = json.loads(json.dumps(jcfg.config_to_dict(*_jax_case(case))))
    cfg, tc = tcfg.config_from_dict(d)
    assert tcfg.config_to_dict(cfg, tc) == d


@pytest.mark.parametrize("case", CASES)
def test_port_json_reads_into_jax_unchanged(case):
    d = json.loads(json.dumps(tcfg.config_to_dict(*_port_case(case))))
    cfg, tc = jcfg.config_from_dict(d)
    assert jcfg.config_to_dict(cfg, tc) == d
    # The port builds the same configs as the reference, field for field.
    assert d == json.loads(json.dumps(jcfg.config_to_dict(*_jax_case(case))))


def test_dtypes_are_names_and_unknown_ones_raise():
    assert tcfg.TrainConfig(compute_dtype=torch.bfloat16).compute_dtype == "bfloat16"
    assert tcfg.baseline_config(5)[1].compute_dtype == "bfloat16"
    with pytest.raises(ValueError, match="compute dtype"):
        tcfg.TrainConfig(compute_dtype="float16")


@pytest.mark.parametrize("name", sorted(jcfg.TRANSFER_FNS))
def test_transfer_fns_match_jax(name):
    assert sorted(tcfg.TRANSFER_FNS) == sorted(jcfg.TRANSFER_FNS)
    a = np.random.default_rng(0).normal(scale=8.0, size=(64,)).astype(np.float32)
    want = np.asarray(jcfg.TRANSFER_FNS[name](jnp.asarray(a)))
    got = tcfg.TRANSFER_FNS[name](torch.from_numpy(a)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_validation_matches_jax():
    bad = dict(n_input=8, n_z=2, n_hidden_recog_1=4, n_hidden_recog_3=4,
               n_hidden_gener_1=4)
    for c in (jcfg, tcfg):
        with pytest.raises(ValueError, match="contiguous"):
            c.validate_arch(bad)
        cfg = c.baseline_config(3)[0]
        assert cfg.modality_index("trajectory") == 1
        with pytest.raises(KeyError):
            cfg.modality_index(-1)


def test_port_never_imports_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import vae_assoc_tpu_torch as p\n"
        "mods = [m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "assert len(mods) >= 45, mods\n"
        "for need in ('ops.losses', 'ops.sampling', 'ops.resample', 'ops.rasterize',\n"
        "             'kernels.megakernel', 'kernels.sampling', 'kernels.loss',\n"
        "             'train.step', 'train.loop', 'data.pipeline', 'data.synthetic',\n"
        "             'models.conv', 'kernels.conv', 'kernels.conv_mega',\n"
        "             'api', 'evaluate', 'train.eval', 'utils.logging',\n"
        "             'native', 'data.uji', 'data.stream', 'ops.rbf', 'ops.augment',\n"
        "             'utils.viz'):\n"
        "    assert 'vae_assoc_tpu_torch.' + need in mods, need\n"
        "bad = sorted(k for k in sys.modules if k in ('jax', 'vae_assoc_tpu') or k.startswith(('jax.', 'vae_assoc_tpu.')))\n"
        "assert not bad, bad\n"
        "assert 'matplotlib' not in sys.modules  # viz imports it only to plot\n"
        "print(len(mods))\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_import_makes_cudnn_deterministic():
    """cuDNN's convolution backward may add with atomics; the port turns
    deterministic algorithms on at import, with benchmark left off."""
    code = ("import torch, vae_assoc_tpu_torch\n"
            "b = torch.backends\n"
            "print(b.cudnn.deterministic, b.cudnn.benchmark, b.cudnn.allow_tf32,"
            " b.cuda.matmul.allow_tf32)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         env=dict(os.environ, PYTHONPATH=REPO), capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["True", "False", "False", "False"]
