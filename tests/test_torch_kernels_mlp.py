"""The fused MLP kernels' wrappers (kernels/mlp.py) against the JAX package's
Pallas kernels, and the pieces of the CUDA route that run without a card.

On the CPU the port's wrappers run their plain twins; the JAX side runs
`vae_assoc_tpu.kernels.mlp` in Pallas interpret mode, as its own tests do.
The CUDA kernels themselves are compared with the same twins on the card by
chip_smoke.py.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vae_assoc_tpu.kernels import mlp as jmlp
from vae_assoc_tpu.models import networks as jnet
from vae_assoc_tpu_torch import configs as tcfg
from vae_assoc_tpu_torch import convert
from vae_assoc_tpu_torch.kernels import _build
from vae_assoc_tpu_torch.kernels import mlp as tmlp
from vae_assoc_tpu_torch.models import networks as tnet

# bf16: the two sides round the same operands, but an activation rounded to
# bf16 between layers can land on the other side of a rounding boundary.
TOL = {"float32": 1e-5, "bfloat16": 2e-2}

# (batch, depth, n_cond): every batch (300 is a ragged multi-tile batch),
# depth and n_cond at least twice, without the full product.
CASES = [(1, 1, 0), (1, 3, 3), (24, 2, 0), (24, 1, 3), (300, 3, 0), (300, 2, 3)]


def _arch(depth):
    return dict(n_input=24, n_z=4, **{
        f"n_hidden_{net}_{k}": 12 + 4 * k
        for net in ("recog", "gener") for k in range(1, depth + 1)
    })


def _pair(depth, n_cond, seed=0):
    """One modality's JAX params and the port's module with the same weights."""
    arch = _arch(depth)
    jp = jnet.init_mlp_vae_params(jax.random.PRNGKey(seed), arch, n_cond=n_cond)
    cfg = tcfg.AssocConfig([tcfg.ModalityConfig("m", arch, n_cond=n_cond)])
    model = convert.from_jax_numpy(
        {"modalities": (jax.tree.map(np.asarray, jp),)}, cfg, "cpu")
    return arch, jp, model.modalities[0]


@pytest.mark.parametrize("cd", sorted(TOL))
@pytest.mark.parametrize("batch,depth,n_cond", CASES)
@torch.no_grad()
def test_encode_fused_matches_pallas(batch, depth, n_cond, cd):
    arch, jp, tp = _pair(depth, n_cond)
    x = np.random.default_rng(batch).uniform(
        0, 1, (batch, arch["n_input"] + n_cond)).astype(np.float32)
    j_mu, j_lv = jmlp.encode_mlp_fused(jp, jnp.asarray(x), compute_dtype=jnp.dtype(cd))
    t_mu, t_lv = tmlp.encode_mlp_fused(tp, torch.from_numpy(x), compute_dtype=cd)
    for t, j in ((t_mu, j_mu), (t_lv, j_lv)):
        assert t.dtype == torch.float32 and t.shape == (batch, arch["n_z"])
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=TOL[cd], atol=TOL[cd])


@pytest.mark.parametrize("cd", sorted(TOL))
@pytest.mark.parametrize("batch,depth,n_cond", CASES)
@torch.no_grad()
def test_decode_fused_matches_pallas(batch, depth, n_cond, cd):
    arch, jp, tp = _pair(depth, n_cond)
    z = np.random.default_rng(batch).normal(
        size=(batch, arch["n_z"] + n_cond)).astype(np.float32)
    j_out = jmlp.decode_mlp_fused(jp, jnp.asarray(z), compute_dtype=jnp.dtype(cd))
    t_out = tmlp.decode_mlp_fused(tp, torch.from_numpy(z), compute_dtype=cd)
    assert t_out.dtype == torch.float32 and t_out.shape == (batch, arch["n_input"])
    np.testing.assert_allclose(t_out.numpy(), np.asarray(j_out), rtol=TOL[cd], atol=TOL[cd])


@torch.no_grad()
def test_cpu_path_launches_nothing():
    _, _, tp = _pair(2, 0)
    tmlp.reset_launches()
    tmlp.encode_mlp_fused(tp, torch.zeros(3, 24))
    tmlp.decode_mlp_fused(tp, torch.zeros(3, 4))
    assert tmlp.LAUNCHES == {"enc_fwd": 0, "dec_fwd": 0, "conv_fwd": 0}


def test_non_cpu_tensor_never_takes_the_plain_path():
    # A tensor that is not on the CPU launches the kernel or raises; a
    # meta tensor can do neither, so it must raise.
    m = tnet.MLPVAE(_arch(2), device="meta")
    with pytest.raises(ValueError, match="runs on CUDA"):
        tmlp.encode_mlp_fused(m, torch.zeros(3, 24, device="meta"))
    with pytest.raises(ValueError, match="runs on CUDA"):
        tmlp.decode_mlp_fused(m, torch.zeros(3, 4, device="meta"))


def test_nvcc_command_targets_sm90a_and_every_source():
    cmd = _build.nvcc_command("nvcc", "out.so")
    assert "arch=compute_90a,code=sm_90a" in cmd
    srcs = sorted(_build.CSRC.glob("*.cu"))
    assert srcs and [str(s) for s in srcs] == cmd[-len(srcs):]
    assert cmd[cmd.index("-o") + 1] == "out.so" and "-shared" in cmd


def test_missing_nvcc_raises(monkeypatch):
    import torch.utils.cpp_extension as ext

    monkeypatch.setattr(ext, "CUDA_HOME", None)
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.find_nvcc()


def _fwd_ring(rows, bf16):
    # csrc/mlp_fwd.cu's stack_fwd_smem: three stages, each a kd × 128 slice
    # of W as stored (rows of 132) and a rows × kd slice of the streamed A
    # (rows of kd + 4), kd = 32 at 64 rows and 64 below; bf16 also two
    # rounded slices (rows of 136 and kd + 8).
    kd = 32 if rows == 64 else 64
    return 4 * 3 * (kd * 132 + rows * (kd + 4)) + (
        2 * 2 * (kd * 136 + rows * (kd + 8)) if bf16 else 0)


ENC_WIDTHS, DEC_WIDTHS = (500, 500, 20, 20), (500, 500, 784)  # the image tower's products


@pytest.mark.parametrize("widths,batch,cd,rows,parts", [
    (ENC_WIDTHS, 16384, "float32", 64, 1), (ENC_WIDTHS, 16384, "bfloat16", 64, 1),
    (ENC_WIDTHS, 4225, "float32", 64, 1),     # past 32 rows × 132 SMs
    (ENC_WIDTHS, 4224, "bfloat16", 32, 1), (ENC_WIDTHS, 2113, "float32", 32, 1),
    (ENC_WIDTHS, 2112, "bfloat16", 16, 1),    # 132 tiles of 16 rows fill the SMs
    (ENC_WIDTHS, 1056, "float32", 16, 2),     # 66 tiles: two blocks share each
    (ENC_WIDTHS, 257, "bfloat16", 16, 2),     # 17 tiles: 4 blocks each would pass 66
    (ENC_WIDTHS, 256, "float32", 16, 4),      # 500 wide: 4 column tiles at most
    (ENC_WIDTHS, 1, "bfloat16", 16, 4),
    (DEC_WIDTHS, 128, "float32", 16, 8),      # 784 wide: 7 column tiles, 8 blocks
    (DEC_WIDTHS, 256, "bfloat16", 16, 4),     # 16 tiles of 8 blocks would pass 66
    (DEC_WIDTHS, 1, "float32", 16, 8),
])
def test_stack_fwd_plan(widths, batch, cd, rows, parts):
    # Rows from the batch, shared memory as the .cu computes it, and the
    # blocks that share a 16-row tile where SMs would idle.
    assert tmlp.stack_fwd_plan(widths, batch, 132, cd) == (
        rows, _fwd_ring(rows, cd == "bfloat16"), parts)
    assert _fwd_ring(rows, True) <= tmlp.SMEM_BYTES


def test_stack_fwd_plan_has_no_width_bound_and_raises_on_an_empty_batch():
    # A 29057-wide hidden layer made the old per-row plan raise at batch 64;
    # every operand now streams from device memory, so the width only caps
    # the blocks a tile (8). An empty batch raises.
    assert tmlp.stack_fwd_plan((29057, 20, 20), 64, 132) == (16, _fwd_ring(16, False), 8)
    with pytest.raises(ValueError, match="at least one row"):
        tmlp.stack_fwd_plan(ENC_WIDTHS, 0, 132)


def test_layer_table_rows_and_cache():
    _, _, tp = _pair(2, 0)
    layers = tnet.hidden_layers(tp.recog) + [tp.recog["out_mean"], tp.recog["out_logvar"]]
    table = tmlp._layer_table(layers, torch.device("cpu"))
    assert table.dtype == torch.int64 and table.shape == (4, 4)
    assert table[0].tolist() == [layers[0].w.data_ptr(), layers[0].b.data_ptr(), 24, 16]
    assert table[3, 2:].tolist() == [20, 4]
    assert tmlp._layer_table(layers, torch.device("cpu")) is table


def test_predictor_on_cuda_without_a_card_raises():
    from vae_assoc_tpu_torch.models.assoc import init_assoc
    from vae_assoc_tpu_torch.serve import Predictor

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = tcfg.AssocConfig([tcfg.ModalityConfig("m", _arch(1))])
    model = init_assoc(0, cfg, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Predictor(model, cfg, device="cuda", use_pallas=True)


def test_chip_smoke_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=repo,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and out.stdout == ""
    assert "no CUDA device" in out.stderr
