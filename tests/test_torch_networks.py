"""The port's towers against the JAX package's: weights carried across by
convert.py, Xavier init bounds, and the plain encoder/decoder math at
small widths and at the full config-3 widths."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vae_assoc_tpu import configs as jcfg
from vae_assoc_tpu.models import assoc as jassoc
from vae_assoc_tpu.models import networks as jnet
from vae_assoc_tpu_torch import configs as tcfg
from vae_assoc_tpu_torch import convert
from vae_assoc_tpu_torch.models import assoc as tassoc
from vae_assoc_tpu_torch.models import networks as tnet


def _arch(depth, n_in=24, n_z=4, hidden=16):
    return dict(n_input=n_in, n_z=n_z, **{
        f"n_hidden_{net}_{k}": hidden + 2 * k
        for net in ("recog", "gener") for k in range(1, depth + 1)
    })


def _cfgs(depth, n_cond=0):
    """The same two-modality config in both packages."""
    out = []
    for c in (jcfg, tcfg):
        out.append(c.AssocConfig([
            c.ModalityConfig("image", _arch(depth), recon="bernoulli", n_cond=n_cond),
            c.ModalityConfig("trajectory", _arch(depth, n_in=10), recon="gaussian",
                             n_cond=n_cond),
        ]))
    return out


def _jax_tree(jc, seed=0):
    params = jassoc.init_assoc(jax.random.PRNGKey(seed), jc)
    return jax.tree.map(np.asarray, params)


def _jax_flat(tree):
    return {jax.tree_util.keystr(p, simple=True, separator="."): v
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("depth,n_cond", [(1, 0), (2, 3), (3, 0)])
def test_convert_round_trips_bitwise(depth, n_cond):
    jc, tc = _cfgs(depth, n_cond)
    tree = _jax_tree(jc)
    model = convert.from_jax_numpy(tree, tc, "cpu")
    # state_dict keys are the JAX tree paths joined with dots.
    want = _jax_flat(tree)
    assert sorted(model.state_dict()) == sorted(want)
    back = convert.to_numpy(model)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    got = _jax_flat(back)
    for k, v in want.items():
        assert got[k].dtype == v.dtype and got[k].shape == v.shape, k
        assert np.array_equal(got[k], v), k


def test_convert_rejects_mismatched_tree():
    jc, tc = _cfgs(2)
    tree = _jax_tree(jc)
    wrong = _cfgs(3)[1]
    with pytest.raises(RuntimeError):
        convert.from_jax_numpy(tree, wrong, "cpu")


def test_xavier_init_bounds_and_zero_biases():
    _, tc = _cfgs(2, n_cond=3)
    model = tassoc.init_assoc(0, tc, device="cpu")
    for name, p in model.state_dict().items():
        if name.endswith(".b"):
            assert torch.count_nonzero(p) == 0, name
            continue
        n_in, n_out = p.shape
        a = np.sqrt(6.0 / (n_in + n_out))
        assert float(p.abs().max()) <= a, name
        assert float(p.abs().max()) > 0.5 * a, name  # the draws span the range
    again = tassoc.init_assoc(0, tc, device="cpu")
    other = tassoc.init_assoc(1, tc, device="cpu")
    w = "modalities.0.recog.h1.w"
    assert torch.equal(model.state_dict()[w], again.state_dict()[w])
    assert not torch.equal(model.state_dict()[w], other.state_dict()[w])


def test_hidden_layers_numeric_order():
    arch = _arch(11)
    m = tnet.init_mlp_vae_params(torch.Generator().manual_seed(0), arch, device="cpu")
    widths = [l.w.shape[1] for l in tnet.hidden_layers(m.recog)]
    assert widths == [16 + 2 * k for k in range(1, 12)]


@torch.no_grad()
def _compare_plain(jc, tc, batch, tol, seed=0):
    tree = _jax_tree(jc, seed)
    model = convert.from_jax_numpy(tree, tc, "cpu")
    rng = np.random.default_rng(seed)
    for i, m in enumerate(tc.modalities):
        jp = jax.tree.map(jnp.asarray, tree["modalities"][i])
        x = rng.uniform(0, 1, (batch, m.arch["n_input"])).astype(np.float32)
        z = rng.normal(size=(batch, m.arch["n_z"])).astype(np.float32)
        j_mu, j_lv = jnet.encode_mlp(jp, jnp.asarray(x))
        t_mu, t_lv = tnet.encode_mlp(model.modalities[i], torch.from_numpy(x))
        np.testing.assert_allclose(t_mu.numpy(), np.asarray(j_mu), rtol=tol, atol=tol)
        np.testing.assert_allclose(t_lv.numpy(), np.asarray(j_lv), rtol=tol, atol=tol)
        j_out = jnet.decode_mlp(jp, jnp.asarray(z))
        t_out = tnet.decode_mlp(model.modalities[i], torch.from_numpy(z))
        np.testing.assert_allclose(t_out.numpy(), np.asarray(j_out), rtol=tol, atol=tol)


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_plain_towers_match_jax(depth):
    # fp32 on both sides; only the summation order may differ.
    _compare_plain(*_cfgs(depth), batch=9, tol=1e-5)


def test_plain_towers_match_jax_at_config3_widths():
    # Full widths (K up to 784): summation-order error grows with K.
    jc, _ = jcfg.baseline_config(3)
    tc, _ = tcfg.baseline_config(3)
    _compare_plain(jc, tc, batch=16, tol=1e-4)


def test_bf16_policy_rounds_operands_and_accumulates_in_fp32():
    g = torch.Generator().manual_seed(0)
    layer = tnet.Linear(300, 7, device="cpu", generator=g)
    x = torch.rand(5, 300, generator=g)
    got = tnet.linear(layer, x, "bfloat16")
    want = (x.double().bfloat16().double() @ layer.w.detach().bfloat16().double()).float()
    np.testing.assert_allclose(got.detach().numpy(), want.numpy(), rtol=1e-6, atol=1e-6)
    assert got.dtype == torch.float32
