"""The dense formulation of the conv tower's stride-2 convs
(vae_assoc_tpu_torch/kernels/conv_dense.py) against the JAX package's
(vae_assoc_tpu/kernels/conv_dense.py) and against the port's plain convs
(models/conv.py), values and gradients, at config 4's four layer shapes:
the edge layers the formulation is for (conv1, cin = 1; convt2,
cout = 1) and the middle ones."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vae_assoc_tpu.kernels import conv_dense as jdense
from vae_assoc_tpu_torch.kernels import conv_dense as tdense
from vae_assoc_tpu_torch.models import conv as tconv

CASES = {
    "conv1": ((5, 28, 28, 1), (3, 3, 1, 32), "conv3x3_s2_dense", tconv.conv3x3_s2),
    "conv2": ((5, 14, 14, 32), (3, 3, 32, 64), "conv3x3_s2_dense", tconv.conv3x3_s2),
    "convt1": ((5, 7, 7, 64), (3, 3, 64, 32), "convt3x3_s2_dense", tconv.convt3x3_s2),
    "convt2": ((5, 14, 14, 32), (3, 3, 32, 1), "convt3x3_s2_dense", tconv.convt3x3_s2),
}


def _inputs(case):
    xs, ws, _, _ = CASES[case]
    rng = np.random.default_rng(sorted(CASES).index(case))
    return (rng.normal(size=xs).astype(np.float32),
            (rng.normal(size=ws) * 0.1).astype(np.float32),
            (rng.normal(size=ws[3]) * 0.1).astype(np.float32))


def _torch_value_and_grads(fn, x, w, b, **kw):
    x, w, b = (torch.tensor(a, requires_grad=True) for a in (x, w, b))
    y = fn(x, w, b, **kw)
    torch.sum(torch.sin(y)).backward()
    return y.detach().numpy(), [t.grad.numpy() for t in (x, w, b)]


@pytest.mark.parametrize("case", sorted(CASES))
def test_dense_conv_matches_jax(case):
    x, w, b = _inputs(case)
    name = CASES[case][2]
    jfn = getattr(jdense, name)
    want = np.asarray(jfn(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b)))
    jgrads = jax.grad(lambda x, w, b: jnp.sum(jnp.sin(jfn(x, w, b))), argnums=(0, 1, 2))(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    got, grads = _torch_value_and_grads(getattr(tdense, name), x, w, b)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    for g, jg in zip(grads, jgrads):
        np.testing.assert_allclose(g, np.asarray(jg), rtol=1e-4, atol=5e-5)


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_dense_conv_matches_the_plain_conv(case, compute_dtype):
    x, w, b = _inputs(case)
    _, _, name, plain = CASES[case]
    got, grads = _torch_value_and_grads(getattr(tdense, name), x, w, b,
                                        compute_dtype=compute_dtype)
    want, wgrads = _torch_value_and_grads(plain, x, w, b, compute_dtype=compute_dtype)
    tol = 1e-5 if compute_dtype == "float32" else 1e-3
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)
    if compute_dtype == "float32":
        # In bf16 each formulation rounds its own operands' cotangents to
        # bf16 (autograd through the policy's rounding), so only fp32
        # gradients are comparable.
        for g, wg in zip(grads, wgrads):
            np.testing.assert_allclose(g, wg, rtol=1e-4, atol=5e-5)


def test_selectors_hold_one_tap_per_pixel_pair():
    """Each (input, output) pixel pair has at most one tap, so the dense
    matrix holds copies of the weights; the port's selectors are JAX's."""
    for ours, theirs, shape in ((tdense._sel_s2, jdense._sel_s2, (28, 28)),
                                (tdense._sel_t2, jdense._sel_t2, (14, 14))):
        s = ours(*shape)
        np.testing.assert_array_equal(s, theirs(*shape))
        assert s.sum(axis=0).max() == 1.0


def test_odd_input_raises_as_in_jax():
    x = torch.zeros(2, 7, 7, 1)
    w = torch.zeros(3, 3, 1, 4)
    with pytest.raises(ValueError, match="even dims"):
        tdense.conv3x3_s2_dense(x, w, torch.zeros(4))
    with pytest.raises(ValueError, match="even dims"):
        jdense.conv3x3_s2_dense(jnp.zeros((2, 7, 7, 1)), jnp.zeros((3, 3, 1, 4)), jnp.zeros(4))
