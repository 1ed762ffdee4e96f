"""The port's graded entry points (vae_assoc_tpu_torch/graft_entry.py)
against the JAX package's ``__graft_entry__.py``: ``entry()``'s joint
forward and loss on the JAX model's weights with JAX's ε injected, and
``dryrun_multichip`` running every leg on 4 gloo ranks on the CPU."""

import jax
import numpy as np
import pytest
import torch

import __graft_entry__ as jentry
from vae_assoc_tpu_torch import convert
from vae_assoc_tpu_torch import graft_entry as tentry
from vae_assoc_tpu_torch.configs import baseline_config


def test_entry_matches_jax_on_its_weights_and_eps():
    jfn, (jparams, jx_img, jx_traj, key) = jentry.entry()
    fn, (params, x_img, x_traj, seed) = tentry.entry(device="cpu")
    assert (tuple(x_img.shape), tuple(x_traj.shape), seed) == (jx_img.shape, jx_traj.shape, 0)
    rng = np.random.default_rng(0)
    img = rng.uniform(0, 1, jx_img.shape).astype(np.float32)
    traj = rng.normal(size=jx_traj.shape).astype(np.float32)
    want_total, want = jfn(jparams, img, traj, key)
    # The ε JAX's loss draws from its key (assoc_forward splits it per
    # modality, each a standard normal of the latent's shape).
    eps = [torch.from_numpy(np.array(jax.random.normal(k, (64, 20))))
           for k in jax.random.split(key, 2)]
    ported = convert.from_jax_numpy(jax.tree.map(np.asarray, jparams), baseline_config(3)[0],
                                    "cpu")
    total, got = fn(ported, torch.from_numpy(img), torch.from_numpy(traj), seed, eps=eps)
    np.testing.assert_allclose(float(total.detach()), float(want_total), rtol=1e-5)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5, atol=1e-6)
    # Its own weights and seed run too.
    total, _ = fn(params, x_img, x_traj, seed)
    assert torch.isfinite(total)


def test_dryrun_runs_every_leg_on_four_ranks():
    assert tentry.dryrun_multichip(4, device_type="cpu", timeout_s=240) == list(tentry.LEGS)


@pytest.mark.parametrize("n", [2, 3, 5])
def test_dryrun_needs_an_even_n_of_at_least_4(n):
    with pytest.raises(ValueError, match="even n >= 4"):
        tentry.dryrun_multichip(n, device_type="cpu")
