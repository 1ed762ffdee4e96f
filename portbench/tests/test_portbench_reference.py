"""The reference's own copies of what the program derives from the seed, and
its towers, against the program's plain path (which the port's own tests
hold against the JAX package)."""

from __future__ import annotations

import json

import pytest
import torch

from portbench import inputs
from portbench.reference import model as ref
from portbench.tests import tiny
from vae_assoc_tpu_torch.configs import config_from_dict
from vae_assoc_tpu_torch.models import assoc
from vae_assoc_tpu_torch.ops import sampling


def _config(name):
    return json.loads((tiny.REPO / "portbench" / "configs" / f"{name}.json").read_text())


@pytest.mark.parametrize("seed", [0, 2**31 + 5, 2**63 + 12345])
def test_seed_streams(seed):
    for data in (0, 1, 7, 2**20):
        assert ref.fold_in(seed, data) == sampling.fold_in(seed, data)
    assert torch.equal(ref.philox_normal(seed, 33, 20, "cpu"),
                       sampling.philox_normal(seed, 33, 20, "cpu"))


@pytest.mark.parametrize("config", ["assoc-mlp", "assoc-conv"])
def test_loss_and_cross_generate_match_the_plain_path(config):
    c = _config(config)
    model = c["model"]
    cfg, _ = config_from_dict(model)
    w = inputs.make_weights(model, 5, "cpu")
    net = assoc.AssocVAE(cfg, device="cpu")
    net.load_state_dict(w)
    xs = inputs.make_pairs(model, 8, 5, "cpu")
    eps = ref.step_eps(9, 0, 8, 20, 2, "cpu")
    want, _ = assoc.assoc_loss_fn(net, xs, cfg, eps=eps)
    got = ref.loss(w, model, xs, eps)
    assert float(got) == pytest.approx(float(want.detach()), rel=1e-6)
    with torch.no_grad():
        want = assoc.cross_generate(net, xs[0], cfg, 0, 1)
        got = ref.cross_generate(w, model, xs[0], 0, 1)
    assert torch.allclose(got, want, rtol=1e-5, atol=1e-6)


def test_precisions_round_as_named():
    t = torch.tensor([1.0 + 2**-12, 1.0 + 2**-10, 3.1415926, -0.1])
    assert torch.equal(ref.rnd(t, "fp32"), t)
    tf = ref.rnd(t, "tf32")
    assert tf[0] == 1.0 and tf[1] == 1.0 + 2**-10  # 10 bits of mantissa kept
    assert torch.all((tf - t).abs() <= t.abs() * 2**-11)
    f8 = ref.rnd(t, "fp8")
    assert torch.all((f8 - t).abs() <= t.abs().amax() * 2**-4)
    b16 = ref.rnd(t, "bf16")
    assert b16[0] == 1.0 and torch.all((b16 - t).abs() <= t.abs() * 2**-8)
