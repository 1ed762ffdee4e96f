"""The step's FLOP count against hand counts from the configurations' widths."""

from __future__ import annotations

import json

import pytest

from portbench import roofline
from portbench.tests import tiny


def _model(name):
    c = json.loads((tiny.REPO / "portbench" / "configs" / f"{name}.json").read_text())
    return c["model"]


def _mlp_macs(n_in, hidden, n_z):
    enc = n_in * hidden + hidden * hidden + 2 * hidden * n_z
    dec = n_z * hidden + hidden * hidden + hidden * n_in
    return enc + dec, n_in * hidden  # all products, the first (whose input is data)


def _conv_macs(c1=32, c2=64, hidden=500, n_z=20):
    conv1 = 14 * 14 * c1 * 9 * 1  # output pixels × channels × taps × input channels
    conv2 = 7 * 7 * c2 * 9 * c1
    dense = 7 * 7 * c2 * hidden
    convt1 = 7 * 7 * c2 * 9 * c1  # input pixels × taps × both channel counts
    convt2 = 14 * 14 * c1 * 9 * 1
    return conv1 + conv2 + dense + 2 * hidden * n_z + n_z * hidden + dense + convt1 + convt2, conv1


@pytest.mark.parametrize("batch", [1, 64, 16384])
def test_assoc_mlp(batch):
    img, img_first = _mlp_macs(784, 500, 20)
    traj, traj_first = _mlp_macs(200, 500, 20)
    per_sample = 6 * (img + traj) - 2 * (img_first + traj_first)  # no input gradient of the data
    assert per_sample == 11_280_000
    assert roofline.step_flops(_model("assoc-mlp"), batch) == batch * per_sample


@pytest.mark.parametrize("batch", [1, 2048])
def test_assoc_conv(batch):
    conv, conv_first = _conv_macs()
    traj, traj_first = _mlp_macs(200, 500, 20)
    per_sample = 6 * (conv + traj) - 2 * (conv_first + traj_first)
    assert per_sample == 34_578_496
    assert roofline.step_flops(_model("assoc-conv"), batch) == batch * per_sample


def test_step_bytes_and_least_time():
    m = _model("assoc-mlp")
    assert roofline.step_bytes(m, 16384) == 4 * 16384 * 984 + 24 * 2_049_064
    t = roofline.least_step_s(m, 16384, "bfloat16")
    assert t == pytest.approx(16384 * 11_280_000 / 989e12)
