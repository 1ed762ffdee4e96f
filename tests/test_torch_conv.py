"""The port's conv image tower (models/conv.py) and its conv primitive
(kernels/conv.py) against the JAX package, and serving a conv_pallas model.

Inputs come from a numpy seed and go to both packages. The JAX side runs
its Pallas kernels in interpret mode (kernels/conv.py's im2col kernels and
kernels/conv_banded.py's banded ones), the port its plain twins. The conv
channels are fixed by the geometry (28×28, 32 and 64 channels); the dense
widths are cut to 40-48. Tolerances: fp32 values rtol 1e-5, atol 1e-4;
gradients summed over the batch atol 1e-5 × max|want|; bf16 against the
JAX Pallas path, which rounds the operands as the port does, 2e-2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vae_assoc_tpu import configs as jcfg
from vae_assoc_tpu import serve as jserve
from vae_assoc_tpu.kernels import conv as jkc
from vae_assoc_tpu.kernels import conv_banded as jkb
from vae_assoc_tpu.models import assoc as jassoc
from vae_assoc_tpu.models import conv as jconv
from vae_assoc_tpu_torch import configs as tcfg
from vae_assoc_tpu_torch import convert
from vae_assoc_tpu_torch import serve as tserve
from vae_assoc_tpu_torch.kernels import _launches
from vae_assoc_tpu_torch.kernels import conv as tkc
from vae_assoc_tpu_torch.models import assoc as tassoc
from vae_assoc_tpu_torch.models import conv as tconv

ARCH = dict(n_input=784, n_z=8, n_hidden_recog_1=48, n_hidden_recog_2=48,
            n_hidden_gener_1=40, n_hidden_gener_2=48)
TRAJ = dict(n_input=24, n_z=8, n_hidden_recog_1=16, n_hidden_recog_2=16,
            n_hidden_gener_1=16, n_hidden_gener_2=16)
RTOL, ATOL = 1e-5, 1e-4
BF16 = 2e-2

# name: (cin, input size, cout, kind) of the tower's four conv layers.
LAYERS = {"conv1": (1, 28, 32, "conv"), "conv2": (32, 14, 64, "conv"),
          "convt1": (64, 7, 32, "convt"), "convt2": (32, 14, 1, "convt")}
# kind: (stride, dilate, pads, output size for an input size)
GEOM = {"conv": (2, False, (0, 1), lambda h: h // 2),
        "convt": (1, True, (2, 1), lambda h: 2 * h)}


def _np(seed, *shape, lo=-1.0):
    return np.random.default_rng(seed).uniform(lo, 1.0, shape).astype(np.float32)


def _layer(name, batch=3, seed=0):
    """(x [B, h, h, cin], w [3, 3, cin, cout], b [cout], dy, geometry)."""
    cin, h, cout, kind = LAYERS[name]
    stride, dilate, pads, out = GEOM[kind]
    oh = out(h)
    return (_np(seed, batch, h, h, cin), 0.3 * _np(seed + 1, 3, 3, cin, cout),
            0.1 * _np(seed + 2, cout), _np(seed + 3, batch, oh, oh, cout),
            (stride, dilate, pads, oh))


def _jax_conv_vae(seed=0):
    jp = jconv.init_conv_vae_params(jax.random.PRNGKey(seed), ARCH)
    cfg = tcfg.AssocConfig([tcfg.ModalityConfig("image", ARCH, encoder="conv")])
    tp = convert.from_jax_numpy({"modalities": (jax.tree.map(np.asarray, jp),)}, cfg, "cpu")
    return jp, tp.modalities[0]


def _close(got, want, rtol=RTOL, atol=ATOL, err_msg=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (err_msg, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol, err_msg=err_msg)


def _close_summed(got, want, tol=RTOL, err_msg=""):
    """A gradient summed over the batch: atol = tol × max|want|."""
    want = np.asarray(want)
    _close(got, want, rtol=tol, atol=tol * max(float(np.abs(want).max()), 1e-30),
           err_msg=err_msg)


# --- model and weights ---------------------------------------------------------


def test_state_dict_is_the_jax_tree():
    jp = jconv.init_conv_vae_params(jax.random.PRNGKey(0), ARCH)
    want = {k: np.asarray(v).shape for k, v in convert._flatten(jp)}
    got = {k: tuple(v.shape) for k, v in tconv.ConvVAE(ARCH, device="cpu").state_dict().items()}
    assert got == want
    assert got["recog.conv1.w"] == (3, 3, 1, 32) and got["gener.convt2.w"] == (3, 3, 32, 1)
    assert got["recog.dense.w"] == (3136, 48) and got["gener.dense2.w"] == (40, 3136)


def test_config4_tree_converts_both_ways_bitwise():
    jc, _ = jcfg.baseline_config(4)
    tc_, _ = tcfg.baseline_config(4)
    tree = jax.tree.map(np.asarray, jassoc.init_assoc(jax.random.PRNGKey(3), jc))
    model = convert.from_jax_numpy(tree, tc_, "cpu")
    assert isinstance(model.modalities[0], tconv.ConvVAE)
    assert model.modalities[0].recog["dense"].w.shape == (3136, 500)
    back = dict(convert._flatten(convert.to_numpy(model)))
    want = dict(convert._flatten(tree))
    assert set(back) == set(want)
    for k in want:
        np.testing.assert_array_equal(back[k], want[k], err_msg=k)


def test_init_bounds_and_determinism():
    cfg, _ = tcfg.baseline_config(4)
    a = tassoc.init_assoc(0, cfg, device="cpu").modalities[0]
    b = tassoc.init_assoc(0, cfg, device="cpu").modalities[0]
    for net, name, cin, cout in (("recog", "conv1", 1, 32), ("recog", "conv2", 32, 64),
                                 ("gener", "convt1", 64, 32), ("gener", "convt2", 32, 1)):
        layer = getattr(a, net)[name]
        bound = np.sqrt(6.0 / (9 * cin + 9 * cout))
        w = layer.w.detach().numpy()
        assert np.abs(w).max() <= bound and np.abs(w).max() > 0.8 * bound, name
        assert not layer.b.detach().any()
        assert torch.equal(layer.w, getattr(b, net)[name].w)
    with pytest.raises(ValueError, match="n_input=784"):
        tconv.ConvVAE(dict(ARCH, n_input=100), device="cpu")
    with pytest.raises(ValueError, match="condition"):
        tconv.init_conv_vae_params(None, ARCH, device="cpu", n_cond=3)


# --- the plain tower -------------------------------------------------------------


@pytest.mark.parametrize("batch", [1, 16])
@torch.no_grad()
def test_plain_tower_matches_jax(batch):
    jp, tp = _jax_conv_vae()
    x = _np(batch, batch, 784, lo=0.0)
    z = np.random.default_rng(batch).normal(size=(batch, 8)).astype(np.float32)
    jmu, jlv = jconv.encode_conv(jp, jnp.asarray(x))
    mu, lv = tconv.encode_conv(tp, torch.from_numpy(x))
    _close(mu, jmu, err_msg="mu")
    _close(lv, jlv, err_msg="lv")
    _close(tconv.decode_conv(tp, torch.from_numpy(z)), jconv.decode_conv(jp, jnp.asarray(z)),
           err_msg="logits")


@pytest.mark.parametrize("name", sorted(LAYERS))
@torch.no_grad()
def test_plain_layer_ops_are_the_lax_convs(name):
    # conv3x3_s2 is lax's SAME stride-2 conv (pads (0, 1)), convt3x3_s2
    # lax.conv_transpose (kernel not flipped).
    x, w, b, _, _ = _layer(name)
    kind = LAYERS[name][3]
    if kind == "conv":
        want = jax.lax.conv_general_dilated(
            jnp.asarray(x), jnp.asarray(w), (2, 2), "SAME", dimension_numbers=jconv._DN,
            precision=jax.lax.Precision.HIGHEST) + b
        got = tconv.conv3x3_s2(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b))
    else:
        want = jax.lax.conv_transpose(
            jnp.asarray(x), jnp.asarray(w), (2, 2), "SAME", dimension_numbers=jconv._DN,
            precision=jax.lax.Precision.HIGHEST) + b
        got = tconv.convt3x3_s2(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b))
    _close(got, want, err_msg=name)


# --- the conv primitive ------------------------------------------------------------

PRIM_CASES = ([(n, use, "float32") for n in sorted(LAYERS) for use in ("fwd", "dx")]
              + [("conv2", "fwd", "bfloat16"), ("convt1", "dx", "bfloat16")])


@pytest.mark.parametrize("name,use,cd", PRIM_CASES)
@torch.no_grad()
def test_im2col_twin_matches_pallas(name, use, cd):
    # The four uses of the primitive: the stride-2 conv and the transposed
    # conv forward (pads (0, 1) and (2, 1)), and their input gradients (the
    # flipped weight on a dilated dy padded (2, 2) clipped to the input
    # size, and a stride-2 conv of dy padded (0, 1)).
    x, w, _, dy, (stride, dilate, pads, oh) = _layer(name)
    cin, h, cout, _ = LAYERS[name]
    w2d = w.reshape(9 * cin, cout)
    if use == "fwd":
        args = (x, w2d, stride, dilate, pads, oh)
    else:
        mapped = tkc.DX_GEOMETRY[(stride, dilate, pads)]
        args = (dy, np.array(jkc._flip_w2d(jnp.asarray(w2d), cin, cout)), *mapped, h)
    want = jkc._conv_im2col(jnp.asarray(args[0]), jnp.asarray(args[1]), *args[2:], cd)
    got = tkc.conv_im2col_plain(torch.from_numpy(args[0]), torch.from_numpy(args[1]),
                                *args[2:], cd)
    tol = (RTOL, ATOL) if cd == "float32" else (BF16, BF16)
    _close(got, want, *tol, err_msg=f"{name} {use}")
    if use == "dx":
        got = tkc.conv_dx(torch.from_numpy(dy), torch.from_numpy(w2d), cin, stride, dilate,
                          pads, h, compute_dtype=cd)
        _close(got, want, *tol, err_msg=f"{name} conv_dx")


@pytest.mark.parametrize("name,cd", [(n, "float32") for n in sorted(LAYERS)]
                         + [("convt2", "bfloat16")])
@torch.no_grad()
def test_dw_twin_matches_pallas(name, cd):
    x, _, _, dy, geom = _layer(name)
    want = jkc._dw_impl(jnp.asarray(x), jnp.asarray(dy), *geom, cd)
    got = tkc.conv_dw(torch.from_numpy(x), torch.from_numpy(dy), *geom, compute_dtype=cd)
    assert got.shape == (9 * LAYERS[name][0], LAYERS[name][2])
    _close_summed(got, want, RTOL if cd == "float32" else BF16, err_msg=name)


PHASE_CASES = [(n, use, cd) for n in sorted(LAYERS) for use in ("fwd", "dx")
               for cd in ("float32", "bfloat16")]


def _use_args(name, use):
    """(x, w2d, stride, dilate, pads, out_hw) of the conv kernel in one use
    on a layer: the forward, or the input gradient (dy, the flipped weight,
    the mapped geometry), as numpy."""
    x, w, _, dy, (stride, dilate, pads, oh) = _layer(name)
    cin, h, cout, _ = LAYERS[name]
    w2d = w.reshape(9 * cin, cout)
    if use == "fwd":
        return x, w2d, stride, dilate, pads, oh
    mapped = tkc.DX_GEOMETRY[(stride, dilate, pads)]
    return (dy, np.array(jkc._flip_w2d(jnp.asarray(w2d), cin, cout)), *mapped, h)


@pytest.mark.parametrize("name,use,cd", PHASE_CASES)
@torch.no_grad()
def test_phase_plan_mirror_matches_pallas(name, use, cd):
    # The kernel's phase plan (parity classes over the undilated input) run
    # in torch against the reference's im2col kernel, in every use of every
    # layer. 1e-5 in both dtypes: only the order of the fp32 sums differs
    # (a bf16 × bf16 product is exact in fp32).
    args = _use_args(name, use)
    want = jkc._conv_im2col(jnp.asarray(args[0]), jnp.asarray(args[1]), *args[2:], cd)
    got = tkc.conv_phase_plain(torch.from_numpy(args[0]), torch.from_numpy(args[1]),
                               *args[2:], cd)
    _close(got, want, 1e-5, 1e-5, err_msg=f"{name} {use} {cd}")


@pytest.mark.parametrize("stride,dilate,pads,h,out_hw", [
    (2, False, (0, 1), 14, 7),   # the stride-2 conv: one class of 9 taps
    (1, True, (2, 1), 7, 14),    # the transposed conv: 4 classes, 9 taps in all
    (1, True, (2, 2), 7, 14),    # the conv's dx, clipped to the input size
    (1, True, (2, 1), 5, 9),     # odd output size: classes of unequal pixel counts
])
def test_phase_plan_covers_each_nonzero_tap_once(stride, dilate, pads, h, out_hw):
    lo, hi = pads
    size = 2 * h - 1 if dilate else h
    want = set()
    for oy in range(out_hw):
        for ox in range(out_hw):
            for ky in range(3):
                for kx in range(3):
                    py, px = stride * oy + ky - lo, stride * ox + kx - lo
                    if not (0 <= py < size and 0 <= px < size):
                        continue  # padding
                    if dilate and (py % 2 or px % 2):
                        continue  # a dilation zero
                    want.add((oy, ox, 3 * ky + kx))
    got = []
    for c in tkc.phase_plan(stride, dilate, lo, out_hw):
        assert c.ostep * (c.nqy - 1) + c.oy0 < out_hw and c.ostep * (c.nqx - 1) + c.ox0 < out_hw
        for qy in range(c.nqy):
            for qx in range(c.nqx):
                for wrow, dy, dx in c.taps:
                    iy, ix = c.istep * qy + dy, c.istep * qx + dx
                    if 0 <= iy < h and 0 <= ix < h:
                        got.append((c.oy0 + c.ostep * qy, c.ox0 + c.ostep * qx, wrow))
    assert len(got) == len(set(got)), "a (pixel, tap) product is computed twice"
    assert set(got) == want
    if dilate:  # 9 tap products per 4 output pixels, not 36
        assert sum(c.nqy * c.nqx * len(c.taps) for c in tkc.phase_plan(
            stride, dilate, lo, 2 * h)) == 9 * h * h


@pytest.mark.parametrize("name,use,cd", PHASE_CASES)
def test_fwd_tile_plan_fits_shared_memory(name, use, cd):
    x, w2d, stride, dilate, pads, oh = _use_args(name, use)
    cin, cout = x.shape[-1], w2d.shape[1]
    plan = tkc.phase_plan(stride, dilate, pads[0], oh)
    route, tile, smem = tkc.fwd_tile_plan(plan, cin, cout, cd)
    want = ("dot" if cout == 1 else "taps" if cin == 1
            else "mma" if cd == "bfloat16" else "ffma")
    assert (route, tile) == (want, {"dot": 128, "taps": 128, "mma": 128, "ffma": 256}[want])
    assert smem + tkc.PLAN_BYTES <= 232448
    assert len(plan) == (4 if dilate else 1)


def test_fwd_tile_plan_raises_past_shared_memory():
    plan = tkc.phase_plan(2, False, 0, 7)
    # fp32 keeps the weight, two 256-pixel slices and the pixel rows.
    assert tkc.fwd_tile_plan(plan, 64, 32, "float32")[2] == 4 * (576 * 32 + 2 * 256 * 36) + 4096
    assert tkc.fwd_tile_plan(plan, 64, 64, "bfloat16")[2] == 2 * (64 * 584 + 2 * 128 * 40) + 2048
    # A block keeps only its class's taps: at most 4 of a dilated conv's.
    dilated = tkc.phase_plan(1, True, 2, 14)
    assert tkc.fwd_tile_plan(dilated, 64, 32)[2] == 4 * (256 * 32 + 2 * 256 * 36) + 4096
    assert tkc.fwd_tile_plan(plan, 64, 64, "float32")[2] == 225280  # the widest fp32 fit
    with pytest.raises(ValueError, match="shared memory"):
        tkc.fwd_tile_plan(plan, 96, 64, "float32")


VJP_CASES = ([(n, mod, "float32") for n in sorted(LAYERS) for mod in ("im2col", "banded")]
             + [("conv2", "banded", "bfloat16"), ("convt2", "im2col", "bfloat16")])


@pytest.mark.parametrize("name,module,cd", VJP_CASES)
def test_layer_ops_and_vjp_match_jax(name, module, cd):
    # The port's conv3x3_s2 / convt3x3_s2 (one autograd Function on the
    # primitive) against jax.vjp of both JAX kernel modules: y, dx, dw, db.
    x, w, b, dy, _ = _layer(name, seed=5)
    jmod = jkc if module == "im2col" else jkb
    op = "conv3x3_s2" if LAYERS[name][3] == "conv" else "convt3x3_s2"
    jdt = jnp.dtype(cd)
    y, vjp = jax.vjp(lambda *a: getattr(jmod, op)(*a, compute_dtype=jdt),
                     jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    jdx, jdw, jdb = vjp(jnp.asarray(dy))
    tx, tw, tb = (torch.from_numpy(a).requires_grad_() for a in (x, w, b))
    got = getattr(tkc, op)(tx, tw, tb, compute_dtype=cd)
    (got * torch.from_numpy(dy)).sum().backward()
    tol = RTOL if cd == "float32" else BF16
    _close(got, y, tol, ATOL if cd == "float32" else BF16, err_msg="y")
    _close(tx.grad, jdx, tol, ATOL if cd == "float32" else BF16, err_msg="dx")
    _close_summed(tw.grad, jdw, tol, err_msg="dw")
    _close_summed(tb.grad, jdb, tol, err_msg="db")


def test_conv1_input_gradient_is_never_computed(monkeypatch):
    # The data needs no gradient, so the backward launches no dx for conv1.
    x, w, b, dy, _ = _layer("conv1")
    calls = []
    monkeypatch.setattr(tkc, "conv_dx", lambda *a, **k: calls.append(a))
    tw = torch.from_numpy(w).requires_grad_()
    (tkc.conv3x3_s2(torch.from_numpy(x), tw, torch.from_numpy(b)) * torch.from_numpy(dy)).sum().backward()
    assert not calls and tw.grad is not None


def test_odd_spatial_size_raises_in_both_packages():
    x = np.zeros((2, 7, 7, 32), np.float32)
    w = np.zeros((3, 3, 32, 64), np.float32)
    b = np.zeros(64, np.float32)
    with pytest.raises(ValueError, match="even spatial dims"):
        jkc.conv3x3_s2(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    with pytest.raises(ValueError, match="even spatial dims"):
        tkc.conv3x3_s2(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b))


@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
@torch.no_grad()
def test_kernel_tower_matches_banded_jax(cd):
    # encoder="conv_pallas" runs the banded kernels in the reference and
    # kernels/conv.py here: the same two functions.
    jp, tp = _jax_conv_vae(1)
    x = _np(7, 5, 784, lo=0.0)
    z = np.random.default_rng(7).normal(size=(5, 8)).astype(np.float32)
    jdt = jnp.dtype(cd)
    tol = (RTOL, ATOL) if cd == "float32" else (BF16, BF16)
    for g, w in zip(tkc.encode_conv_fused(tp, torch.from_numpy(x), compute_dtype=cd),
                    jkb.encode_conv_fused(jp, jnp.asarray(x), compute_dtype=jdt)):
        _close(g, w, *tol)
    _close(tkc.decode_conv_fused(tp, torch.from_numpy(z), compute_dtype=cd),
           jkb.decode_conv_fused(jp, jnp.asarray(z), compute_dtype=jdt), *tol)


@pytest.mark.parametrize("pixels,waves,want", [
    (1024 * 49, 2, (98, 512)),        # conv2 (and convt1) at batch 1024: chunks of 512
    (16384 * 196, 4, (526, 6112)),    # conv1 and convt2, thin: ≈ 4 waves of 132
    (16384 * 49, 2, (262, 3072)),     # conv2 and convt1 at 16384: ≈ 2 waves
    (7 * 49, 2, (1, 512)),            # too few pixels to split
])
def test_dw_plan(pixels, waves, want):
    chunks, per = tkc.dw_plan(pixels, n_sm=132, waves=waves)
    assert (chunks, per) == want
    assert per % tkc.DW_SLICE == 0 and per * chunks >= pixels > per * (chunks - 1)


DW_CASES = [(n, cd) for n in sorted(LAYERS) for cd in ("float32", "bfloat16")]


@pytest.mark.parametrize("name,cd", DW_CASES)
@torch.no_grad()
def test_dw_phase_mirror_matches_pallas(name, cd):
    # conv_dw's plan run in torch (per class and tap on conv2 and convt1,
    # per tap of the thin route on conv1 and convt2) against the
    # reference's _dw_kernel. 1e-5 of the largest value in both dtypes:
    # only the order of the fp32 sums differs (a bf16 × bf16 product is
    # exact in fp32).
    x, _, _, dy, geom = _layer(name)
    want = jkc._dw_impl(jnp.asarray(x), jnp.asarray(dy), *geom, cd)
    got = tkc.conv_dw_phase_plain(torch.from_numpy(x), torch.from_numpy(dy), *geom, cd)
    _close_summed(got, want, 1e-5, err_msg=f"{name} {cd}")


@pytest.mark.parametrize("name,cd", DW_CASES)
def test_dw_route_and_shared_memory(name, cd):
    x, _, _, dy, (stride, dilate, pads, oh) = _layer(name)
    cin, cout = x.shape[-1], dy.shape[-1]
    plan = tkc.phase_plan(stride, dilate, pads[0], oh)
    route = tkc.dw_route(plan, cin, cout, cd)
    assert route == ("thin" if 1 in (cin, cout) else "mma" if cd == "bfloat16" else "ffma")
    gathered = tkc.dw_gathered(plan)
    assert gathered == ("x" if LAYERS[name][3] == "conv" else "dy")
    smem = tkc.dw_smem(route, cout if gathered == "x" else cin)
    assert smem + 64 <= 232448 and (smem == 0) == (route == "thin")
    # The 9 taps, each weight row once: the conv reads x at 2q + k; the
    # transposed conv's input pixel p meets output 2p + 2 − k.
    taps = tkc.dw_taps(plan, gathered)
    want = [(3 * ky + kx, ky, kx) if gathered == "x" else (3 * ky + kx, 2 - ky, 2 - kx)
            for ky in range(3) for kx in range(3)]
    assert sorted(taps) == sorted(want)


def test_dw_route_raises_on_other_layers():
    conv = tkc.phase_plan(2, False, 0, 7)
    with pytest.raises(ValueError, match="weight-gradient kernel takes"):
        tkc.dw_route(conv, 16, 64)   # 16 gathered channels
    with pytest.raises(ValueError, match="weight-gradient kernel takes"):
        tkc.dw_route(conv, 32, 128)  # 128 direct channels
    with pytest.raises(ValueError, match="stride-2 conv and the"):
        tkc.dw_gathered(tkc.phase_plan(1, True, 2, 14)[:2])  # not every tap


def test_cpu_conv_path_launches_nothing():
    x, w, b, dy, geom = _layer("conv2")
    _launches.reset()
    tx = torch.from_numpy(x).requires_grad_()
    (tkc.conv3x3_s2(tx, torch.from_numpy(w).requires_grad_(), torch.from_numpy(b))
     * torch.from_numpy(dy)).sum().backward()
    assert _launches.snapshot() == {k: 0 for k in _launches.snapshot()}
    assert {"conv_fwd"} <= set(_launches.SERVING)
    assert {"conv_dw", "conv_enc", "conv_dec"} <= set(_launches.TRAINING)


def test_non_cpu_tensors_never_take_the_plain_path():
    x = torch.zeros(2, 14, 14, 32, device="meta")
    with pytest.raises(ValueError, match="runs on CUDA"):
        tkc.conv_fwd(x, torch.zeros(288, 64, device="meta"), 2, False, (0, 1), 7)
    with pytest.raises(ValueError, match="runs on CUDA"):
        tkc.conv_dw(x, torch.zeros(2, 7, 7, 64, device="meta"), 2, False, (0, 1), 7)


# --- serving -----------------------------------------------------------------------


def _serving_cfg(c):
    return c.AssocConfig([
        c.ModalityConfig("image", ARCH, recon="bernoulli", encoder="conv_pallas"),
        c.ModalityConfig("trajectory", TRAJ, recon="gaussian"),
    ])


@pytest.fixture(scope="module")
def predictors():
    """(JAX Predictor, port Predictor) on one conv_pallas model, both on
    their kernel paths."""
    jc = _serving_cfg(jcfg)
    params = jassoc.init_assoc(jax.random.PRNGKey(11), jc)
    jp = jserve.Predictor(params, jc, use_pallas=True)
    tp = tserve.Predictor(jax.tree.map(np.asarray, params), _serving_cfg(tcfg),
                          device="cpu", use_pallas=True)
    return jp, tp


@pytest.mark.parametrize("batch", [1, 5])
def test_predictor_verbs_match_jax(predictors, batch):
    jp, tp = predictors
    r = np.random.default_rng(batch)
    img = r.uniform(0, 1, (batch, 784)).astype(np.float32)
    traj = r.normal(size=(batch, 24)).astype(np.float32)
    z = r.normal(size=(batch, 8)).astype(np.float32)
    for g, w in zip(tp.transform([img, traj]), jp.transform([img, traj])):
        _close(g, w, err_msg="transform")
    for m in ("image", "trajectory"):
        _close(tp.generate(z, m), jp.generate(z, m), err_msg=f"generate {m}")
    got = tp.cross_generate(traj, "trajectory", "image")
    assert got.shape == (batch, 784) and got.min() >= 0 and got.max() <= 1
    _close(got, jp.cross_generate(traj, "trajectory", "image"), err_msg="traj->img")
    _close(tp.cross_generate(img, "image", "trajectory"),
           jp.cross_generate(img, "image", "trajectory"), err_msg="img->traj")
    _close(tp.reconstruct(img, "image"), jp.reconstruct(img, "image"), err_msg="reconstruct")


@pytest.mark.parametrize("encoder,use_pallas,loads", [
    ("conv_pallas", False, True), ("conv_pallas", True, True),
    ("conv", False, False), ("conv", True, True),
])
def test_warmup_builds_the_library_for_a_conv_pallas_model(monkeypatch, encoder, use_pallas,
                                                           loads):
    # A conv_pallas modality runs the conv kernels whatever use_pallas says,
    # so warmup builds the library for it too, off the request threads.
    from vae_assoc_tpu_torch.kernels import _build

    cfg = tcfg.AssocConfig([tcfg.ModalityConfig("image", ARCH, encoder=encoder),
                            tcfg.ModalityConfig("trajectory", TRAJ)])
    pred = tserve.Predictor(tassoc.AssocVAE(cfg, device="cpu"), cfg, device="cpu",
                            use_pallas=use_pallas)
    pred.device = torch.device("cuda")  # as a predictor on the card sees it
    calls = []
    monkeypatch.setattr(_build, "load", lambda: calls.append("load"))
    monkeypatch.setattr(tserve.bucketing, "warmup_endpoints", lambda *a, **k: calls.append("run"))
    pred.warmup()
    assert calls == (["load", "run"] if loads else ["run"])
