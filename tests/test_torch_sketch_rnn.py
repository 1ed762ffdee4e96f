"""Sketch-RNN as the trajectory tower (models/sketch_rnn.py) against its plain reference.

On the CPU, at a small size (batch 4, N_max 12, encoder 8 a direction,
decoder 16, 3 components, n_z 4) with seeded random weights and the same ε:
the joint loss and every leaf's gradient of the plain path and of the
kernel path's twins against ``tests/sketch_rnn_reference.py``; the weights
after three Adam steps through ``train_loop_fused`` (clipping by value,
both schedules); an encoder that ignores a row's padding; the schedules;
clipping by value; the greedy decode of image → sketch. One test shows that
bf16-rounded operands fail the tolerances, another that the benchmark's
copy of the reference (portbench/reference/sketch_rnn.py) gives the same
loss bit for bit.

On the card (the ``card`` marker; these skip without one): ``lstm_fwd``
and ``lstm_bwd`` against their twins at the cell's shapes, on a ragged
batch and in one step, twice to the same bits, one launch a layer;
``mixture_loss`` against its twin, and the replayed sketch step against the
eager one, bit for bit. This file imports no JAX:

    python -m pytest --noconftest -m card tests/test_torch_sketch_rnn.py
"""

import dataclasses

import numpy as np
import pytest
import torch

import sketch_rnn_reference as sref
from vae_assoc_tpu_torch import configs as tcfg
from vae_assoc_tpu_torch.kernels import _launches
from vae_assoc_tpu_torch.kernels import lstm as klstm
from vae_assoc_tpu_torch.kernels import mixture as kmix
from vae_assoc_tpu_torch.models import assoc as tassoc
from vae_assoc_tpu_torch.ops.sampling import fold_in, philox_normal
from vae_assoc_tpu_torch.train import loop as tloop
from vae_assoc_tpu_torch.train import step as tstep

N_MAX, BATCH = 12, 4
TRAIN = dict(learning_rate=1e-3, grad_clip_value=1.0, lr_schedule="exponential",
             lr_decay_rate=0.9999, min_learning_rate=1e-5, seed=7)
"""Sketch-RNN's training settings (sketch_rnn_train.py, get_default_hparams)."""
KL = dict(kl_weight=0.5, kl_weight_start=0.01, kl_decay_rate=0.99995)
"""Its KL weight's schedule, which the sketch modality holds."""

# Tolerances of the fp32 comparisons. The port and the reference compute the
# same equations in other orders: the cell's [x; h]·W as x·W_x + h·W_h, the
# means as other reductions. Through 12 recurrent steps that left 0 to 2e-7
# of the loss and 1.1e-7 to 1.6e-7 of the worst leaf's gradient (measured);
# bf16-rounded operands gave 4.5e-6 and 3.8e-3. Each bound sits between.
LOSS_TOL = 1e-6  # |loss − loss_ref| over |loss_ref|
GRAD_TOL = 1e-5  # ‖g − g_ref‖ over max(‖g_ref‖, the median leaf's), worst leaf
CHANGE_TOL = 1e-4  # the same of each weight's change after three Adam steps: Adam
# divides each element's step by its own gradient's size, so an element with a
# tiny gradient moves on round-off: the gap is larger than the gradient's.


def _cfg(enc=8, dec=16, m=3, nz=4, n_max=N_MAX, img=24, hidden=16, tolerance=0.01):
    """Sketch-RNN's tower at a small size; a KL floor below the published
    0.2, which the small tower's KL stays under, so that the KL term and its
    weight's schedule reach the gradients."""
    image = tcfg.ModalityConfig("image", dict(
        n_input=img, n_z=nz, n_hidden_recog_1=hidden, n_hidden_recog_2=hidden,
        n_hidden_gener_1=hidden, n_hidden_gener_2=hidden), recon="bernoulli")
    sketch = tcfg.ModalityConfig(
        "sketch", dict(n_input=5, n_z=nz, max_seq_len=n_max, enc_rnn_size=enc,
                       dec_rnn_size=dec, num_mixture=m),
        recon="mixture", encoder="sketch_rnn", kl_tolerance=tolerance, **KL)
    return tcfg.AssocConfig([image, sketch], assoc_lambda=1.0)


def _rows(n, n_max=N_MAX, seed=0, lens=None, device="cpu"):
    """Stroke-5 rows [n, n_max + 1, 5] of lengths ``lens`` (or seeded ones)."""
    g = torch.Generator().manual_seed(seed)
    if lens is None:
        lens = torch.randint(2, n_max + 1, (n,), generator=g)
    lens = torch.as_tensor(lens)
    pts = torch.zeros(n, n_max, 5)
    pts[..., :2] = torch.randn(n, n_max, 2, generator=g)
    lift = (torch.rand(n, n_max, generator=g) < 0.1).float()
    pts[..., 2], pts[..., 3] = 1.0 - lift, lift
    pts[torch.arange(n_max)[None, :] >= lens[:, None]] = torch.tensor(sref.PAD)
    start = torch.tensor(sref.START).expand(n, 1, 5)
    return torch.cat([start, pts], dim=1).to(device)


def _batch(cfg, n=BATCH, seed=0, device="cpu"):
    g = torch.Generator().manual_seed(seed + 100)
    img = torch.rand(n, cfg.modalities[0].arch["n_input"], generator=g)
    return [img.to(device), _rows(n, cfg.modalities[1].arch["max_seq_len"], seed, device=device)]


def _eps(seed, n, nz):
    return [philox_normal(fold_in(seed, k), n, nz, "cpu") for k in range(2)]


def _weights(cfg, seed=1):
    """Seeded weights with nonzero biases, so every parameter is exercised."""
    model = tassoc.init_assoc(seed, cfg, device="cpu")
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for n, p in model.named_parameters():
            if n.endswith(".b"):
                p.copy_(0.1 * torch.randn(p.shape, generator=g))
    return model


def _ref_params(model):
    return {n: p.detach().clone().requires_grad_(True) for n, p in model.named_parameters()}


def _gap(prog: dict, ref: dict) -> float:
    norms = {n: float(ref[n].double().norm()) for n in ref}
    median = float(np.median(list(norms.values())))
    return max(float((prog[n] - ref[n]).double().norm()) / max(norms[n], median, 1e-30)
               for n in ref)


def _port_loss_grads(cfg, model, xs, eps, tc, step=0):
    total, metrics = tassoc.assoc_loss_fn(model, xs, cfg, eps=eps,
                                          compute_dtype=tc.compute_dtype,
                                          use_pallas=tc.use_pallas)
    total, _ = tstep.apply_objective_weights(total, metrics, cfg, tc, step)
    names = [n for n, _ in model.named_parameters()]
    grads = torch.autograd.grad(total, list(model.parameters()))
    return float(total.detach()), dict(zip(names, grads))


def _ref_loss_grads(cfg, model, xs, eps, step=0):
    p = _ref_params(model)
    w = sref.kl_weight_at(*KL.values(), step)
    total = sref.loss(p, xs, eps, w, cfg.modalities[1].kl_tolerance, cfg.assoc_lambda)
    grads = torch.autograd.grad(total, list(p.values()))
    return float(total.detach()), dict(zip(p, grads))


# -- on the CPU -----------------------------------------------------------------


@pytest.mark.parametrize("use_pallas", [False, True])
def test_loss_and_every_gradient_match_the_reference(use_pallas):
    cfg = _cfg()
    tc = tcfg.TrainConfig(use_pallas=use_pallas, **TRAIN)
    model = _weights(cfg)
    xs, eps = _batch(cfg), _eps(3, BATCH, 4)
    for step in (0, 5000):
        loss, grads = _port_loss_grads(cfg, model, xs, eps, tc, step)
        want, ref_grads = _ref_loss_grads(cfg, model, xs, eps, step)
        assert abs(loss - want) <= LOSS_TOL * abs(want)
        assert _gap(grads, ref_grads) <= GRAD_TOL


def test_bf16_operands_fail_the_tolerances():
    cfg = _cfg()
    tc = tcfg.TrainConfig(use_pallas=True, compute_dtype="bfloat16", **TRAIN)
    model = _weights(cfg)
    xs, eps = _batch(cfg), _eps(3, BATCH, 4)
    loss, grads = _port_loss_grads(cfg, model, xs, eps, tc)
    want, ref_grads = _ref_loss_grads(cfg, model, xs, eps)
    assert abs(loss - want) > LOSS_TOL * abs(want)
    assert _gap(grads, ref_grads) > GRAD_TOL


def test_three_adam_steps_through_train_loop_fused_match_the_reference():
    cfg = _cfg()
    tc = tcfg.TrainConfig(batch_size=BATCH, use_pallas=True, **TRAIN)
    model = _weights(cfg)
    data = _batch(cfg, n=3 * BATCH, seed=4)
    blocks = [[d[k * BATCH:(k + 1) * BATCH] for d in data] for k in range(3)]
    w0 = {n: p.detach().clone() for n, p in model.named_parameters()}
    state = tstep.init_train_state(cfg, tc, device="cpu", params=model)
    losses = []
    for xs in blocks:
        state, hist = tloop.train_loop_fused(cfg, tc, xs, epochs=1, state=state)
        losses.append(hist[0]["total"])
    change = {n: p.detach() - w0[n] for n, p in state.params.named_parameters()}

    batches = []
    for k, xs in enumerate(blocks):
        g = torch.Generator().manual_seed(fold_in(tc.seed ^ 0x5EED, k) >> 1)
        perm = torch.randperm(BATCH, generator=g)
        batches.append([x[perm] for x in xs])

    def objective(p, step):
        w = sref.kl_weight_at(*KL.values(), step)
        return sref.loss(p, batches[step], _eps(fold_in(tc.seed, step), BATCH, 4), w,
                         cfg.modalities[1].kl_tolerance, 1.0)

    def lr_of(step):
        return sref.lr_at(1e-3, 1e-5, 0.9999, step)

    ref_losses, _, ref_change = sref.adam_steps(w0, objective, 3, lr_of=lr_of, clip=1.0)
    for a, b in zip(losses, ref_losses):
        assert abs(a - b) <= LOSS_TOL * abs(b)
    assert _gap(change, ref_change) <= CHANGE_TOL


@pytest.mark.parametrize("use_pallas", [False, True])
def test_the_encoder_ignores_a_rows_padding(use_pallas):
    cfg = _cfg()
    model = _weights(cfg)
    rows = _rows(4, lens=[3, 12, 7, 1])
    noisy = rows.clone()
    past = torch.arange(N_MAX + 1)[None, :] > torch.tensor([3, 12, 7, 1])[:, None]
    noisy[..., :4][past] = torch.randn(int(past.sum()), 4)  # p3 stays 1: L is unchanged
    mu = tassoc.transform(model, [torch.zeros(4, 24), rows], cfg, use_pallas=use_pallas)[1]
    assert torch.equal(mu, tassoc.transform(model, [torch.zeros(4, 24), noisy], cfg,
                                            use_pallas=use_pallas)[1])
    p = _ref_params(model)
    with torch.no_grad():
        want = sref.encode(p, "modalities.1", rows[:, 1:])[0]
    assert torch.allclose(mu, want, rtol=1e-5, atol=1e-6)
    alone = torch.cat([tassoc.transform(model, [torch.zeros(1, 24), rows[i:i + 1]], cfg,
                                        use_pallas=use_pallas)[1] for i in range(4)])
    assert torch.allclose(mu, alone, rtol=1e-5, atol=1e-6)


def test_schedules_at_steps_0_and_10000():
    cfg = _cfg()
    tc = tcfg.TrainConfig(**TRAIN)
    for step in (0, 10_000):
        lr = sref.lr_at(1e-3, 1e-5, 0.9999, step)
        w = sref.kl_weight_at(0.5, 0.01, 0.99995, step)
        assert tstep.lr_at(tc, step) == np.float32(lr)
        assert tstep.sketch_kl_weights(cfg, tc, step) == (np.float32(w),)
    assert tstep.lr_at(tc, 0) == np.float32(1e-3)
    assert tstep.sketch_kl_weights(cfg, tc, 0) == (np.float32(0.01),)
    # The step's values in device memory carry both schedules.
    state = tstep.TrainState(10_000, None, tstep.make_optimizer(tc).init([torch.zeros(1)]), 7)
    state.opt_state.adam.count = 10_000
    rows = torch.from_numpy(tstep.step_scalar_rows(state, cfg, tc, 2))
    sc = tstep.StepScalars.of_row(rows[0], 2, tstep.objective_width(cfg, tc))
    assert float(-sc.adam[0]) == float(tstep.lr_at(tc, 10_000))
    assert (float(sc.objective[3]),) == tstep.sketch_kl_weights(cfg, tc, 10_000)


def test_each_sketch_modality_keeps_its_own_kl_schedule():
    cfg = _cfg()
    second = dataclasses.replace(cfg.modalities[1], name="sketch2", kl_weight=0.25,
                                 kl_decay_rate=0.0)
    two = dataclasses.replace(cfg, modalities=[*cfg.modalities, second])
    tc = tcfg.TrainConfig(**TRAIN)
    assert tstep.sketch_kl_weights(two, tc, 10_000) == (
        np.float32(sref.kl_weight_at(*KL.values(), 10_000)), np.float32(0.25))
    assert tstep.objective_width(two, tc) == 5
    # A config without a sketch modality carries its three weights, or none.
    plain = tcfg.AssocConfig([cfg.modalities[0], dataclasses.replace(cfg.modalities[0],
                                                                     name="other")])
    assert tstep.objective_width(plain, tc) == 0
    assert tstep.objective_width(plain, tcfg.TrainConfig(kl_anneal_steps=10)) == 3


def test_clipping_by_value_clips_each_element_before_adam():
    tc = tcfg.TrainConfig(grad_clip_value=0.5)
    clipped = tcfg.TrainConfig()
    g = torch.Generator().manual_seed(0)
    p0 = [torch.randn(3, 4, generator=g), torch.randn(5, generator=g)]
    grads = [2.0 * torch.randn(t.shape, generator=g) for t in p0]
    assert any(bool((x.abs() > 0.5).any()) for x in grads)
    a, b = [t.clone() for t in p0], [t.clone() for t in p0]
    opt_a, opt_b = tstep.make_optimizer(tc), tstep.make_optimizer(clipped)
    sa, sb = opt_a.init(a), opt_b.init(b)
    opt_a.update(grads, sa, a)
    opt_b.update([x.clamp(-0.5, 0.5) for x in grads], sb, b)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert all(torch.equal(m, 0.1 * x.clamp(-0.5, 0.5)) for m, x in zip(sa.adam.mu, grads))


@pytest.mark.parametrize("use_pallas", [False, True])
def test_image_to_sketch_is_the_references_greedy_decode(use_pallas):
    cfg = _cfg()
    model = _weights(cfg)
    x = _batch(cfg, n=3)[0]
    out = tassoc.cross_generate(model, x, cfg, "image", "sketch", use_pallas=use_pallas)
    p = _ref_params(model)
    with torch.no_grad():
        mu = sref.image_terms(p, x, torch.zeros(3, 4))[0]
        want = sref.greedy_decode(p, "modalities.1", mu, N_MAX)
    assert out.shape == (3, N_MAX, 5)
    assert torch.equal(out[..., 2:], want[..., 2:])
    assert torch.allclose(out, want, rtol=1e-5, atol=1e-6)
    ended = out[..., 4] == 1
    assert torch.equal(ended, ended.cummax(1).values)  # padded after the end


def test_the_benchmarks_reference_gives_the_same_loss_bit_for_bit():
    from portbench.reference import sketch_rnn as bench

    cfg = _cfg()
    model = _weights(cfg)
    xs, eps = _batch(cfg), _eps(3, BATCH, 4)
    p = _ref_params(model)
    d = tcfg.config_to_dict(cfg)
    with torch.no_grad():
        a = sref.loss(p, xs, eps, 0.3, 0.01, 1.0)
        b = bench.loss(p, d, xs, eps, 0.3)
    assert torch.equal(a, b)
    assert [n for n, *_ in bench.param_spec(d)] == list(p)


def test_a_sketch_config_round_trips_and_keeps_its_own_fields():
    cfg = _cfg()
    tc = tcfg.TrainConfig(**TRAIN)
    d = tcfg.config_to_dict(cfg, tc)
    assert d["modalities"][1]["kl_tolerance"] == 0.01 and d["train"]["grad_clip_value"] == 1.0
    assert tcfg.config_from_dict(d) == (cfg, tc)
    plain = tcfg.config_to_dict(cfg, tcfg.TrainConfig())
    assert not set(tcfg.PORT_TRAIN_FIELDS) & set(plain["train"])
    assert d["modalities"][1]["kl_decay_rate"] == 0.99995
    assert "kl_tolerance" not in plain["modalities"][0]
    for field in tcfg.SKETCH_MODALITY_FIELDS:
        with pytest.raises(ValueError):
            dataclasses.replace(cfg.modalities[0], **{field: 0.2})
    with pytest.raises(ValueError):
        dataclasses.replace(cfg.modalities[1], kl_decay_rate=1.5)
    with pytest.raises(ValueError):
        dataclasses.replace(cfg.modalities[1], recon="gaussian")


# -- on the card ----------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the LSTM and mixture kernels run there")
    return torch.device("cuda")


def _directions(card, n_dirs, batch, steps, hidden, seed):
    g = torch.Generator(device=card).manual_seed(seed)
    out = []
    for _ in range(n_dirs):
        xp = torch.randn(steps, batch, 4 * hidden, generator=g, device=card) * 0.5
        w = torch.randn(hidden, 4 * hidden, generator=g, device=card) / hidden ** 0.5
        h0 = torch.randn(batch, hidden, generator=g, device=card) * 0.5
        c0 = torch.randn(batch, hidden, generator=g, device=card) * 0.5
        out.append((xp, w, h0, c0))
    return out


def _run(dirs, xrow, lengths, cd, on_cpu):
    """Forward states and the backward's gradients of one layer: the kernels,
    or (``on_cpu``) their twins on copies on the CPU."""
    dev = torch.device("cpu") if on_cpu else dirs[0][0].device
    ins = [tuple(t.to(dev).requires_grad_(True) for t in d) for d in dirs]
    xr = None if xrow is None else xrow.to(dev).requires_grad_(True)
    lens = None if lengths is None else lengths.to(dev)
    hs = klstm.lstm([d[0] for d in ins], [d[1] for d in ins], [d[2] for d in ins],
                    [d[3] for d in ins], xrow=xr, lengths=lens, compute_dtype=cd)
    g = torch.Generator().manual_seed(5)
    cts = [torch.randn(h.shape, generator=g).to(dev) for h in hs]
    leaves = [t for d in ins for t in d] + ([xr] if xr is not None else [])
    grads = torch.autograd.grad(sum((h * c).sum() for h, c in zip(hs, cts)), leaves)
    return [h.detach().cpu() for h in hs], [x.cpu() for x in grads]


LSTM_CASES = {
    # The cell's shapes: B 100, T 250, lengths 64..250 on the encoder.
    "cell": (100, 250, 256, 512, (64, 251)),
    # B 37 fills no row tile, H 48 no 64-unit tile of the backward, lengths
    # 0 and 1 hold a row's state from the first steps.
    "ragged": (37, 9, 32, 48, (0, 3)),
    # One step, as the greedy decode calls the forward.
    "one_step": (100, 1, 256, 512, (0, 2)),
}


def _lstm_case(card, case):
    """The encoder (two directions, lengths) and the decoder (one direction,
    a per-row addend) of a case, as (dirs, xrow, lengths) pairs."""
    batch, steps, enc, dec, (lo, hi) = LSTM_CASES[case]
    g = torch.Generator().manual_seed(0)
    lens = torch.randint(lo, hi, (batch,), generator=g).int()
    if case == "ragged":
        lens[:2] = torch.tensor([0, 1], dtype=torch.int32)
    xrow = torch.randn(batch, 4 * dec, generator=g) * 0.3
    return [(_directions(card, 2, batch, steps, enc, 1), None, lens.to(card)),
            (_directions(card, 1, batch, steps, dec, 2), xrow.to(card), None)]


@pytest.mark.card
@pytest.mark.parametrize("case", list(LSTM_CASES))
@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
def test_lstm_kernels_match_their_twins(cd, case, card):
    # fp32: the same products summed in another order, ~1e-6 after 24 steps.
    # bf16: an fp32 sum in another order can move one bf16 rounding of h,
    # which later steps carry: a few bf16 ulps (2^-8) of the largest value.
    tol = 1e-4 if cd == "float32" else 2e-2
    before = _launches.snapshot()
    planned = {"lstm_fwd": 0, "lstm_bwd": 0}
    for dirs, xrow, lengths in _lstm_case(card, case):
        got, ggot = _run(dirs, xrow, lengths, cd, on_cpu=False)
        want, gwant = _run(dirs, xrow, lengths, cd, on_cpu=True)
        for a, b in zip(got + ggot, want + gwant):
            assert (a - b).abs().max() <= tol * b.abs().max()
        _, batch, width = dirs[0][0].shape
        for kernel in planned:
            planned[kernel] += klstm.step_plan(kernel == "lstm_fwd", batch, width // 4,
                                               len(dirs), cd, card)["launches"]
    after = _launches.snapshot()
    assert {k: after[k] - before[k] for k in planned} == planned
    # One launch a layer each way on an H100, in both precisions (h0 and c0
    # need step −1 in that launch; fp32's decoder backward stages its
    # operand in four chunks to fit 48-row tiles).
    assert planned == {"lstm_fwd": 2, "lstm_bwd": 2}


@pytest.mark.card
@pytest.mark.parametrize("case", list(LSTM_CASES))
@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
def test_lstm_kernels_repeat_their_bits(cd, case, card):
    for dirs, xrow, lengths in _lstm_case(card, case):
        got, ggot = _run(dirs, xrow, lengths, cd, on_cpu=False)
        again, gagain = _run(dirs, xrow, lengths, cd, on_cpu=False)
        for a, b in zip(got + ggot, again + gagain):
            assert torch.equal(a, b)


@pytest.mark.card
@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
def test_the_cells_layers_take_one_launch_of_resident_blocks(cd, card):
    for fwd in (True, False):
        for n_dirs, hidden in ((2, 256), (1, 512)):
            plan = klstm.step_plan(fwd, 100, hidden, n_dirs, cd, card)
            groups = -(-plan["chunk"] // plan["rows"])
            assert plan["rows"] <= plan["tile_rows"] and groups * plan["per_group"] <= plan[
                "resident"] <= torch.cuda.get_device_properties(card).multi_processor_count
            assert plan["launches"] == -(-100 // plan["chunk"])
            assert plan["launches"] == 1 and plan["chunk"] == 100, plan
            assert plan["k_chunks"] == (4 if (cd, fwd, hidden) == ("float32", False, 512) else 2)


@pytest.mark.card
def test_mixture_kernel_matches_its_twin(card):
    g = torch.Generator().manual_seed(0)
    y = torch.randn(25_000, 123, generator=g) * 0.5
    tgt = _rows(100, n_max=250, seed=1)[:, 1:].reshape(-1, 5)
    tgt[:, :2] = torch.randn(25_000, 2, generator=g)
    loss, dy = kmix.mixture_loss_kernel(y.to(card), tgt.to(card))
    want, dwant = kmix.mixture_loss_plain(y, tgt)
    # One-ulp differences of exp, log and the sums' order, scaled by the
    # loss's 1/(s + 1e-6) where a row's mixture density is small.
    assert torch.allclose(loss.cpu(), want, rtol=1e-5, atol=1e-5)
    assert torch.allclose(dy.cpu(), dwant, rtol=1e-4, atol=1e-5)
    # The published formula (the reference's) gives the same loss.
    assert torch.allclose(want, sref.mixture_loss(y, tgt), rtol=1e-5, atol=1e-5)


def _card_cfg():
    return _cfg(enc=32, dec=64, m=4, nz=16, n_max=20, img=24, hidden=32)


@pytest.mark.card
@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
def test_replayed_sketch_step_is_the_eager_step_bit_for_bit(cd, card):
    cfg = _card_cfg()
    tc = tcfg.TrainConfig(batch_size=16, use_pallas=True, compute_dtype=cd, **TRAIN)
    data = [d.to(card) for d in _batch(cfg, n=16 * 3, seed=2)]
    graphed = tstep.init_train_state(cfg, tc, device=card)
    eager = tstep.init_train_state(cfg, tc, device=card)
    g0 = dict(tloop.GRAPH)
    l0 = _launches.snapshot()
    graphed, hist = tloop.train_loop_fused(cfg, tc, data, epochs=2, state=graphed)
    g1 = dict(tloop.GRAPH)
    l1 = _launches.snapshot()
    opt = tstep.make_optimizer(tc)
    gen = torch.Generator(device=card)
    gen.manual_seed(fold_in(tc.seed ^ 0x5EED, 0) >> 1)
    means = []
    for _ in range(2):
        perm = torch.randperm(48, generator=gen, device=card)
        rows = []
        for s in range(3):
            xs = [d[perm[s * 16:(s + 1) * 16]] for d in data]
            eager, m = tstep._one_step(eager, xs, cfg, tc, opt)
            rows.append(torch.stack(list(m.values())))
        means.append(torch.stack(rows).mean(0).cpu())
    l2 = _launches.snapshot()
    for p, q in zip(graphed.params.parameters(), eager.params.parameters()):
        assert torch.equal(p, q)
    for a, b in zip(graphed.opt_state.adam.mu + graphed.opt_state.adam.nu,
                    eager.opt_state.adam.mu + eager.opt_state.adam.nu):
        assert torch.equal(a, b)
    for e, h in enumerate(hist):
        for i, k in enumerate(m):
            assert h[k] == means[e][i].item(), (e, k)
    assert {k: g1[k] - g0[k] for k in g1} == {"captures": 1, "replays": 5, "eager_steps": 1}
    replayed = {k: l1[k] - l0[k] for k in l1}
    assert replayed == {k: l2[k] - l1[k] for k in l2}  # a replay counts its launches
    assert replayed["lstm_fwd"] == 6 * 2 and replayed["lstm_bwd"] == 6 * 2  # one a layer
    assert replayed["mixture_loss"] == 6


@pytest.mark.card
def test_image_to_sketch_on_the_card_runs_lstm_fwd_and_matches_the_twins(card):
    cfg = _card_cfg()
    model = _weights(cfg)
    x = _batch(cfg, n=8)[0]
    want = tassoc.cross_generate(model, x, cfg, "image", "sketch", use_pallas=True)
    before = _launches.snapshot()["lstm_fwd"]
    got = tassoc.cross_generate(model.to(card), x.to(card), cfg, "image", "sketch",
                                use_pallas=True).cpu()
    assert _launches.snapshot()["lstm_fwd"] - before == 20  # a one-step launch a point
    # fp32 kernels against their twins: the same argmax choices, offsets to
    # the sums' order.
    assert torch.equal(got[..., 2:], want[..., 2:])
    assert torch.allclose(got, want, rtol=1e-4, atol=1e-5)
