"""The training step in device memory and in a CUDA graph (train/loop.py::train_loop_fused).

On the CPU: the step's per-step values as device tensors (train/step.py::
StepScalars) give the bits of the host values they replace: the ε seeds
(including seeds of 2**63 and more, held as int64), the Philox draw from a
tensor seed, Adam's scalars and the annealing weights, and a whole step.

On the card (the ``card`` marker; these skip without one): the step that
``train_loop_fused`` captures and replays gives the bits of the same steps
run eagerly from host values, the seeded kernels read a new seed on each
replay, and the ``train.graph`` counters and the launch counters count what
ran. This file imports no JAX, so the card tests run on a machine without it:

    python -m pytest --noconftest -m card tests/test_torch_graph.py
"""

import dataclasses
import gc

import numpy as np
import pytest
import torch

from vae_assoc_tpu_torch import configs as tcfg
from vae_assoc_tpu_torch.kernels import _launches
from vae_assoc_tpu_torch.kernels import megakernel as kmega
from vae_assoc_tpu_torch.kernels import sampling as ksamp
from vae_assoc_tpu_torch.models import assoc as tassoc
from vae_assoc_tpu_torch.ops.sampling import fold_in, philox_normal, seed_bits
from vae_assoc_tpu_torch.train import loop as tloop
from vae_assoc_tpu_torch.train import step as tstep

MASK64 = (1 << 64) - 1


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the step is captured in a CUDA graph there")
    return torch.device("cuda")


def _tiny(use_pallas=False, **train):
    arch = dict(n_z=4, n_hidden_recog_1=16, n_hidden_recog_2=16,
                n_hidden_gener_1=16, n_hidden_gener_2=16)
    cfg = tcfg.AssocConfig(
        [tcfg.ModalityConfig("image", dict(n_input=24, **arch), recon="bernoulli"),
         tcfg.ModalityConfig("trajectory", dict(n_input=12, **arch), recon="gaussian")],
        assoc_lambda=0.7)
    return cfg, tcfg.TrainConfig(batch_size=16, use_pallas=use_pallas, seed=3, **train)


SCHEDULE = dict(lr_schedule="cosine", warmup_steps=3, decay_steps=12, lr_end_factor=0.1,
                grad_clip_norm=0.05, ema_decay=0.9, kl_beta=0.5, kl_anneal_steps=5,
                assoc_warmup_steps=4)
"""Every per-step value at work: a cosine schedule after a warmup, clipping
that acts, an EMA and both annealing ramps."""


def _data(cfg, n, device, seed=0):
    g = torch.Generator().manual_seed(seed)
    out = []
    for m in cfg.modalities:
        x = torch.rand(n, m.arch["n_input"], generator=g)
        out.append(x if m.recon == "bernoulli" else 2 * x - 1)
    return [x.to(device) for x in out]


def _big_seed_state(cfg, tc, count=3):
    """A state at step 7 whose seed makes some modality seeds ≥ 2**63."""
    params = tassoc.init_assoc(0, cfg, device="cpu")
    opt_state = tstep.make_optimizer(tc).init(params.parameters())
    opt_state.adam.count = count
    return tstep.TrainState(7, params, opt_state, 2**64 - 12345)


# -- on the CPU -----------------------------------------------------------------


def test_step_scalar_rows_hold_seeds_past_2_63_as_int64():
    cfg, tc = _tiny(**SCHEDULE)
    state = _big_seed_state(cfg, tc)
    rows = torch.from_numpy(tstep.step_scalar_rows(state, cfg, tc, 6))
    assert rows.dtype == torch.int64 and rows.shape == (6, tstep.StepScalars.width(2, 3))
    wants = []
    for s in range(6):
        sc = tstep.StepScalars.of_row(rows[s], 2, 3)
        want = tassoc.modality_seeds(tstep.step_seed(state.seed, 7 + s), 2)
        wants += want
        assert [int(v) & MASK64 for v in sc.seeds] == want
        assert [seed_bits(w) for w in want] == sc.seeds.tolist()
        assert tassoc.modality_seeds(sc.seeds, 2)[1].shape == ()
        adam = np.array(tstep.adam_scalars(tc, 3 + s), np.float32)
        obj = np.array(tstep.objective_scalars(cfg, tc, 7 + s), np.float32)
        assert sc.adam.numpy().tobytes() == adam.tobytes()
        assert sc.objective.numpy().tobytes() == obj.tobytes()
    assert any(w >= 2**63 for w in wants) and any(w < 2**63 for w in wants)


def test_step_scalar_rows_leave_out_the_objective_when_nothing_anneals():
    cfg, tc = _tiny()
    state = _big_seed_state(cfg, tc, count=0)
    rows = torch.from_numpy(tstep.step_scalar_rows(state, cfg, tc, 2))
    assert rows.shape == (2, tstep.StepScalars.width(2, 0))
    sc = tstep.StepScalars.of_row(rows[1], 2, 0)
    assert sc.objective is None
    assert sc.adam.tolist() == [float(v) for v in tstep.adam_scalars(tc, 1)]
    with pytest.raises(ValueError, match="expected 2 modality seeds"):
        tassoc.modality_seeds(rows[1, :1], 2)


@pytest.mark.parametrize("seed", [0, 5, fold_in(9, 2), 2**63, 2**63 + 12345, 2**64 - 1])
def test_philox_normal_from_a_tensor_seed_is_the_int_seeds_draw(seed):
    t = torch.tensor(seed_bits(seed), dtype=torch.int64)
    assert torch.equal(philox_normal(t, 37, 20, "cpu"), philox_normal(seed, 37, 20, "cpu"))
    assert torch.equal(philox_normal(t, 5, 3, "cpu", row0=11),
                       philox_normal(seed, 5, 3, "cpu", row0=11))
    mu, lv = torch.randn(9, 4), torch.randn(9, 4)
    for a, b in zip(ksamp.reparameterize_plain(mu, lv, t),
                    ksamp.reparameterize_plain(mu, lv, seed)):
        assert torch.equal(a, b)
    assert torch.equal(ksamp.reparameterize_fused(mu, lv, t),
                       ksamp.reparameterize_fused(mu, lv, seed))


def test_optimizer_with_tensor_scalars_matches_host_floats_bit_for_bit():
    _, tc = _tiny(**SCHEDULE)
    opt = tstep.make_optimizer(tc)
    g = torch.Generator().manual_seed(1)
    shapes = [(7, 5), (5,), (3, 3, 2)]
    p_host = [torch.randn(s, generator=g) for s in shapes]
    p_dev = [p.clone() for p in p_host]
    s_host, s_dev = opt.init(p_host), opt.init(p_dev)
    for step in range(20):
        grads = [torch.randn(s, generator=g) * (0.01 if step % 3 else 1.0) for s in shapes]
        opt.update(grads, s_host, p_host)
        scalars = torch.tensor(tstep.adam_scalars(tc, s_dev.adam.count), dtype=torch.float32)
        opt.update(grads, s_dev, p_dev, scalars=scalars)
        for a, b in zip(p_host + s_host.adam.mu + s_host.adam.nu + s_host.ema,
                        p_dev + s_dev.adam.mu + s_dev.adam.nu + s_dev.ema):
            assert torch.equal(a, b), step
        assert (s_host.adam.count, s_host.ema_count) == (s_dev.adam.count, s_dev.ema_count)


def test_optimizer_refuses_tensor_scalars_with_accumulation():
    _, tc = _tiny(accum_steps=2)
    opt = tstep.make_optimizer(tc)
    p = [torch.zeros(3)]
    with pytest.raises(ValueError, match="accum_steps == 1"):
        opt.update([torch.ones(3)], opt.init(p), p, scalars=torch.zeros(3))


@pytest.mark.parametrize("use_pallas", [False, True, "mega"])
@pytest.mark.parametrize("schedule", [False, True])
def test_step_on_device_scalars_matches_the_host_step(use_pallas, schedule):
    cfg, tc = _tiny(use_pallas, **(SCHEDULE if schedule else {}))
    xs = _data(cfg, tc.batch_size, "cpu")
    a, b = (tstep.init_train_state(cfg, tc, device="cpu") for _ in range(2))
    rows = torch.from_numpy(tstep.step_scalar_rows(b, cfg, tc, 4))
    opt = tstep.make_optimizer(tc)
    for s in range(4):
        a, ma = tstep._one_step(a, xs, cfg, tc, opt)
        b, mb = tstep._one_step(b, xs, cfg, tc, opt,
                                scalars=tstep.StepScalars.of_row(rows[s], 2, 3 if schedule else 0))
        assert list(ma) == list(mb)
        for k in ma:
            assert torch.equal(ma[k], mb[k]), (s, k)
    for p, q in zip(a.params.parameters(), b.params.parameters()):
        assert torch.equal(p, q)
    assert (a.step, a.opt_state.adam.count) == (b.step, b.opt_state.adam.count)


def test_step_refuses_device_scalars_with_injected_eps():
    cfg, tc = _tiny()
    state = tstep.init_train_state(cfg, tc, device="cpu")
    row = torch.from_numpy(tstep.step_scalar_rows(state, cfg, tc, 1))[0]
    xs = _data(cfg, tc.batch_size, "cpu")
    with pytest.raises(ValueError, match="neither eps nor a group"):
        tstep._one_step(state, xs, cfg, tc, tstep.make_optimizer(tc),
                        eps=[torch.zeros(16, 4)] * 2,
                        scalars=tstep.StepScalars.of_row(row, 2, 0))


def test_fused_loop_runs_eagerly_off_cuda_and_counts_it():
    cfg, tc = _tiny(**SCHEDULE)
    data = _data(cfg, 70, "cpu")
    before = dict(tloop.GRAPH)
    state, hist = tloop.train_loop_fused(cfg, tc, data, epochs=2)
    assert state.step == 8 and len(hist) == 2 and "kl_beta_eff" in hist[0]
    assert tloop.GRAPH["eager_steps"] - before["eager_steps"] == 8
    assert (tloop.GRAPH["captures"], tloop.GRAPH["replays"]) == (
        before["captures"], before["replays"])


# -- on the card ----------------------------------------------------------------


def _eager_fused(cfg, tc, data, state, epochs):
    """``train_loop_fused``'s call with every step run eagerly from host
    values: the same permutation, rows and metric means."""
    dev = data[0].device
    n, bs = data[0].shape[0], tc.batch_size
    steps = (n // bs // tc.steps_per_call) * tc.steps_per_call
    opt = tstep.make_optimizer(tc)
    gen = torch.Generator(device=dev)
    gen.manual_seed(fold_in(tc.seed ^ 0x5EED, state.step) >> 1)
    means = []
    for _ in range(epochs):
        perm = torch.randperm(n, generator=gen, device=dev)[:steps * bs]
        rows = []
        for s in range(steps):
            xs = [d[perm[s * bs:(s + 1) * bs]] for d in data]
            state, m = tstep._one_step(state, xs, cfg, tc, opt)
            rows.append(torch.stack(list(m.values())))
        means.append(torch.stack(rows).mean(0))
    return state, torch.stack(means).cpu(), list(m)


def _card_case(name, card):
    img = tcfg.ModalityConfig("image", tcfg.default_image_arch(), recon="bernoulli")
    traj = tcfg.ModalityConfig("trajectory", tcfg.default_traj_arch(), recon="gaussian")
    c3 = tcfg.AssocConfig([img, traj], assoc_lambda=1.0)
    c4 = tcfg.AssocConfig([dataclasses.replace(img, encoder="conv_pallas"), traj],
                          assoc_lambda=1.0)
    cfg, tc, n = {
        "c3-comp-fp32-b64": (c3, dict(batch_size=64, use_pallas=True), 64 * 6 + 5),
        "c3-comp-fp32-b64-schedule": (c3, dict(batch_size=64, use_pallas=True, **SCHEDULE),
                                      64 * 6),
        "c3-mega-bf16-b1024": (c3, dict(batch_size=1024, use_pallas="mega",
                                        compute_dtype="bfloat16"), 1024 * 3),
        "c4-comp-bf16-b256": (c4, dict(batch_size=256, use_pallas=True,
                                       compute_dtype="bfloat16"), 256 * 3),
    }[name]
    return cfg, tcfg.TrainConfig(seed=11, **tc), _data(cfg, n, card, seed=2)


def _counts():
    return dict(tloop.GRAPH), _launches.snapshot()


def _deltas(before, after):
    return {k: after[k] - before[k] for k in after}


@pytest.mark.card
@pytest.mark.parametrize("case", ["c3-comp-fp32-b64", "c3-comp-fp32-b64-schedule",
                                  "c3-mega-bf16-b1024", "c4-comp-bf16-b256"])
def test_replayed_steps_are_the_eager_steps_bit_for_bit(case, card):
    cfg, tc, data = _card_case(case, card)
    graphed, eager = (tstep.init_train_state(cfg, tc, device=card) for _ in range(2))
    steps = data[0].shape[0] // tc.batch_size
    g0, l0 = _counts()
    hist = []
    for epochs in (2, 1):  # the capture outlives its call
        graphed, h = tloop.train_loop_fused(cfg, tc, data, epochs=epochs, state=graphed)
        hist += h
    g1, l1 = _counts()
    means = []
    for epochs in (2, 1):
        eager, m, keys = _eager_fused(cfg, tc, data, eager, epochs)
        means.append(m)
    torch.cuda.synchronize()
    _, l2 = _counts()
    means = torch.cat(means)
    assert graphed.step == eager.step == 3 * steps
    assert graphed.opt_state.adam.count == eager.opt_state.adam.count
    assert graphed.opt_state.ema_count == eager.opt_state.ema_count
    for p, q in zip(graphed.params.parameters(), eager.params.parameters()):
        assert torch.equal(p, q)
    for la, lb in zip(graphed.opt_state.lists(), eager.opt_state.lists()):
        for a, b in zip(la or [], lb or []):
            assert torch.equal(a, b)
    for e, h in enumerate(hist):
        for i, k in enumerate(keys):
            assert h[k] == means[e, i].item(), (e, k)
    assert _deltas(g0, g1) == {"captures": 1, "replays": 3 * steps - 1, "eager_steps": 1}
    assert _deltas(l0, l1) == _deltas(l1, l2)  # the launches of every replayed step count


@pytest.mark.card
def test_replayed_kernels_draw_from_each_replays_seed(card):
    cfg, _, _ = _card_case("c3-mega-bf16-b1024", card)
    flat = [t.detach().contiguous() for t in
            kmega.flatten(tassoc.init_assoc(0, cfg, device=card).modalities[0])]
    x = torch.rand(300, 784, device=card)
    mu, lv = torch.randn(300, 20, device=card), torch.randn(300, 20, device=card)
    slot = torch.zeros((), dtype=torch.int64, device=card)

    def draws():
        z, eps = ksamp.reparameterize_kernel(mu, lv, slot)
        tower = kmega.tower_fwd(flat, x, kind="bernoulli", seed=slot,
                                compute_dtype="bfloat16")
        return z, eps, *tower

    draws()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = draws()
    seen = []
    for seed in (5, 2**63 + 11, 2**64 - 1):
        slot.fill_(seed_bits(seed))
        graph.replay()
        want = (*ksamp.reparameterize_kernel(mu, lv, seed),
                *kmega.tower_fwd(flat, x, kind="bernoulli", seed=seed,
                                 compute_dtype="bfloat16"))
        for a, b in zip(outs, want):
            assert torch.equal(a, b), seed
        seen.append(outs[1].clone())
    assert not torch.equal(seen[0], seen[1]) and not torch.equal(seen[1], seen[2])


@pytest.mark.card
def test_each_training_state_gets_its_own_capture(card):
    cfg, tc, data = _card_case("c3-comp-fp32-b64", card)
    gc.collect()
    n = len(tloop._graphs)
    a = tstep.init_train_state(cfg, tc, device=card)
    b = tstep.init_train_state(cfg, tc, device=card)
    g0, _ = _counts()
    a, _ = tloop.train_loop_fused(cfg, tc, data, epochs=1, state=a)
    b, _ = tloop.train_loop_fused(cfg, tc, data, epochs=1, state=b)
    a, _ = tloop.train_loop_fused(cfg, tc, data, epochs=1, state=a)
    g1, _ = _counts()
    assert _deltas(g0, g1) == {"captures": 2, "replays": 18 - 2, "eager_steps": 2}
    for p, q in zip(b.params.parameters(), a.params.parameters()):
        assert not torch.equal(p, q)  # a trained a second epoch
    assert a.params in tloop._graphs and b.params in tloop._graphs
    assert len(tloop._graphs) == n + 2
    del a, b
    gc.collect()
    assert len(tloop._graphs) == n  # a state's capture goes with it


@pytest.mark.card
def test_accumulation_runs_eagerly_and_counts_it(card):
    cfg, tc, data = _card_case("c3-comp-fp32-b64", card)
    tc = dataclasses.replace(tc, accum_steps=2)
    g0, _ = _counts()
    state, _ = tloop.train_loop_fused(cfg, tc, data, epochs=1, device=card)
    g1, _ = _counts()
    assert state.step == 6 and state.opt_state.adam.count == 3
    assert _deltas(g0, g1) == {"captures": 0, "replays": 0, "eager_steps": 6}
