"""Entry points of the graded artifact (counterpart of the JAX package's
``__graft_entry__.py``): one forward on the flagship model, and a dry run
of every multi-device layout on tiny shapes.

- ``entry()`` returns ``(fn, example_args)``: the joint forward and loss of
  config 3 (image + trajectory, the reference's full widths) at batch 64.
- ``dryrun_multichip(n)`` runs n ranks (``parallel.mesh.spawn``), each
  taking legs a–k of the JAX package's dry run on the port's layouts, at
  its tiny shapes and a global batch of 2n, with its checks: (a) DP with
  two steps a call in bf16; (b) DP × TP under the GSPMD names on a
  (data, model) mesh; (c) FSDP; (c2) TP × FSDP with the cosine schedule,
  warmup, clipping and accumulation; (d) config 5 as it ships
  (``use_pallas=True``, bf16, ten steps a call); (e) DP × sweep, three
  models with their own λ (``train.sweep.make_dp_sweep_step``); (f) ZeRO
  on config 5, its state stored as flat slices of one size; (g) a
  conditional model with β-annealing through DP; (h) the GPipe ring over
  a (stage,) mesh; (i) DP × PP; (j) the ``tp_shard`` layout, its widths
  padded to a multiple of the model group; (k) DP × TP keeping the kernels,
  on the conditional model. A leg that fails raises; none is skipped.

The ranks run on the card (``device_type="cuda"``, over NCCL) unless the
caller names the CPU (gloo) or another backend: NCCL refuses two ranks on
one card, so ranks that share one run over ``backend="gloo"``, the
caller's choice.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from vae_assoc_tpu_torch.models.networks import cuda_or_raise

LEGS = ("a", "b", "c", "c2", "d", "e", "f", "g", "h", "i", "j", "k")


def entry(device="cuda"):
    """(fn, example_args): the joint forward and loss of config 3 at batch
    64, ``fn(params, x_img, x_traj, seed, eps=None) -> (total, metrics)``,
    on ``device`` (the card unless the caller names the CPU)."""
    from vae_assoc_tpu_torch.configs import baseline_config
    from vae_assoc_tpu_torch.models import assoc as assoc_mod

    dev = cuda_or_raise(device, "entry")
    cfg, tc = baseline_config(3)  # the joint image + trajectory model
    params = assoc_mod.init_assoc(0, cfg, device=dev)
    b = 64
    x_img = torch.zeros(b, 784, device=dev)
    x_traj = torch.zeros(b, 200, device=dev)

    def fn(params, x_img, x_traj, seed, eps=None):
        return assoc_mod.assoc_loss_fn(
            params, [x_img, x_traj], cfg, seed=None if eps is not None else seed, eps=eps,
            compute_dtype=tc.compute_dtype,
        )

    return fn, (params, x_img, x_traj, 0)


def _check(ok: bool, what) -> None:
    if not ok:
        raise AssertionError(what)


def _ran(metrics: dict, state, steps: int, key: str = "total", shape=None) -> None:
    """The JAX legs' checks: the metric of each step, finite, of the shape,
    and the state ``steps`` on."""
    got = metrics[key].detach().cpu().numpy()
    want = shape if shape is not None else (steps,)
    _check(got.shape == want and np.all(np.isfinite(got)), (key, got))
    _check(int(state.step) == steps, ("step", state.step))


def _pair(rng, spc, b, n=32):
    return [rng.uniform(0, 1, (spc, b, n)).astype(np.float32),
            rng.normal(size=(spc, b, n)).astype(np.float32)]


def _deep_cfg(c, hidden_layers: int):
    arch = dict(n_input=32, n_z=4)
    for k in range(1, hidden_layers + 1):
        arch[f"n_hidden_recog_{k}"] = 16
        arch[f"n_hidden_gener_{k}"] = 16
    return c.AssocConfig([c.ModalityConfig("image", arch, recon="bernoulli"),
                          c.ModalityConfig("trajectory", dict(arch), recon="gaussian")],
                         assoc_lambda=1.0)


def _dryrun_rank(rank: int, n: int, device_type: str) -> list:
    """Legs a–k on this rank of an n-rank group; returns the legs run."""
    from vae_assoc_tpu_torch import configs as c
    from vae_assoc_tpu_torch import parallel as par
    from vae_assoc_tpu_torch.parallel import pp as pp_mod
    from vae_assoc_tpu_torch.parallel import slices
    from vae_assoc_tpu_torch.parallel import tp_shard as tps
    from vae_assoc_tpu_torch.train import sweep

    done = []
    cfg = _deep_cfg(c, 2)
    spc = 2  # two steps a call
    tc = c.TrainConfig(batch_size=2 * n, compute_dtype="bfloat16", steps_per_call=spc)
    b = tc.batch_size
    rng = np.random.default_rng(0)
    dt = device_type

    # (a) DP
    mesh = par.make_mesh(n, device_type=dt)
    state = par.init_dp_train_state(cfg, tc, mesh)
    state, m = par.make_dp_train_step(cfg, tc, mesh)(
        state, par.shard_batch(mesh, _pair(rng, spc, b), leading_scan_axis=True))
    _ran(m, state, spc)
    done.append("a")

    # (b) DP × TP under the GSPMD names, on a (data, model) mesh
    mesh2 = par.make_mesh(n, model_axis="model", model_parallel=2, device_type=dt)
    tp_state = par.init_tp_train_state(cfg, tc, mesh2)
    tp_state, m = par.make_tp_train_step(cfg, tc, mesh2)(
        tp_state, par.shard_tp_batch(mesh2, _pair(rng, spc, b), leading_scan_axis=True))
    _ran(m, tp_state, spc)
    done.append("b")

    # (c) FSDP: weights and optimizer state sharded over the data axis
    f_state = par.init_fsdp_train_state(cfg, tc, mesh)
    f_state, m = par.make_fsdp_train_step(cfg, tc, mesh)(
        f_state, par.shard_batch(mesh, _pair(rng, spc, b), leading_scan_axis=True))
    _ran(m, f_state, spc)
    done.append("c")

    # (c2) TP × FSDP with the optimizer's options: cosine with warmup,
    # clipping and accumulation, whose accumulator shards like the weights
    tc_opt = dataclasses.replace(tc, lr_schedule="cosine", warmup_steps=2, decay_steps=10,
                                 grad_clip_norm=1.0, accum_steps=2)
    cf_state = par.init_tp_fsdp_train_state(cfg, tc_opt, mesh2)
    cf_state, m = par.make_tp_fsdp_train_step(cfg, tc_opt, mesh2)(
        cf_state, par.shard_tp_batch(mesh2, _pair(rng, spc, b), leading_scan_axis=True))
    _ran(m, cf_state, spc)
    done.append("c2")

    # (d) config 5 as declared (kernels, bf16, ten steps a call), its batch cut
    cfg5, tc5 = c.baseline_config(5, batch_size=2 * n)
    _check(tc5.use_pallas and tc5.compute_dtype == "bfloat16", tc5)
    spc5 = tc5.steps_per_call
    xs5 = par.shard_batch(mesh, [rng.uniform(0, 1, (spc5, b, 784)).astype(np.float32),
                                 rng.normal(size=(spc5, b, 200)).astype(np.float32)],
                          leading_scan_axis=True)
    state5 = par.init_dp_train_state(cfg5, tc5, mesh)
    state5, m = par.make_dp_train_step(cfg5, tc5, mesh)(state5, xs5)
    _ran(m, state5, spc5)
    done.append("d")

    # (e) DP × sweep: three models with their own λ on the sharded batches
    sw_state = sweep.init_dp_sweep_state(cfg, tc, mesh, [0, 1, 2])
    lams = torch.tensor([0.5, 1.0, 2.0], device=par.mesh.mesh_device(mesh))
    sw_state, m = sweep.make_dp_sweep_step(cfg, tc, mesh, vary_assoc=True)(
        sw_state, par.shard_batch(mesh, _pair(rng, spc, b), leading_scan_axis=True), lams)
    _ran(m, sw_state, spc, shape=(spc, 3))
    done.append("e")

    # (f) ZeRO on config 5: flat slices of one size on every rank
    z_state = par.init_zero_train_state(cfg5, tc5, mesh)
    w = z_state.params[0]
    _check(w.ndim == 1 and w.numel() == slices.pad_len(784 * 500, n) // n, w.shape)
    z_state, m = par.make_zero_train_step(cfg5, tc5, mesh)(z_state, xs5)
    _ran(m, z_state, spc5)
    full = par.gather_zero_train_state(z_state, cfg5, tc5, mesh)
    _check(int(full.step) == spc5, full.step)
    _check(tuple(full.params.modalities[0].recog.h1.w.shape) == (784, 500),
           full.params.modalities[0].recog.h1.w.shape)
    done.append("f")

    # (g) a conditional model with β-annealing through DP: the one-hot
    # condition rides as the trailing batch entry
    n_cond = 3
    cfg_c = c.AssocConfig([dataclasses.replace(mc, n_cond=n_cond) for mc in cfg.modalities],
                          assoc_lambda=cfg.assoc_lambda)
    tc_c = dataclasses.replace(tc, kl_beta=0.5, kl_anneal_steps=4, assoc_warmup_steps=4)
    labels = rng.integers(0, n_cond, (spc, b))
    c_state = par.init_dp_train_state(cfg_c, tc_c, mesh)
    c_state, m = par.make_dp_train_step(cfg_c, tc_c, mesh)(
        c_state, par.shard_batch(mesh, _pair(rng, spc, b) + [np.eye(n_cond, dtype=np.float32)
                                                              [labels]],
                                 leading_scan_axis=True))
    _ran(m, c_state, spc)
    betas = m["kl_beta_eff"].cpu().numpy()
    _check(betas.shape == (spc,) and betas[0] == 0.0 and betas[1] > 0.0, betas)
    done.append("g")

    # (h) the GPipe ring over a (stage,) mesh, batches whole on every rank
    cfg_pp = _deep_cfg(c, n + 1)
    pmesh = par.make_pp_mesh(n, device_type=dt)
    p_state = par.init_pp_train_state(cfg_pp, tc, pmesh)
    mid = p_state.params.modalities[0].recog.mid.w
    _check(pmesh.size(0) == n and tuple(mid.shape) == (1, 16, 16), mid.shape)  # one layer a stage
    p_state, m = par.make_pp_train_step(cfg_pp, tc, pmesh, n_micro=n)(
        p_state, par.shard_pp_batch(pmesh, _pair(rng, spc, b)))
    _ran(m, p_state, spc)
    done.append("h")

    # (i) DP × PP: S = n/2 stages × 2 data shards
    s_pp = n // 2
    cfg_pp2 = _deep_cfg(c, s_pp + 1)
    pmesh2 = par.make_pp_mesh(s_pp, data_parallel=2, device_type=dt)
    p2_state = par.init_pp_train_state(cfg_pp2, tc, pmesh2)
    p2_state, m = par.make_pp_train_step(cfg_pp2, tc, pmesh2, n_micro=s_pp)(
        p2_state, pp_mod.shard_pp_batch(pmesh2, _pair(rng, spc, b), leading_scan_axis=True))
    _ran(m, p2_state, spc)
    done.append("i")

    # (j) the tp_shard layout: h1's 16 columns cut over n ranks, padded to
    # the next multiple of n
    tmesh = tps.make_tp_mesh(n, device_type=dt)
    t_state = tps.init_tp_train_state(cfg, tc, tmesh)
    h1 = t_state.params.modalities[0].recog.h1.w
    _check(tuple(h1.shape) == (32, -(-16 // n)), h1.shape)
    t_state, m = tps.make_tp_train_step(cfg, tc, tmesh)(
        t_state, tps.shard_tp_batch(tmesh, _pair(rng, spc, b)))
    _ran(m, t_state, spc)
    full_t = tps.gather_tp_train_state(t_state, cfg, tc, tmesh)
    _check(tuple(full_t.params.modalities[0].recog.h1.w.shape) == (32, 16),
           full_t.params.modalities[0].recog.h1.w.shape)
    done.append("j")

    # (k) DP × TP keeping the kernels, on the conditional model
    kmesh = tps.make_tp_mesh(n, data_parallel=2, device_type=dt)
    _check(dict(zip(kmesh.mesh_dim_names, kmesh.shape)) == {"data": 2, "model": n // 2},
           kmesh.shape)
    k_state = tps.init_tp_train_state(cfg_c, tc, kmesh)
    k_labels = rng.integers(0, n_cond, (spc, b))
    k_state, m = tps.make_tp_train_step(cfg_c, tc, kmesh)(
        k_state, par.shard_batch(kmesh, _pair(rng, spc, b) + [
            np.eye(n_cond, dtype=np.float32)[k_labels]], leading_scan_axis=True,
            batch_axes="data"))
    _ran(m, k_state, spc)
    full_k = tps.gather_tp_train_state(k_state, cfg_c, tc, kmesh)
    # the conditional first layer: n_input + n_cond rows, whole
    _check(tuple(full_k.params.modalities[0].recog.h1.w.shape) == (32 + n_cond, 16),
           full_k.params.modalities[0].recog.h1.w.shape)
    done.append("k")
    return done


def dryrun_multichip(n: int, *, device_type: str = "cuda", backend=None,
                     timeout_s: float = 600.0) -> list:
    """Legs a–k on ``n`` ranks (n even and at least 4, so that the
    (data, model) and (stage, data) meshes of legs b, c2, i and k exist).
    Ranks run on the card unless ``device_type="cpu"``; ``backend`` is
    ``torch.distributed``'s (NCCL on the card and gloo on the CPU by
    default; gloo for ranks that share one card). Raises if a leg fails;
    returns the legs every rank ran."""
    if n < 4 or n % 2:
        raise ValueError(f"dryrun_multichip needs an even n >= 4 (legs b, c2, i and k "
                         f"split the ranks in two), got {n}")
    cuda_or_raise(device_type, "dryrun_multichip")
    from vae_assoc_tpu_torch.parallel.mesh import spawn

    done = spawn(_dryrun_rank, n, (n, device_type), device_type=device_type,
                 backend=backend, timeout_s=timeout_s)
    for r, legs in enumerate(done):
        _check(tuple(legs) == LEGS, (r, legs))
    return list(done[0])
