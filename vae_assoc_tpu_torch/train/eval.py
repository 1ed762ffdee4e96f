"""Evaluation (counterpart of vae_assoc_tpu/train/eval.py).

- ``cross_modal_mse`` / ``evaluate``: encode modality i, decode modality j,
  MSE against the paired ground truth x_j, for every ordered pair.
- ``eval_metrics``: the loss terms and the MSE grid over a whole held-out
  set in fixed-size chunks, ε a pure function of (seed, chunk index).
- ``marginal_log_likelihood``: k-sample IWAE and ELBO bounds.
- ``recognition_accuracy``: leave-one-out k-NN over the latent means.

Every function runs under ``torch.no_grad`` on the weights' device, with
the encoder and decoder calls on the kernels where ``use_pallas`` asks for
them, as the JAX package's do. Inputs may be numpy arrays or tensors.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from vae_assoc_tpu_torch.configs import TRANSFER_FNS, AssocConfig
from vae_assoc_tpu_torch.models import assoc as assoc_mod
from vae_assoc_tpu_torch.models import vae as vae_mod
from vae_assoc_tpu_torch.ops import losses
from vae_assoc_tpu_torch.ops.sampling import fold_in, philox_normal

_LOG_2PI = 1.8378770664093453  # log(2π)


def _device(params):
    return next(params.parameters()).device


def _on(params, xs, k: int) -> list:
    """The batch list on the weights' device: the K modality inputs as fp32,
    a trailing condition entry as given."""
    dev = _device(params)
    out = []
    for i, x in enumerate(xs):
        t = x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))
        out.append(t.to(dev, torch.float32) if i < k else t.to(dev))
    return out


def cross_modal_mse(params, xs, cfg: AssocConfig, *, compute_dtype="float32",
                    use_pallas=False) -> dict:
    """MSE of every encode(i)→decode(j) path against paired ground truth:
    {"<name_i>-><name_j>": scalar tensor} for all ordered pairs (i == j is
    plain reconstruction). Conditional models: the condition rides as the
    trailing xs entry and threads through both nets of every pair."""
    xs, cond = assoc_mod.split_cond(xs, cfg)
    results = {}
    k = len(cfg.modalities)
    with torch.no_grad():
        for i in range(k):
            for j in range(k):
                out = assoc_mod.cross_generate(
                    params, xs[i], cfg, src=i, dst=j, compute_dtype=compute_dtype,
                    use_pallas=use_pallas, cond=cond,
                )
                d = out.float() - xs[j].float()
                name = f"{cfg.modalities[i].name}->{cfg.modalities[j].name}"
                results[name] = torch.mean(d * d)
    return results


def _floats(metrics: dict) -> dict:
    """Scalar tensors → floats, in one device → host copy."""
    keys = list(metrics)
    vals = torch.stack([metrics[k].float() for k in keys]).cpu().tolist()
    return dict(zip(keys, vals))


def evaluate(params, xs, cfg: AssocConfig, *, compute_dtype="float32",
             use_pallas=False) -> dict:
    """Host-friendly wrapper: the cross-modal MSE dict as floats."""
    xs = _on(params, xs, len(cfg.modalities))
    return _floats(cross_modal_mse(params, xs, cfg, compute_dtype=compute_dtype,
                                   use_pallas=use_pallas))


def _chunk_eps(cfg: AssocConfig, seed: int, chunk: int, rows: int, device) -> list:
    """The ε per modality that ``eval_metrics`` draws for a chunk of
    ``rows`` rows: the train step's stream (models/assoc.modality_seeds)
    keyed by the chunk's seed."""
    seeds = assoc_mod.modality_seeds(fold_in(seed, chunk), len(cfg.modalities))
    return [vae_mod.draw_eps(s, rows, m, device) for s, m in zip(seeds, cfg.modalities)]


def eval_metrics(params, xs, cfg: AssocConfig, *, batch_size: int = 1024,
                 compute_dtype="float32", use_pallas=False, seed: int = 0) -> dict:
    """Held-out evaluation: the loss terms (total, recon_*, kl_*, assoc) and
    the cross-modal MSE grid over the whole set, in chunks of
    ``batch_size`` rows and a ragged tail, each chunk weighted by its rows.
    Chunk c draws its ε from ``fold_in(seed, c)``, so a repeated call on
    the same weights returns the same numbers."""
    xs = _on(params, xs, len(cfg.modalities))
    n = int(xs[0].shape[0])
    if n == 0:
        raise ValueError("eval_metrics needs at least one sample")
    b = min(batch_size, n)
    sums = None
    with torch.no_grad():
        for c, lo in enumerate(range(0, n, b)):
            chunk = [x[lo:lo + b] for x in xs]
            _, m = assoc_mod.assoc_loss_fn(
                params, chunk, cfg, seed=fold_in(seed, c),
                compute_dtype=compute_dtype, use_pallas=use_pallas,
            )
            m = dict(m)
            m.update(cross_modal_mse(params, chunk, cfg, compute_dtype=compute_dtype,
                                     use_pallas=use_pallas))
            rows = float(chunk[0].shape[0])
            part = {k: v.float() * rows for k, v in m.items()}
            sums = part if sums is None else {k: sums[k] + part[k] for k in sums}
    return {k: v / n for k, v in _floats(sums).items()}


def _block_size(n_importance: int, block) -> int:
    if n_importance < 1:
        raise ValueError(f"n_importance must be >= 1, got {n_importance}")
    if block is None:
        # The largest divisor of k that is at most 8: a [block·B, D] decode
        # a launch, with only the [k, B] log-weights kept across blocks.
        block = max(d for d in range(1, min(8, n_importance) + 1) if n_importance % d == 0)
    block = min(block, n_importance)
    if n_importance % block:
        raise ValueError(f"block={block} must divide n_importance={n_importance}")
    return block


def marginal_log_likelihood(params, xs, cfg: AssocConfig, *, n_importance: int = 64,
                            block: int | None = None, seed: int = 0,
                            compute_dtype="float32", use_pallas=False,
                            max_samples: int = 2048, eps=None) -> dict:
    """Per-modality marginal log-likelihood bounds in nats a sample (higher
    is better): the k-sample IWAE bound and the ELBO of the same draws.

    log w = log p(x|z) + log p(z) − log q(z|x), z = μ + σ·ε. The Bernoulli
    density is exact; the Gaussian modality's SSE loss is the likelihood
    N(x̂, σ² = ½), so its bound adds the (D/2)·log π normalizer. Each
    modality is encoded once; then ``n_importance / block`` blocks each
    decode ``block · B`` rows. IWAE ≥ ELBO for every set of draws. ε of
    block i of modality m is drawn from ``fold_in(fold_in(seed, m), i)``,
    or injected as ``eps`` (one [n_importance, B, n_z] array per modality).
    """
    k = n_importance
    block = _block_size(k, block)
    dev = _device(params)
    xs, cond = assoc_mod.split_cond(_on(params, xs, len(cfg.modalities)), cfg)
    n = min(int(xs[0].shape[0]), max_samples)
    xs = [x[:n] for x in xs]
    if cond is not None:
        cond = vae_mod.prepare_cond(cond[:n], cfg.modalities[0], n, device=dev)
    if eps is not None:
        eps = [torch.as_tensor(e).to(dev, torch.float32) for e in eps]
        for e, m in zip(eps, cfg.modalities):
            want = (k, n, m.arch["n_z"])
            if tuple(e.shape) != want:
                raise ValueError(f"eps for {m.name}: {tuple(e.shape)} != {want}")
    out = {}
    with torch.no_grad():
        for m_i, (p, x, mcfg) in enumerate(zip(params.modalities, xs, cfg.modalities)):
            _, encode, decode = vae_mod._net_fns(mcfg, use_pallas)
            transfer = TRANSFER_FNS[mcfg.transfer]
            x_enc = x if cond is None else torch.cat([x, cond], dim=1)
            mu, lv = encode(p, x_enc, compute_dtype=compute_dtype, transfer=transfer)
            mu, lv = mu.float(), lv.float()
            sigma = torch.exp(0.5 * lv)
            n_z, d = mu.shape[1], x.shape[1]
            m_seed = fold_in(seed, m_i)
            x_rep = x.repeat(block, 1)
            c_rep = None if cond is None else cond.repeat(block, 1)
            lws = []
            for i in range(k // block):
                if eps is None:
                    e = philox_normal(fold_in(m_seed, i), block * n, n_z, dev)
                    e = e.reshape(block, n, n_z)
                else:
                    e = eps[m_i][i * block:(i + 1) * block]
                z = mu[None] + sigma[None] * e  # [block, B, n_z]
                z_dec = z.reshape(block * n, n_z)
                if c_rep is not None:
                    z_dec = torch.cat([z_dec, c_rep], dim=1)
                recon = decode(p, z_dec, compute_dtype=compute_dtype, transfer=transfer)
                if mcfg.recon == "bernoulli":
                    nll = losses.bernoulli_recon(x_rep, logits=recon)
                else:
                    nll = losses.gaussian_recon(x_rep, recon) + 0.5 * d * math.log(math.pi)
                nll = nll.reshape(block, n)
                # The n_z·log 2π halves of log p(z) and log q cancel; kept
                # as the reference writes them.
                log_p_z = -0.5 * (torch.sum(z * z, dim=-1) + n_z * _LOG_2PI)
                log_q = -0.5 * (torch.sum(e * e, dim=-1) + torch.sum(lv, dim=-1)[None]
                                + n_z * _LOG_2PI)
                lws.append(-nll + log_p_z - log_q)
            lw = torch.cat(lws)  # [k, B]
            name = mcfg.name
            out[f"elbo_{name}"] = torch.mean(lw)
            out[f"iwae_{name}"] = torch.mean(torch.logsumexp(lw, dim=0) - math.log(k))
    return _floats(out)


def label_blind_cond(n: int, n_cond: int):
    """Uniform class-prior condition rows [n, n_cond]: the label-free probe
    for recognition on conditional models (the true one-hot would leak the
    answer into the latent the k-NN then classifies)."""
    return np.full((n, n_cond), 1.0 / n_cond, np.float32)


def _knn_classify(train_z, train_labels, query_z, n_classes: int, k: int, mask_diag: bool):
    """k-NN class prediction: one [Q, N] squared-distance product
    ‖a‖² + ‖b‖² − 2a·b, the k nearest by ``torch.topk``, and a one-hot vote
    whose ties go to the smaller class id (argmax takes the first maximum).
    ``mask_diag`` leaves query i's own row i out of the train set."""
    q = query_z.float()
    t = train_z.float()
    d2 = (torch.sum(q * q, dim=1, keepdim=True) - 2.0 * (q @ t.T)
          + torch.sum(t * t, dim=1)[None, :])
    if mask_diag:
        d2.fill_diagonal_(float("inf"))
    _, idx = torch.topk(-d2, k, dim=1)
    votes = F.one_hot(train_labels[idx], n_classes).float().sum(dim=1)
    return torch.argmax(votes, dim=1)


def recognition_accuracy(params, xs, labels, cfg: AssocConfig, *, k: int = 5,
                         compute_dtype="float32", use_pallas=False,
                         max_samples: int = 4096) -> dict:
    """Latent recognition by leave-one-out k-NN over the latent means:
    ``knn_<name>`` classifies modality m's latents among themselves, and
    ``knn_<a>-><b>`` classifies modality b's latents against modality a's
    as the reference set (transfer shows the association aligned the two
    spaces). ``max_samples`` caps the [N, N] distance matrix."""
    labels = np.asarray(labels)
    n = min(int(labels.shape[0]), int(xs[0].shape[0]), max_samples)
    if n < 2:
        raise ValueError(f"recognition_accuracy needs >= 2 samples, got {n}")
    labels = labels[:n].astype(np.int64)
    n_classes = int(labels.max()) + 1
    k_eff = min(k, n - 1)  # leave-one-out leaves n - 1 candidates
    xs = _on(params, [x[:n] for x in xs], len(cfg.modalities))
    lab = torch.as_tensor(labels, device=_device(params))
    out = {}
    with torch.no_grad():
        zs = assoc_mod.transform(params, xs, cfg, compute_dtype=compute_dtype,
                                 use_pallas=use_pallas)
        kk = len(cfg.modalities)
        for i in range(kk):
            for j in range(kk):
                pred = _knn_classify(zs[i], lab, zs[j], n_classes, k_eff, True)
                ni, nj = cfg.modalities[i].name, cfg.modalities[j].name
                out[f"knn_{ni}" if i == j else f"knn_{ni}->{nj}"] = (pred == lab).float().mean()
    return _floats(out)
