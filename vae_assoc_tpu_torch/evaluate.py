"""Model evaluation CLI (counterpart of vae_assoc_tpu/evaluate.py, vae-assoc-eval).

    python -m vae_assoc_tpu_torch.evaluate MODEL_DIR --data synthetic [--device cpu]

loads a self-describing ``save_model`` directory (model_config.json plus
whole-state checkpoints, the artifact ``serve.Predictor.load`` reads; a
JAX package directory after ``scripts/jax_checkpoint_to_torch.py``) and
runs the evaluation battery without retraining, on the card unless
``--device cpu``:

- the cross-modal reconstruction MSE grid (``mse_*``),
- the held-out loss surface (``train.eval.eval_metrics``),
- latent recognition (leave-one-out k-NN ``knn_*``; conditional models are
  probed label-blind with the uniform class prior),
- with ``--mll-samples K``, the IWAE and ELBO bounds (``iwae_*``, ``elbo_*``).

The data are synthetic strokes or UJI Pen Characters v2 files (``--data
uji --uji-paths FILE ...``), featurized as the model was trained: the
trajectory encoding and RBF width come from model_config.json's "data"
section unless given, an explicit ``--traj-encoding`` contradicting the
recorded one exits, and every feature width is checked against the arch.
One JSON object on stdout.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

def _build_parser():
    p = argparse.ArgumentParser(
        prog="python -m vae_assoc_tpu_torch.evaluate",
        description="Evaluate a saved model on the PyTorch port (MSE grid, ELBO "
                    "terms, latent recognition, optional IWAE bounds).",
    )
    p.add_argument("model_dir", help="save_model directory (model_config.json + checkpoint)")
    p.add_argument("--data", choices=("synthetic", "uji"), default="synthetic")
    p.add_argument("--n-samples", type=int, default=2048, help="synthetic dataset size")
    p.add_argument("--uji-paths", nargs="+", default=None)
    p.add_argument("--traj-encoding", choices=("resample", "rbf"), default=None,
                   help="default: the encoding recorded in model_config.json's 'data' "
                        "section; a value contradicting the recorded one fails")
    p.add_argument("--rbf-centers", type=int, default=None)
    p.add_argument("--data-seed", type=int, default=0)
    p.add_argument("--step", type=int, default=None, help="checkpoint step (default: latest)")
    p.add_argument("--batch-size", type=int, default=1024, help="evaluation chunk size")
    p.add_argument("--max-samples", type=int, default=4096,
                   help="cap on rows used for recognition / MLL")
    p.add_argument("--knn-k", type=int, default=5)
    p.add_argument("--mll-samples", type=int, default=0, metavar="K",
                   help="K>0: add K-sample IWAE/ELBO bounds (nats/sample)")
    p.add_argument("--seed", type=int, default=0,
                   help="eval ε / MLL draw seed (deterministic per seed)")
    p.add_argument("--json", default=None, metavar="PATH",
                   help="also write the result dict to this file")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="where to evaluate; cuda raises without a GPU")
    return p


def main(argv=None) -> int:
    args = _build_parser().parse_args(argv)

    import numpy as np

    from vae_assoc_tpu_torch.configs import TrainConfig, load_model_config
    from vae_assoc_tpu_torch.data.pipeline import PairedDataset
    from vae_assoc_tpu_torch.models.networks import cuda_or_raise
    from vae_assoc_tpu_torch.train import eval as eval_mod
    from vae_assoc_tpu_torch.train.step import eval_params, init_train_state
    from vae_assoc_tpu_torch.utils import checkpoint as ckpt

    model_dir = os.path.abspath(os.path.expanduser(args.model_dir))
    try:
        cfg, tc, raw = load_model_config(model_dir)
    except FileNotFoundError as e:
        raise SystemExit(str(e))
    tc = tc or TrainConfig()
    meta = raw.get("data", {})
    if (args.traj_encoding and meta.get("traj_encoding")
            and args.traj_encoding != meta["traj_encoding"]):
        raise SystemExit(
            f"--traj-encoding {args.traj_encoding} contradicts the recorded "
            f"training featurization {meta['traj_encoding']!r} "
            "(model_config.json 'data')"
        )
    enc = args.traj_encoding or meta.get("traj_encoding") or "resample"
    centers = args.rbf_centers or meta.get("rbf_centers") or 100
    if args.data == "uji" and not args.uji_paths:
        raise SystemExit("--data uji requires --uji-paths")

    device = cuda_or_raise(args.device, "evaluate")
    state = ckpt.restore(model_dir, init_train_state(cfg, tc, device=device), step=args.step)
    # EMA-trained models evaluate on the debiased averaged weights.
    params = eval_params(tc, state)

    kw = dict(traj_encoding=enc, rbf_centers=centers, device=device)
    if args.data == "uji":
        ds = PairedDataset.from_uji(args.uji_paths, **kw)
    else:
        ds = PairedDataset.from_synthetic(args.n_samples, seed=args.data_seed, **kw)
    imgs, trajs = ds.features()
    by_name = {"image": imgs, "trajectory": trajs}
    missing = [m.name for m in cfg.modalities if m.name not in by_name]
    if missing:
        raise SystemExit(f"dataset provides image/trajectory; model needs {missing}")
    xs = [by_name[m.name] for m in cfg.modalities]
    for m, x in zip(cfg.modalities, xs):
        if int(x.shape[1]) != int(m.arch["n_input"]):
            raise SystemExit(
                f"feature width mismatch for {m.name!r}: dataset gives "
                f"{int(x.shape[1])}, model expects {m.arch['n_input']}; check "
                "--traj-encoding/--rbf-centers against the training run"
            )

    labels = None if ds.labels is None else np.asarray(ds.labels)
    if cfg.n_cond > 0:
        if labels is None:
            raise SystemExit("conditional model: the dataset must be labeled")
        n_classes = int(labels.max()) + 1
        if n_classes > cfg.n_cond:
            raise SystemExit(
                f"dataset has {n_classes} classes but the model was trained "
                f"with n_cond={cfg.n_cond}"
            )
        xs = xs + [np.eye(cfg.n_cond, dtype=np.float32)[labels]]

    ekw = dict(compute_dtype=tc.compute_dtype, use_pallas=tc.use_pallas)
    result = {
        "model_dir": model_dir,
        "step": int(state.step),
        "data": args.data,
        "n_samples": int(xs[0].shape[0]),
        "backend": device.type,
    }
    result.update({f"mse_{k}": v for k, v in eval_mod.evaluate(params, xs, cfg, **ekw).items()})
    em = eval_mod.eval_metrics(params, xs, cfg, batch_size=args.batch_size, seed=args.seed,
                               **ekw)
    # The MSE grid is reported above under the mse_ names.
    result.update({k: v for k, v in em.items() if "->" not in k})
    if labels is not None and xs[0].shape[0] >= 2:
        n = min(int(xs[0].shape[0]), args.max_samples)
        rec_xs = [x[:n] for x in xs]
        if cfg.n_cond > 0:
            rec_xs[-1] = eval_mod.label_blind_cond(n, cfg.n_cond)
        result.update(eval_mod.recognition_accuracy(
            params, rec_xs, labels[:n], cfg, k=args.knn_k, **ekw
        ))
    if args.mll_samples > 0:
        result.update(eval_mod.marginal_log_likelihood(
            params, xs, cfg, n_importance=args.mll_samples,
            seed=args.seed, max_samples=args.max_samples, **ekw
        ))

    line = json.dumps(result)
    print(line)
    if args.json:
        with open(args.json, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
