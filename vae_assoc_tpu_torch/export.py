"""Ahead-of-time model export: self-contained ``torch.export`` serving artifacts.

Counterpart of vae_assoc_tpu/export.py. Each inference endpoint is traced
ONCE by ``torch.export`` with a *symbolic* batch dimension and saved with
``torch.export.save`` as ``<endpoint>.pt2``, the trained weights inside.
The artifact directory is self-contained: loading it needs no model
classes, no checkpoint restore and no re-tracing of Python model code, and
any batch size works.

    from vae_assoc_tpu_torch.export import export_predictor, ExportedPredictor

    export_predictor(Predictor.load(model_dir), out_dir)
    ...                                        # later / elsewhere
    ep = ExportedPredictor.load(out_dir)       # on the card; device="cpu" too
    traj = ep.cross_generate(imgs, "image", "trajectory")

Design notes:

- **Symbolic batch** (``torch.export.Dim("b", min=1)``), shared by every
  input of an endpoint: one program per endpoint instead of one per
  (endpoint, bucket). The minimum is 1 because bucketing has a bucket of
  1. ``ExportedPredictor`` keeps ``serve.Predictor``'s power-of-two
  bucketing (``bucketing.py``), so both surfaces pad and chunk alike.
- **Weights are embedded** in each program: the export closes over the
  Predictor's weights. Re-export to pick up new weights.
- **Always the plain formulation** (``use_pallas=False``, and a
  ``conv_pallas`` tower on its plain convs), regardless of the
  Predictor's kernel setting, at the Predictor's compute dtype. The
  hand-written kernels are ``ctypes`` calls into the library that
  ``kernels/_build.py`` builds, and ``torch.export`` cannot trace them. A
  ``torch.library`` custom op around each would put the port's library
  into the artifact's requirements at load time, which breaks "loads
  without model code". The reference made the same choice for its Mosaic
  kernels. Kernel-vs-plain agreement is checked on the card by
  ``chip_smoke.py``; inference tolerances absorb the difference.
- **Either device**: an artifact traced on the card or on the CPU serves
  on either: ``ExportedPredictor.load`` moves every program to its
  ``device`` with ``torch.export.passes.move_to_device_pass`` (the port's
  counterpart of the reference's ``platforms=("cpu", "tpu")``). The
  manifest records the device it was traced on under ``platforms``.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import os
from typing import Optional, Sequence, Union

import numpy as np
import torch

from vae_assoc_tpu_torch import bucketing

MANIFEST = "manifest.json"
_FORMAT = 1
_PLATFORMS = ("cpu", "cuda")
_EXAMPLE_BATCH = 8  # the traced example; the batch dimension is symbolic


class _Endpoint(torch.nn.Module):
    """One serving verb over the weights: what ``torch.export`` traces."""

    def __init__(self, params, fn):
        super().__init__()
        self.params = params
        self.fn = fn

    def forward(self, *args):
        return self.fn(self.params, *args)


def _plain_config(cfg):
    """``cfg`` with every ``conv_pallas`` tower on its plain convs
    (``encoder="conv"``: the same weights, no kernel)."""
    return dataclasses.replace(cfg, modalities=[
        dataclasses.replace(m, encoder="conv") if m.encoder == "conv_pallas" else m
        for m in cfg.modalities
    ])


def _endpoint_fns(params, cfg, compute_dtype):
    """(name -> (module, example inputs)) for every serving endpoint.

    The second entry is a function of (batch, device) that returns the
    float32 example inputs; every input's first dimension is the
    endpoint's batch."""
    from vae_assoc_tpu_torch.models import assoc as assoc_mod

    kw = dict(cfg=_plain_config(cfg), compute_dtype=compute_dtype, use_pallas=False)
    k = len(cfg.modalities)
    n_in = [m.arch["n_input"] for m in cfg.modalities]
    n_z = cfg.modalities[0].arch["n_z"]
    n_c = cfg.n_cond  # conditional models: every endpoint gains a cond arg

    def zeros(b, device, *widths):
        return tuple(torch.zeros(b, n, device=device) for n in widths)

    fns = {}
    # transform takes the trailing-cond batch-list convention directly, so
    # its traced signature stays "one list" either way.
    fns["transform"] = (
        _Endpoint(params, lambda p, xs: assoc_mod.transform(p, xs, **kw)),
        lambda b, device: (list(zeros(b, device, *n_in, *([n_c] if n_c else []))),),
    )
    for j in range(k):
        if n_c:
            fn_g = functools.partial(
                lambda p, z, c, j: assoc_mod.generate(p, z, modality=j, cond=c, **kw), j=j)
            build_g = lambda b, device: zeros(b, device, n_z, n_c)
        else:
            fn_g = functools.partial(
                lambda p, z, j: assoc_mod.generate(p, z, modality=j, **kw), j=j)
            build_g = lambda b, device: zeros(b, device, n_z)
        fns[f"generate_{j}"] = (_Endpoint(params, fn_g), build_g)
    for i in range(k):
        for j in range(k):
            if n_c:
                fn_c = functools.partial(
                    lambda p, x, c, i, j: assoc_mod.cross_generate(
                        p, x, src=i, dst=j, cond=c, **kw), i=i, j=j)
                build_c = functools.partial(
                    lambda b, device, i: zeros(b, device, n_in[i], n_c), i=i)
            else:
                fn_c = functools.partial(
                    lambda p, x, i, j: assoc_mod.cross_generate(p, x, src=i, dst=j, **kw),
                    i=i, j=j)
                build_c = functools.partial(
                    lambda b, device, i: zeros(b, device, n_in[i]), i=i)
            fns[f"cross_generate_{i}_{j}"] = (_Endpoint(params, fn_c), build_c)
    return fns


def export_predictor(predictor, out_dir: str, *,
                     platforms: Optional[Sequence[str]] = None) -> dict:
    """Serialize every serving endpoint of ``predictor`` under ``out_dir``.

    Returns the manifest dict (also written to ``out_dir/manifest.json``).
    The programs are traced on the Predictor's device; every artifact
    serves on either device (``ExportedPredictor.load``), so ``platforms``
    only names the devices recorded in the manifest, a subset of
    ``("cpu", "cuda")``; the default is the tracing device.
    """
    from vae_assoc_tpu_torch.configs import config_to_dict

    device = predictor.device
    platforms = list(platforms) if platforms else [device.type]
    bad = [p for p in platforms if p not in _PLATFORMS]
    if bad:
        raise ValueError(f"unknown platforms {bad}; choose from {_PLATFORMS}")
    os.makedirs(out_dir, exist_ok=True)
    fns = _endpoint_fns(predictor.params, predictor.cfg, predictor.compute_dtype)
    endpoints = {}
    for name, (module, build) in fns.items():
        args = build(_EXAMPLE_BATCH, device)
        batch = torch.export.Dim("b", min=1)
        # One entry: forward's *args, one batch dimension for every input.
        dynamic = (torch.utils._pytree.tree_map(lambda _: {0: batch}, args),)
        with torch.no_grad():
            program = torch.export.export(module, args, dynamic_shapes=dynamic)
        fname = f"{name}.pt2"
        torch.export.save(program, os.path.join(out_dir, fname))
        endpoints[name] = fname
    manifest = {
        "format": _FORMAT,
        "torch_version": torch.__version__,
        "platforms": platforms,
        "compute_dtype": predictor.compute_dtype,
        "config": config_to_dict(predictor.cfg),
        "endpoints": endpoints,
    }
    with open(os.path.join(out_dir, MANIFEST), "w") as f:
        json.dump(manifest, f, indent=1)
    return manifest


def _check_width(a: np.ndarray, n: int, name: str, what: str) -> None:
    """A request of the wrong width is the caller's error: ValueError (the
    traced program would refuse it with an error of its own)."""
    if a.ndim != 2 or a.shape[1] != n:
        raise ValueError(
            f"modality {name!r} expects a [batch, {n}] {what}, got {tuple(a.shape)}")


class ExportedPredictor:
    """Serving endpoints over an ``export_predictor`` artifact directory.

    Mirrors ``serve.Predictor``'s endpoint API (so ``serve_http.ModelServer``
    and ``serve.MicroBatcher`` accept either: duck-typed on
    cross_generate/transform/generate/reconstruct + cfg), but runs the
    loaded ``torch.export`` programs: no model code, no checkpoint restore.
    Same power-of-two bucketing.
    """

    def __init__(self, programs: dict, cfg, manifest: dict, device):
        self.cfg = cfg
        self.manifest = manifest
        self.device = torch.device(device)
        self._call = {name: ep.module() for name, ep in programs.items()}

    @classmethod
    def load(cls, path: str, *, device="cuda") -> "ExportedPredictor":
        """The artifact under ``path`` on ``device``: the card unless the
        caller names the CPU (without a GPU ``device="cuda"`` raises)."""
        from torch.export.passes import move_to_device_pass

        from vae_assoc_tpu_torch.configs import config_from_dict
        from vae_assoc_tpu_torch.models.networks import cuda_or_raise

        device = cuda_or_raise(device, "ExportedPredictor.load")
        # Normalize once and use it everywhere: open() does not expand '~',
        # so reading endpoint files with the raw path would FileNotFoundError
        # on the same directory whose manifest just resolved fine.
        path = os.path.abspath(os.path.expanduser(path))
        mpath = os.path.join(path, MANIFEST)
        if not os.path.exists(mpath):
            raise FileNotFoundError(
                f"no {MANIFEST} under {path} — write artifacts with "
                "export_predictor() first")
        with open(mpath) as f:
            manifest = json.load(f)
        if manifest.get("format") != _FORMAT:
            raise ValueError(
                f"unsupported export format {manifest.get('format')!r} "
                f"(this build reads format {_FORMAT})")
        cfg, _ = config_from_dict(manifest["config"])
        programs = {
            name: move_to_device_pass(torch.export.load(os.path.join(path, fname)),
                                      device)
            for name, fname in manifest["endpoints"].items()
        }
        return cls(programs, cfg, manifest, device)

    # -- device calls: numpy in, numpy out --------------------------------------
    def _t(self, a) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(self.device)

    def _run(self, name: str, *arrays):
        with torch.inference_mode():
            return self._call[name](*(self._t(a) for a in arrays)).cpu().numpy()

    # -- endpoints ---------------------------------------------------------------
    # Pad/chunk bucketing is bucketing.py's (the exact code the live
    # serve.Predictor runs, numpy only, so the no-model-code property of
    # the artifact holds). The programs were traced at float32, hence the
    # cast before chunking.
    def _cond(self, cond, batch):
        # bucketing.check_cond: the ONE serving-side gate (serve/export/http).
        return bucketing.check_cond(cond, self.cfg.n_cond, batch)

    def cross_generate(self, x, src: Union[int, str], dst: Union[int, str],
                       *, cond=None):
        src = self.cfg.modality_index(src)
        dst = self.cfg.modality_index(dst)
        m = self.cfg.modalities[src]
        x = np.asarray(x, np.float32)
        _check_width(x, m.arch["n_input"], m.name, "input")
        cond = self._cond(cond, x.shape[0])
        name = f"cross_generate_{src}_{dst}"
        return bucketing.chunked_cond_call(
            lambda xp, cp: self._run(name, xp) if cp is None else self._run(name, xp, cp),
            x, cond)

    def reconstruct(self, x, modality: Union[int, str], *, cond=None):
        i = self.cfg.modality_index(modality)
        return self.cross_generate(x, i, i, cond=cond)

    def generate(self, z, modality: Union[int, str], *, cond=None):
        j = self.cfg.modality_index(modality)
        m = self.cfg.modalities[j]
        z = np.asarray(z, np.float32)
        _check_width(z, m.arch["n_z"], m.name, "latent")
        cond = self._cond(cond, z.shape[0])
        name = f"generate_{j}"
        return bucketing.chunked_cond_call(
            lambda zp, cp: self._run(name, zp) if cp is None else self._run(name, zp, cp),
            z, cond)

    def transform(self, xs: Sequence[np.ndarray]):
        xs = [np.asarray(x, np.float32) for x in xs]
        k = len(self.cfg.modalities)
        if self.cfg.n_cond:
            # Check arity HERE: the exported program was traced with k+1
            # inputs, so a missing cond would otherwise surface as an
            # opaque input-spec error instead of this message.
            if len(xs) != k + 1:
                raise ValueError(
                    f"conditional model (n_cond={self.cfg.n_cond}): "
                    f"transform takes [x_0..x_{k-1}, cond], got {len(xs)} "
                    "entries"
                )
            xs[k] = self._cond(xs[k], xs[0].shape[0])
        elif len(xs) != k:
            raise ValueError(f"expected {k} modality inputs, got {len(xs)}")
        for x, m in zip(xs, self.cfg.modalities):
            _check_width(x, m.arch["n_input"], m.name, "input")

        def call(ps):
            with torch.inference_mode():
                outs = self._call["transform"]([self._t(p) for p in ps])
            return tuple(o.cpu().numpy() for o in outs)

        return bucketing.chunked_multi_call(call, xs)

    def warmup(self, buckets: Sequence[int] = (64, 256, 1024), *,
               all_endpoints: bool = False) -> None:
        """Run each endpoint once per bucket (same contract as Predictor):
        CUDA's lazy module loading happens here, off the request threads."""
        bucketing.warmup_endpoints(
            self, self.cfg, buckets, all_endpoints=all_endpoints
        )


def main(argv=None) -> int:
    """CLI: write a serving artifact from a saved model directory.

        python -m vae_assoc_tpu_torch.export /path/to/model_dir out_dir \\
            [--device {cuda,cpu}]
    """
    import argparse

    p = argparse.ArgumentParser(prog="vae_assoc_tpu_torch.export",
                                description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("model_dir", help="save_model or save_params directory "
                                     "(model_config.json)")
    p.add_argument("out_dir", help="artifact directory to write")
    p.add_argument("--device", choices=_PLATFORMS, default="cuda",
                   help="device the endpoints are traced on; cuda without a "
                        "GPU fails (the artifact serves on either)")
    args = p.parse_args(argv)

    from vae_assoc_tpu_torch.serve import Predictor

    manifest = export_predictor(Predictor.load(args.model_dir, device=args.device),
                                args.out_dir)
    print(f"exported {len(manifest['endpoints'])} endpoints "
          f"(platforms={manifest['platforms']}) -> {args.out_dir}")
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
