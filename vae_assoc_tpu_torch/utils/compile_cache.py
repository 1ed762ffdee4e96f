"""Persistent build cache: a restarted process loads its native builds from disk.

Counterpart of vae_assoc_tpu/utils/compile_cache.py. The port compiles
nothing with XLA or Inductor; what it compiles at first use is the CUDA
kernel library (``kernels/_build.py``, one ``nvcc`` per source and a link)
and the UJI parser (``native/``, one ``g++``). The kernel build is the
port's cold start, most of a minute on the H100 machine, and a restarted
server pays it again unless the library comes from a cache directory.

:func:`enable_compile_cache` points both builds at subdirectories of one
directory, ``kernels/`` and ``native/``, each holding ``<hash>/`` entries
keyed on the sources and the command. An entry that exists is loaded as
it is, without the compiler: a warm cache starts a process on a host with
no ``nvcc``. Opt-in via ``--compile-cache DIR`` on the serving CLI.
"""
from __future__ import annotations

import os
from pathlib import Path

__all__ = ["enable_compile_cache"]


def enable_compile_cache(cache_dir: str | os.PathLike,
                         *, min_compile_time_secs: float = 0.0) -> str:
    """Build and load the kernel library and the UJI parser under
    ``cache_dir``.

    Creates the directory if needed. Call it before the first build of the
    process: a library that is loaded already from another directory
    stays loaded, so this raises ``RuntimeError`` naming it rather than
    doing nothing. ``min_compile_time_secs`` is kept for the reference's
    signature; the port caches every build, which is what the reference's
    default of 0 does.

    Returns the directory path (as str) for logging.
    """
    from vae_assoc_tpu_torch import native
    from vae_assoc_tpu_torch.kernels import _build

    path = os.fspath(cache_dir)
    os.makedirs(path, exist_ok=True)
    root = Path(path).resolve()
    builds = ((_build, root / "kernels"), (native, root / "native"))
    with _build._lock, native._lock:
        for mod, target in builds:
            loaded = mod._lib
            # A loaded library lives at BUILD_DIR/<hash>/<name>.
            if loaded is not None and Path(loaded._name).parent.parent != target:
                raise RuntimeError(
                    f"enable_compile_cache({path!r}) after {loaded._name} was "
                    "loaded: call it before the first build of the process")
        for mod, target in builds:
            mod.BUILD_DIR = target
    return path
