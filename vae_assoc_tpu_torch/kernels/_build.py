"""Build the port's CUDA sources into one shared library and load it with ctypes.

Every ``csrc/*.cu`` file has a plain C interface, so ``nvcc`` builds them
into one library with no PyTorch headers. The build runs at first use, from
the sources in this package only, into ``kernels/build/<hash>/``
(``build/`` is git-ignored): one ``nvcc -c`` per source, all started
together, then one link. The hash covers the sources, the headers and the
command, so an edited file rebuilds and an unchanged one is loaded as it
is. ``BUILD_DIR`` moves under a cache directory with
``utils.compile_cache.enable_compile_cache``. A missing ``nvcc`` raises
when a build is needed: nothing falls back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
LIB_NAME = "libvae_assoc_kernels.so"

_lock = threading.Lock()
_lib = None


def sources() -> list:
    """Every CUDA source of the package, in a fixed order."""
    return sorted(CSRC.glob("*.cu"))


_ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
_FLAGS = ["-std=c++17", "-O3"]
_PIC = ["-Xcompiler", "-fPIC", "-Xptxas=-v"]


def nvcc_command(nvcc: str = "nvcc", out: str = LIB_NAME) -> list:
    """The one nvcc command line equivalent to the build of the library at
    ``out``; :func:`build` runs it as one compile per source and a link."""
    return [
        nvcc, *_ARCH, *_FLAGS, "-shared", *_PIC, "-o", str(out),
        *(str(s) for s in sources()),
    ]


def compile_command(nvcc: str, src: Path, obj: Path) -> list:
    """Compile one source to a relocatable object (the build's first step)."""
    return [nvcc, *_ARCH, *_FLAGS, *_PIC, "-c", "-o", str(obj), str(src)]


def link_command(nvcc: str, objs: list, out: Path) -> list:
    """Link the objects into the shared library (the build's second step)."""
    return [nvcc, *_ARCH, "-shared", "-o", str(out), *(str(o) for o in objs)]


def find_nvcc() -> str:
    """nvcc from CUDA_HOME / CUDA_PATH / PATH (torch's own lookup)."""
    from torch.utils.cpp_extension import CUDA_HOME

    for cand in (
        os.path.join(CUDA_HOME, "bin", "nvcc") if CUDA_HOME else None,
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found: set CUDA_HOME or put nvcc on PATH. The CUDA kernels "
        f"of vae_assoc_tpu_torch are built from {CSRC} at first use."
    )


def library_path() -> Path:
    """Where the library of these sources and this command lives:
    ``BUILD_DIR/<hash>/``. The hash names the command with the bare
    ``nvcc``, so it does not depend on where ``nvcc`` is found, or whether."""
    h = hashlib.sha256(" ".join(nvcc_command()).encode())
    for src in sources() + sorted(CSRC.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / h.hexdigest()[:16] / LIB_NAME


def build() -> Path:
    """Compile the library if this source hash has not been built; return it.

    A library that is built already is returned before ``nvcc`` is looked
    for, so it loads on a host without one. The compiler's output
    (``-Xptxas=-v``: registers and shared memory per kernel) is kept beside
    the library as ``build.log``, each source headed by the seconds from
    the start of the build to the end of its compile."""
    out = library_path()
    if out.exists():
        return out
    nvcc = find_nvcc()
    out.parent.mkdir(parents=True, exist_ok=True)
    tag = os.getpid()
    objs = [out.with_name(f"{s.stem}.{tag}.o") for s in sources()]
    t0 = time.perf_counter()
    outs = [out.with_name(f"{s.stem}.{tag}.log") for s in sources()]
    procs = []
    for s, o, log in zip(sources(), objs, outs):
        with open(log, "w") as f:
            procs.append(subprocess.Popen(compile_command(nvcc, s, o), stdout=f,
                                          stderr=subprocess.STDOUT))
    ended = {}
    while len(ended) < len(procs):  # each compile's wall time, as it ends
        for i, p in enumerate(procs):
            if i not in ended and p.poll() is not None:
                ended[i] = time.perf_counter() - t0
        time.sleep(0.05)
    logs = [(f"{s.name} ({ended[i]:.1f} s)", outs[i].read_text(), procs[i].returncode)
            for i, s in enumerate(sources())]
    for log in outs:
        log.unlink(missing_ok=True)
    tmp = out.with_name(f"{LIB_NAME}.{tag}.tmp")
    if all(rc == 0 for _, _, rc in logs):
        link = subprocess.run(link_command(nvcc, objs, tmp),
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True)
        logs.append((LIB_NAME, link.stdout, link.returncode))
    (out.parent / "build.log").write_text(
        "".join(f"== {name} (exit {rc})\n{text}" for name, text, rc in logs))
    for o in objs:
        o.unlink(missing_ok=True)
    failed = [(name, text, rc) for name, text, rc in logs if rc != 0]
    if failed:
        name, text, rc = failed[0]
        raise RuntimeError(f"nvcc failed on {name} with exit code {rc}:\n{text}")
    os.replace(tmp, out)
    return out


def load() -> ctypes.CDLL:
    """The built library with its C signatures declared (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            ptr, i32 = ctypes.c_void_p, ctypes.c_int
            lib.vae_mlp_stack_fwd.argtypes = [
                ptr, i32, i32, ptr, i32, i32, ptr, ptr, ptr, i32, i32, i32, i32, i32, ptr,
            ]
            lib.vae_mlp_stack_fwd.restype = i32
            u64 = ctypes.c_ulonglong
            lib.vae_mega_fwd.argtypes = [
                ptr, i32, ptr, ptr, i32, ptr, ptr, u64, ptr, ptr, ptr, ptr, ptr,
                ptr, i32, ptr, i32, i32, i32, i32, ptr,
            ]
            lib.vae_mega_dec_loss_bwd.argtypes = [
                ptr, ptr, ptr, i32, ptr, ptr, ptr, i32, ptr, i32, i32, i32, i32, ptr,
            ]
            lib.vae_mlp_enc_bwd.argtypes = [
                ptr, i32, i32, ptr, i32, ptr, ptr, i32, ptr, ptr, ptr, i32,
                i32, i32, i32, ptr,
            ]
            lib.vae_mlp_dec_bwd.argtypes = [
                ptr, i32, i32, ptr, i32, ptr, i32, ptr, ptr, i32, i32, i32,
                i32, ptr,
            ]
            lib.vae_wgrad.argtypes = [
                ptr, i32, ptr, i32, i32, i32, i32, i32, i32, ptr, ptr, ptr,
                i32, ptr,
            ]
            lib.vae_reparam.argtypes = [ptr, ptr, i32, i32, ptr, u64, ptr, ptr, ptr]
            lib.vae_empty.argtypes = [ptr]
            lib.vae_loss_fwd.argtypes = [ptr, i32, i32, i32, i32, ptr, ptr]
            lib.vae_loss_bwd.argtypes = [ptr, i32, i32, i32, i32, ptr, ptr]
            lib.vae_conv_fwd.argtypes = [
                ptr, i32, i32, i32, i32, ptr, i32, i32, ptr, i32, i32, i32,
                ptr, i32, ptr,
            ]
            lib.vae_conv_dw.argtypes = [
                ptr, i32, i32, i32, i32, ptr, i32, i32, ptr, i32, i32, i32,
                i32, i32, ptr, ptr, i32, ptr,
            ]
            lib.vae_conv_enc.argtypes = [
                ptr, i32, ptr, i32, i32, ptr, ptr, ptr, ptr, ptr, ptr, i32, i32,
                i32, ptr,
            ]
            lib.vae_conv_dec.argtypes = [
                ptr, ptr, i32, ptr, i32, i32, i32, ptr, ptr, ptr, ptr, ptr, ptr,
                ptr, i32, i32, ptr,
            ]
            lib.vae_lstm_fwd.argtypes = [
                ptr, i32, ptr, ptr, ptr, i32, i32, i32, i32, i32, i32, i32, ptr, ptr,
            ]
            lib.vae_lstm_bwd.argtypes = [
                ptr, i32, ptr, ptr, i32, i32, i32, i32, i32, i32, i32, ptr, ptr,
            ]
            lib.vae_lstm_plan.argtypes = [i32, i32, i32, i32, i32, ptr]
            lib.vae_lstm_sync_probe.argtypes = [ptr, i32, i32, i32, i32, ptr]
            lib.vae_mixture_loss.argtypes = [ptr, ptr, i32, i32, ptr, ptr, ptr]
            for fn in (lib.vae_mega_fwd, lib.vae_mega_dec_loss_bwd,
                       lib.vae_mlp_enc_bwd, lib.vae_mlp_dec_bwd, lib.vae_wgrad,
                       lib.vae_reparam, lib.vae_empty, lib.vae_loss_fwd, lib.vae_loss_bwd,
                       lib.vae_conv_fwd, lib.vae_conv_dw, lib.vae_conv_enc,
                       lib.vae_conv_dec, lib.vae_lstm_fwd, lib.vae_lstm_bwd,
                       lib.vae_lstm_plan, lib.vae_lstm_sync_probe, lib.vae_mixture_loss):
                fn.restype = i32
            lib.vae_cuda_error_string.argtypes = [i32]
            lib.vae_cuda_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if err != 0:
        msg = lib.vae_cuda_error_string(err).decode()
        raise RuntimeError(f"{what} failed: CUDA error {err} ({msg})")
