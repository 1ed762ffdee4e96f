"""Build the port's CUDA sources into one shared library and load it with ctypes.

Every ``csrc/*.cu`` file has a plain C interface, so ``nvcc`` builds them
into one library in seconds, with no PyTorch headers. The build runs at
first use, from the sources in this package only, into
``kernels/build/<hash>/`` (``build/`` is git-ignored); the hash covers the
sources and the command, so an edited source rebuilds and an unchanged one
is loaded as it is. A missing ``nvcc`` raises: nothing falls back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
LIB_NAME = "libvae_assoc_kernels.so"

_lock = threading.Lock()
_lib = None


def sources() -> list:
    """Every CUDA source of the package, in a fixed order."""
    return sorted(CSRC.glob("*.cu"))


def nvcc_command(nvcc: str = "nvcc", out: str = LIB_NAME) -> list:
    """The one nvcc command line that builds the library at ``out``."""
    return [
        nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
        "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v", "-o", str(out),
        *(str(s) for s in sources()),
    ]


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


def build() -> Path:
    """Compile the library if this source hash has not been built; return it.

    The compiler's output (``-Xptxas=-v``: registers and shared memory per
    kernel) is kept beside the library as ``build.log``."""
    nvcc = find_nvcc()
    h = hashlib.sha256(" ".join(nvcc_command()).encode())
    for src in sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    out = BUILD_DIR / h.hexdigest()[:16] / LIB_NAME
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{LIB_NAME}.{os.getpid()}.tmp")
    proc = subprocess.run(nvcc_command(nvcc, tmp), capture_output=True, text=True)
    (out.parent / "build.log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed with exit code {proc.returncode}:\n{proc.stderr}"
        )
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
                ptr, i32, i32, ptr, i32, i32, ptr, ptr, i32, i32, i32, ptr,
            ]
            lib.vae_mlp_stack_fwd.restype = i32
            lib.vae_cuda_error_string.argtypes = [i32]
            lib.vae_cuda_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if err != 0:
        msg = lib.vae_cuda_error_string(err).decode()
        raise RuntimeError(f"{what} failed: CUDA error {err} ({msg})")
