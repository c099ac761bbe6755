"""Build and load the package's CUDA kernels (``csrc/*.cu``).

Each source is compiled by ``nvcc`` for Hopper (``sm_90a``) into a shared
library with a plain C interface and loaded with ``ctypes`` — no PyTorch
headers, so a build takes seconds. Libraries land in ``_build/`` beside
``csrc/`` (listed in ``.gitignore``), named by a hash of the source, the
shared headers (``csrc/*.cuh``) and the flags, so a changed source rebuilds
and an unchanged one loads at once. The build happens at first use, never
at import; ``build_all`` starts one ``nvcc`` per source, all at once.

There is no fallback: a missing ``nvcc`` or a failed compile raises with
the compiler's output.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")


class KernelBuildError(RuntimeError):
    """nvcc is missing or refused a kernel source."""


def find_nvcc() -> str:
    """``nvcc`` on PATH, else under ``CUDA_HOME`` (as torch resolves it)."""
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME:
        candidate = Path(CUDA_HOME) / "bin" / "nvcc"
        if candidate.is_file():
            return str(candidate)
    raise KernelBuildError(
        "nvcc not found (not on PATH and no CUDA toolkit under CUDA_HOME); "
        "the port's CUDA kernels are built from csrc/ at first use")


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` builds to: ``_build/<name>-<hash>.so``."""
    digest = hashlib.sha256((CSRC_DIR / f"{name}.cu").read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        digest.update(header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless its hashed library exists. nvcc's
    output (ptxas register and spill counts) is kept beside the library
    as ``.log``."""
    lib = library_path(name)
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
           str(CSRC_DIR / f"{name}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise KernelBuildError(
            f"nvcc failed on csrc/{name}.cu (exit {proc.returncode}):\n"
            f"{proc.stderr}{proc.stdout}")
    lib.with_suffix(".log").write_text(proc.stderr + proc.stdout)
    os.replace(tmp, lib)  # atomic: a concurrent build never sees a torn file
    return lib


def build_all(names) -> Dict[str, Path]:
    """Build several sources in parallel (one ``nvcc`` each); raises the
    first failure after all have finished."""
    with ThreadPoolExecutor(max_workers=len(names)) as pool:
        futures = {name: pool.submit(build, name) for name in names}
    return {name: future.result() for name, future in futures.items()}


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``; one handle per
    process. Every source exports ``cuda_error_string``."""
    lib = ctypes.CDLL(str(build(name)))
    lib.cuda_error_string.argtypes = [ctypes.c_int]
    lib.cuda_error_string.restype = ctypes.c_char_p
    return lib


def check_launch(err: int, lib: ctypes.CDLL, name: str) -> None:
    """Raise if a kernel entry point returned a CUDA error code."""
    if err:
        raise RuntimeError(f"{name} launch failed: CUDA error {err} "
                           f"({lib.cuda_error_string(err).decode()})")
