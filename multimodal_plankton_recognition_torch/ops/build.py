"""Build and load the package's CUDA kernels (``csrc/*.cu``).

Each source is compiled by ``nvcc`` for Hopper (``sm_90a``) into a shared
library with a plain C interface and loaded with ``ctypes`` — no PyTorch
headers, so a build takes seconds. Libraries land in ``_build/`` beside
``csrc/`` (listed in ``.gitignore``), named by a hash of the source, the
shared headers (``csrc/*.cuh``) and the flags, so a changed source rebuilds
and an unchanged one loads at once. The build happens at first use, never
at import; ``build_all`` starts one ``nvcc`` per source, all at once.

A source may build into several libraries, its translation units
(``UNITS``): the same file under other ``-D`` flags, so that the
instances of a kernel that many shapes need compile in parallel
(``csrc/attention_{fwd,bwd,block}.cu`` by range of head dims,
``csrc/ffn.cu`` by width). Each unit is a name of its own to ``build``,
``load`` and ``build_all``.

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
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")


#: the head dims of each attention library, (first, last, step): every
#: multiple of 8 up to 256, then (the head dims whose fragments the
#: kernels read where they use them) every multiple of 64 up to 512 and of
#: 128 up to 1,024. The first is the sources' own range, each other a unit
#: of its own
ATTENTION_RANGES = ((8, 64, 8), (72, 128, 8), (136, 192, 8), (200, 256, 8),
                    (320, 512, 64), (640, 1024, 128))


#: the sources built once per range of head dims: kernels 1 and 3, 2 and
#: 4, and the fused block (kernels 11-12) around kernels 1-2's device code
ATTENTION_WAYS = ("fwd", "bwd", "block")


def attention_unit(way: str, d: int) -> str:
    """The unit of ``csrc/attention_<way>.cu`` (way "fwd", "bwd" or
    "block") whose range holds head dim ``d``: ``attention_<way>`` for
    8-64, else ``attention_<way>_d<top of its range>``."""
    top = next(hi for _, hi, _ in ATTENTION_RANGES if d <= hi)
    return f"attention_{way}" + ("" if top == ATTENTION_RANGES[0][1]
                                 else f"_d{top}")


#: unit name -> (source under csrc/ without ``.cu``, its extra nvcc
#: flags); a name not listed is its own source with no extra flag. The
#: FFN source takes the widths up to 384 by default.
UNITS = {
    **{attention_unit(way, hi): (f"attention_{way}", (
        f"-DATTN_D_LO={lo}", f"-DATTN_D_HI={hi}", f"-DATTN_D_STEP={step}"))
       for way in ATTENTION_WAYS for lo, hi, step in ATTENTION_RANGES[1:]},
    "ffn_wide": ("ffn", ("-DFFN_WIDE=1",)),
}
#: seconds of each ``nvcc`` this process ran, by unit name
BUILD_SECONDS: Dict[str, float] = {}


def _unit(name: str):
    return UNITS.get(name, (name, ()))


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
    """Where unit ``name`` builds to: ``_build/<name>-<hash>.so``, the hash
    of its source, the shared headers and its flags."""
    source, flags = _unit(name)
    digest = hashlib.sha256((CSRC_DIR / f"{source}.cu").read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        digest.update(header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS + flags).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def build(name: str) -> Path:
    """Compile unit ``name`` (``csrc/<source>.cu`` under its flags) unless
    its hashed library exists. nvcc's output (ptxas register and spill
    counts) is kept beside the library as ``.log``, its seconds in
    ``BUILD_SECONDS``."""
    lib = library_path(name)
    if lib.exists():
        return lib
    source, flags = _unit(name)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [find_nvcc(), *NVCC_FLAGS, *flags, "-o", str(tmp),
           str(CSRC_DIR / f"{source}.cu")]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    BUILD_SECONDS[name] = time.perf_counter() - t0
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise KernelBuildError(
            f"nvcc failed on csrc/{source}.cu {' '.join(flags)} (exit "
            f"{proc.returncode}):\n{proc.stderr}{proc.stdout}")
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
    """Build (if needed) and load unit ``name``; one handle per process.
    Every source exports ``cuda_error_string``."""
    lib = ctypes.CDLL(str(build(name)))
    lib.cuda_error_string.argtypes = [ctypes.c_int]
    lib.cuda_error_string.restype = ctypes.c_char_p
    return lib


def check_launch(err: int, lib: ctypes.CDLL, name: str) -> None:
    """Raise if a kernel entry point returned a CUDA error code."""
    if err:
        raise RuntimeError(f"{name} launch failed: CUDA error {err} "
                           f"({lib.cuda_error_string(err).decode()})")
