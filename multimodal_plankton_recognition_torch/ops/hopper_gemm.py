"""The shared Hopper GEMM (``csrc/hopper_gemm.cuh``): its host-side rules
and tile choices, and its two kernels behind ``csrc/hopper_gemm.cu`` for
the card tests.

The main paths reach the same device code inside kernels 10
(``ops/ffn.py``), 11-12 (``ops/attention_block.py``), 13 and 16
(``ops/mbconv.py``); the wrappers here are not on any path.

* ``gemm_rows``: C (M, N) = bf16(A (M, K) · W + bias), A and W bf16, W
  (N, K) as ``nn.Linear`` holds it or (K, N) (``transposed``), f32
  accumulation, one rounding (``gemm_rows_reference``);
* ``gemm_sums``: the same C for W (K, N) without a bias, and per 64-row
  chunk the f32 column sums of C and C² from the GEMM's epilogue
  (kernel 13's expand and its BN1 statistics; ``gemm_sums_reference``);
* ``wgrad``: dW (N, K) = Gᵀ·X and db = Σ G over every row, f32, summed
  in row groups whose partials are added in index order
  (``wgrad_reference``).

Every matrix is row-major bf16 whose base is 16-byte aligned and whose row
stride is a multiple of 16 bytes (8 columns): TMA's rule, which
``check_rows`` enforces before any launch.

``gemm_route`` mirrors the header's choice of a row GEMM's column slice:
the weight slice resident in shared memory where it leaves 4 ring stages
(K up to 1,152 at 64 columns), else streamed through the ring beside A
(the same sums and rounding); ``kernel_gemm_route`` asks the library.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from . import build

__all__ = ["gemm_rows", "gemm_rows_reference", "gemm_sums",
           "gemm_sums_reference", "wgrad", "wgrad_reference", "check_rows",
           "wgrad_tile_boxes", "wgrad_groups", "sm_count", "gemm_stages",
           "gemm_route", "kernel_gemm_route", "BOX"]

BOX = 64  # bf16 columns of one TMA box (128 bytes, the swizzle span)
BF16 = torch.bfloat16
# csrc/hopper_gemm.cuh: a block's shared memory (the opt-in maximum), the
# bytes of one ring stage of A (128 rows x one box), the most stages
SMEM_MAX = 232448
_A_STAGE = 128 * BOX * 2
_MAX_STAGES = 6


def _boxes(n: int) -> int:
    return -(-n // BOX)


def gemm_stages(bn: int, k: int) -> int:
    """Ring stages beside a resident (bn, k) weight slice, its staging
    tiles, the alignment slack and the barriers (``gemm_stages`` in the
    header), at most 6."""
    left = (SMEM_MAX - bn * _boxes(k) * BOX * 2 - 2 * 64 * bn * 2 - 1024
            - 16 * _MAX_STAGES - 8)
    return min(int(left / _A_STAGE), _MAX_STAGES)  # C's truncation


def gemm_route(n: int, k: int) -> int:
    """The row GEMM's route for an (n, k) weight (``gemm_route`` in the
    header): the widest resident slice of 192, 128 or 64 columns that
    divides n (64 always) with 4 ring stages, as +columns; else the
    streamed slice, 128 columns where they divide n, else 64, as
    -columns; 0 where n or k is not a multiple of 8."""
    if n <= 0 or k <= 0 or n % 8 or k % 8:
        return 0
    for bn in (192, 128, 64):
        if (n % bn == 0 or bn == 64) and gemm_stages(bn, k) >= 4:
            return bn
    return -128 if n % 128 == 0 else -64


def kernel_gemm_route(n: int, k: int) -> int:
    """``gemm_route`` as the built library answers it (needs nvcc)."""
    return _lib().hopper_gemm_route(n, k)


def check_rows(t: torch.Tensor, what: str) -> None:
    """Raise unless ``t`` is a contiguous bf16 matrix TMA can read: base
    16-byte aligned, row stride a multiple of 16 bytes."""
    if t.dtype != BF16 or t.dim() != 2 or not t.is_contiguous():
        raise ValueError(f"{what} must be a contiguous 2-D bf16 matrix, got "
                         f"{tuple(t.shape)} {t.dtype}")
    if t.shape[1] % 8:
        raise ValueError(f"{what}: a row of {t.shape[1]} bf16 values is not "
                         f"a multiple of 16 bytes (TMA's row stride)")
    if t.data_ptr() % 16:
        raise ValueError(f"{what}: base not 16-byte aligned")


def wgrad_tile_boxes(k: int) -> int:
    """64-column boxes of dW a wgrad block owns (``wgrad_tj`` in the
    header): 3 where they divide K's boxes, else 2, 1 for K <= 64."""
    b = _boxes(k)
    return 1 if b == 1 else (3 if b % 3 == 0 else 2)


def wgrad_groups(rows: int, n: int, k: int, sms: int) -> int:
    """Row groups of a weight-gradient pass over an (n, k) weight: enough
    (64 × 64·TJ tile, row group) blocks for two per SM, at most one group
    per 64-row chunk. Each group holds one f32 partial of the weight (and
    its bias)."""
    tiles = _boxes(n) * -(-_boxes(k) // wgrad_tile_boxes(k))
    return max(1, min(-(-rows // 64), -(-2 * sms // tiles)))


def sm_count(device: torch.device) -> int:
    """The card's streaming multiprocessors (cached per card)."""
    index = torch.device(device).index
    return _sm_count(torch.cuda.current_device() if index is None else index)


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def gemm_rows_reference(a: torch.Tensor, w: torch.Tensor,
                        bias: Optional[torch.Tensor] = None,
                        transposed: bool = False) -> torch.Tensor:
    """Plain version of ``gemm_rows``: bf16(a · w (+ bias)) in f32."""
    wf = w.float() if transposed else w.float().t()
    out = a.float() @ wf
    if bias is not None:
        out = out + bias.float()
    return out.to(BF16)


def gemm_sums_reference(a: torch.Tensor, w: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of ``gemm_sums``: (c, sums) with c = bf16(a · w) for w
    (K, N), and sums (2, 2·ceil(M / 128), N) f32: each 64-row chunk's
    column sums of c and of c² (0 past M)."""
    c = gemm_rows_reference(a, w, None, True)
    m, n = c.shape
    chunks = 2 * -(-m // 128)
    cf = torch.zeros((chunks * 64, n), dtype=torch.float32, device=c.device)
    cf[:m] = c.float()
    cf = cf.reshape(chunks, 64, n)
    return c, torch.stack([cf.sum(1), (cf * cf).sum(1)])


def wgrad_reference(g: torch.Tensor, x: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of ``wgrad``: (gᵀ·x, Σ g over rows) in f32."""
    return g.float().t() @ x.float(), g.float().sum(0)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.load("hopper_gemm")
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.hopper_gemm_rows.argtypes = [vp, vp, ci, vp, vp, ci, ci, ci, vp]
    lib.hopper_gemm_rows.restype = ci
    lib.hopper_gemm_sums.argtypes = [vp, vp, vp, vp, ci, ci, ci, vp]
    lib.hopper_gemm_sums.restype = ci
    lib.hopper_wgrad.argtypes = [vp, vp, vp, ci, vp, vp, ci, ci, ci, vp]
    lib.hopper_wgrad.restype = ci
    lib.hopper_gemm_route.argtypes = [ci, ci]
    lib.hopper_gemm_route.restype = ci
    return lib


def _on_cpu(t: torch.Tensor) -> bool:
    if t.device.type == "cpu":
        return True
    if t.device.type != "cuda":
        raise ValueError(f"no GEMM kernel for device {t.device}")
    return False


def gemm_rows(a: torch.Tensor, w: torch.Tensor,
              bias: Optional[torch.Tensor] = None,
              transposed: bool = False) -> torch.Tensor:
    """``gemm_rows_kernel`` on CUDA, the plain version on the CPU: (M, N)
    bf16. ``gemm_rows.launches`` counts launches."""
    if _on_cpu(a):
        return gemm_rows_reference(a, w, bias, transposed)
    check_rows(a, "a")
    check_rows(w, "w")
    m, k = a.shape
    n = w.shape[1] if transposed else w.shape[0]
    if (w.shape[0] if transposed else w.shape[1]) != k:
        raise ValueError(f"w {tuple(w.shape)} does not fit a {tuple(a.shape)}")
    b = None if bias is None else bias.detach().float().contiguous()
    c = torch.empty((m, n), dtype=BF16, device=a.device)
    lib = _lib()
    with torch.cuda.device(a.device):
        err = lib.hopper_gemm_rows(
            a.data_ptr(), w.data_ptr(), int(transposed),
            None if b is None else b.data_ptr(), c.data_ptr(), m, n, k,
            torch.cuda.current_stream().cuda_stream)
    build.check_launch(err, lib, "hopper_gemm_rows")
    gemm_rows.launches += 1
    return c


def gemm_sums(a: torch.Tensor, w: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``gemm_rows_kernel`` with its column-sum epilogue on CUDA, the plain
    version on the CPU: (c (M, N) bf16, sums (2, 2·ceil(M / 128), N) f32)
    for w (K, N). ``gemm_sums.launches`` counts launches."""
    if _on_cpu(a):
        return gemm_sums_reference(a, w)
    check_rows(a, "a")
    check_rows(w, "w")
    m, k = a.shape
    n = w.shape[1]
    if w.shape[0] != k:
        raise ValueError(f"w {tuple(w.shape)} does not fit a {tuple(a.shape)}")
    c = torch.empty((m, n), dtype=BF16, device=a.device)
    sums = torch.empty((2, 2 * -(-m // 128), n), dtype=torch.float32,
                       device=a.device)
    lib = _lib()
    with torch.cuda.device(a.device):
        err = lib.hopper_gemm_sums(a.data_ptr(), w.data_ptr(), c.data_ptr(),
                                   sums.data_ptr(), m, n, k,
                                   torch.cuda.current_stream().cuda_stream)
    build.check_launch(err, lib, "hopper_gemm_sums")
    gemm_sums.launches += 1
    return c, sums


def wgrad(g: torch.Tensor, x: torch.Tensor,
          groups: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """``wgrad_kernel`` and its group sum on CUDA, the plain version on the
    CPU: (dw (N, K), db (N,)) f32. ``wgrad.launches`` counts launches."""
    if _on_cpu(g):
        return wgrad_reference(g, x)
    check_rows(g, "g")
    check_rows(x, "x")
    rows, n = g.shape
    k = x.shape[1]
    if x.shape[0] != rows:
        raise ValueError(f"g {tuple(g.shape)} and x {tuple(x.shape)} differ "
                         f"in rows")
    if groups is None:
        groups = wgrad_groups(rows, n, k, sm_count(g.device))
    f32 = functools.partial(torch.empty, dtype=torch.float32,
                            device=g.device)
    dw, db, part = f32((n, k)), f32(n), f32(groups * (n * k + n))
    lib = _lib()
    with torch.cuda.device(g.device):
        err = lib.hopper_wgrad(g.data_ptr(), x.data_ptr(), part.data_ptr(),
                               groups, dw.data_ptr(), db.data_ptr(), rows, n,
                               k, torch.cuda.current_stream().cuda_stream)
    build.check_launch(err, lib, "hopper_wgrad")
    wgrad.launches += 1
    return dw, db


gemm_rows.launches = 0
gemm_sums.launches = 0
wgrad.launches = 0
