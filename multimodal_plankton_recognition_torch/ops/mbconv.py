"""The stride-1 MBConv block core, forward and backward: expand 1×1 → BN1 →
SiLU → depthwise k×k → BN2 → SiLU → squeeze-excite → project 1×1, with
train-mode batch statistics.

Port of ``multimodal_plankton_recognition_tpu/ops/pallas/experimental/
mbconv.py``. Its four TPU kernels become hand-written Hopper kernels, all
on the shared Hopper GEMM's pieces (``csrc/hopper_gemm.cuh``: TMA,
``wgmma``):

* ``ka_fwd`` (``_ka_fwd_kernel``, kernel 13) and ``kb_fwd``
  (``_kb_fwd_kernel``, kernel 14) in ``csrc/mbconv_fwd.cu``: kernel 13's
  expand on the row GEMM (y1 stored once, its column sums from the
  GEMM's epilogue) and a depthwise pass that reads y1, kernel 14's
  projection on ``wgmma`` from the a2 boxes the squeeze stored, turned
  into a3 in place;
* ``kb_bwd`` (``_kb_bwd_kernel``, kernel 15) and ``ka_bwd``
  (``_ka_bwd_kernel``, kernel 16) in ``csrc/mbconv_bwd.cu``: kernel 15's
  passes recompute da3 on ``wgmma`` and its dwproj runs on the
  weight-gradient GEMM, kernel 16's three products (y1, dx, dwexp) on the
  GEMM.

So all four read rows of cin, mid and cout bf16 channels by TMA and
16-byte copies, in multiples of 8 channels. Other channel counts take the
padding route: each is rounded up to ``kernel_channels`` (the next
multiple of 8), the weights get zero rows and columns (``wexp``'s,
``wproj``'s; ``wdw``'s, ``g1``/``b1``'s, ``g2``/``b2``'s, ``be``'s and
``we``'s mid columns; ``wr``'s mid rows) and the statistics zero entries,
and an activation (x, and dy3 or dy2 in the backward) is copied into a
wider buffer only where its own channel count is not a multiple of 8;
outputs, statistics and gradients are sliced back. The padding is exact:
a padded mid channel has y1 = 0, m = v = 0, xhat = z = a1 = y2 = a2 = 0,
its se of 0.5 meets a zero a2, its da3, ds and dz2 are 0 (``wproj``'s and
``wr``'s padded rows are 0), and g = 0 on it gives dy = 0; a padded cin or
cout column meets zero weights. ``mbconv_core`` pads once per call
(``pad_mbconv``), so its backward reuses the padded weights; each wrapper
pads what it is given itself. ``ka_fwd_scratch``, ``kb_fwd_scratch`` and
``kb_bwd_scratch`` lay out the scratch that the wrappers hand them.

Depthwise sizes: every odd k from 1 to ``MAX_KERNEL_SIZE`` (11) on the
card (``KERNEL_SIZES``; up to 9 a thread holds its k² weights in
registers, at 11 it reads them where it uses them); a larger or an even k
is refused before any launch (``check_kernel_size``). Even k: the
reference's own plain version (``mbconv_reference``, and ``_depthwise``
here, ``padding=k // 2``) gives an output a row and a column larger than
the input, where JAX's kernel keeps H × W, so the two disagree; no
backbone uses one.

``*_reference`` are their plain PyTorch versions, with the bf16 rounding
points of ``mbconv_reference`` (``mbconv.py:771-818``): y1, z1, z2, su, sv
and se rounded, y2, y3 and a3 (and a1, a2, s) in bf16; the weight matrices
are used rounded to bf16, the BatchNorm scales and the SE biases in f32.
Each wrapper runs its plain version for a CPU tensor, its kernel for a
CUDA tensor, and raises otherwise; ``<wrapper>.launches`` counts kernel
launches.

``mbconv_core`` is the differentiable entry (a ``torch.autograd.Function``
whose backward runs kernels 15 and 16), with the JAX signature and layouts:
x (B, H, W, cin) bf16, wexp (cin, mid) or ``None`` (expand ratio 1), wdw
(k, k, mid) or (k, k, 1, mid), wr (mid, r), we (r, mid), wproj (mid,
cout). It returns (y3, m1, v1, m2, v2, m3, v3): the pre-BN3 projection
(bf16) and the biased batch mean and variance of every BN (f32; m1 / v1
are 0 / 1 without an expand). The gradients through m3 and v3 are folded
into d_y3 (``mbconv.py:743-745``); m1, v1, m2 and v2 feed only the running
statistics and get none.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from . import build, hopper_gemm
from .attention import _aligned

__all__ = ["mbconv_core", "ka_fwd", "kb_fwd", "kb_bwd", "ka_bwd",
           "kernel_channels", "check_kernel_size", "pad_mbconv",
           "unpad_mbconv_grads", "dw_tiles", "ka_fwd_scratch",
           "kb_fwd_scratch", "kb_bwd_scratch",
           "ka_fwd_reference", "kb_fwd_reference", "kb_bwd_reference",
           "ka_bwd_reference", "EPS", "KERNEL_SIZES", "MAX_KERNEL_SIZE"]

EPS = 1e-5  # flax.linen.BatchNorm's epsilon
BF16 = torch.bfloat16
#: the largest depthwise size the kernels take (kMaxK, csrc/mbconv.cuh):
#: kernel 16's depthwise pass keeps k² f32 partial sums of dwdw a thread
#: in registers (121 of 255 at k 11); shared memory is not the bound (two
#: halo buffers at k 11: 99 KB of 227)
MAX_KERNEL_SIZE = 11
#: the depthwise sizes the kernels are built for: every odd k up to it
KERNEL_SIZES = tuple(range(1, MAX_KERNEL_SIZE + 1, 2))


def _r(t: torch.Tensor) -> torch.Tensor:
    """Round through bf16, back to f32."""
    return t.to(BF16).float()


def _w(t: torch.Tensor) -> torch.Tensor:
    """A weight as the kernels read it: rounded to bf16, f32 math."""
    return _r(t.detach())


def _stats(y: torch.Tensor, dims) -> Tuple[torch.Tensor, torch.Tensor]:
    """Biased mean and E[y²] − mean² in f32 (no clamp, as the TPU kernel)."""
    m = y.mean(dims)
    return m, (y * y).mean(dims) - m * m


def _dsilu(z: torch.Tensor) -> torch.Tensor:
    s = torch.sigmoid(z)
    return s * (1.0 + z * (1.0 - s))


def _depthwise(a: torch.Tensor, wdw: torch.Tensor, k: int) -> torch.Tensor:
    """f32 'same' depthwise correlation of NHWC ``a`` with (k, k, C)."""
    c = a.shape[-1]
    w = wdw.permute(2, 0, 1).reshape(c, 1, k, k)
    out = F.conv2d(a.permute(0, 3, 1, 2), w, padding=k // 2, groups=c)
    return out.permute(0, 2, 3, 1)


def _bn_apply(y, m, v, g, b):
    """(xhat, inv, z) with z = bf16(xhat·g + b), xhat = (y − m)·inv."""
    inv = torch.rsqrt(v + EPS)
    xhat = (y - m) * inv
    return xhat, inv, _r(xhat * g.float() + b.float())


def _expand(x, wexp, g1, b1, m1=None, v1=None):
    """y1 = bf16(x @ wexp) (f32 accumulation), its statistics (unless
    given), and the BN1 apply."""
    y1 = _r(x.float() @ _w(wexp))
    if m1 is None:
        m1, v1 = _stats(y1, (0, 1, 2))
    xhat1, inv1, z1 = _bn_apply(y1, m1, v1, g1, b1)
    return y1, m1, v1, xhat1, inv1, z1


def ka_fwd_reference(x, wexp, g1, b1, wdw, k: int):
    """Plain version of kernel 13: (y2 bf16, m1, v1, m2, v2 f32)."""
    wdw = _w(wdw).reshape(k, k, -1)
    if wexp is not None:
        _, m1, v1, _, _, z1 = _expand(x, wexp, g1, b1)
        a1 = _r(F.silu(z1))
    else:
        a1 = x.float()
        m1 = torch.zeros(x.shape[-1], device=x.device)
        v1 = torch.ones(x.shape[-1], device=x.device)
    y2 = _depthwise(a1, wdw, k).to(BF16)
    m2, v2 = _stats(y2.float(), (0, 1, 2))
    return y2, m1, v1, m2, v2


def _se_chain(y2, g2, b2, m2, v2, wr, br, we, be):
    """The KB recompute: xhat2, inv2, z2, a2 and the SE values s, su, u,
    se (per sample)."""
    xhat2, inv2, z2 = _bn_apply(y2.float(), m2, v2, g2, b2)
    a2 = _r(F.silu(z2))
    s = _r(a2.mean((1, 2)))
    su = _r(s @ _w(wr) + br.float())
    u = F.silu(su)
    se = _r(torch.sigmoid(_r(_r(u) @ _w(we) + be.float())))
    return xhat2, inv2, z2, a2, s, su, u, se


def kb_fwd_reference(y2, g2, b2, m2, v2, wr, br, we, be, wproj):
    """Plain version of kernel 14: (y3 bf16, m3, v3 f32)."""
    _, _, _, a2, _, _, _, se = _se_chain(y2, g2, b2, m2, v2, wr, br, we, be)
    a3 = _r(a2 * se[:, None, None, :])
    y3 = (a3 @ _w(wproj)).to(BF16)
    m3, v3 = _stats(y3.float(), (0, 1, 2))
    return y3, m3, v3


def kb_bwd_reference(y2, dy3, g2, b2, m2, v2, wr, br, we, be, wproj):
    """Plain version of kernel 15: (dy2 bf16, dwproj, dwr, dbr, dwe, dbe,
    dg2, db2 f32), for the cotangent ``dy3`` of y3 (bf16)."""
    b, h, w, _ = y2.shape
    n = b * h * w
    xhat2, inv2, z2, a2, s, su, u, se = _se_chain(y2, g2, b2, m2, v2, wr,
                                                  br, we, be)
    a3 = _r(a2 * se[:, None, None, :])
    dy3f = dy3.float()
    da3 = dy3f @ _w(wproj).t()
    dse = (da3 * a2).sum((1, 2))
    dsv = dse * se * (1.0 - se)
    du = dsv @ _w(we).t()
    dsu = du * _dsilu(su)
    ds = dsu @ _w(wr).t()
    dz2 = (da3 * se[:, None, None, :] + (ds / (h * w))[:, None, None, :]) \
        * _dsilu(z2)
    db2 = dz2.sum((0, 1, 2))
    dg2 = (dz2 * xhat2).sum((0, 1, 2))
    dy2 = (g2.float() * inv2) * (dz2 - db2 / n - xhat2 * (dg2 / n))
    dwproj = a3.reshape(n, -1).t() @ dy3f.reshape(n, -1)
    return (dy2.to(BF16), dwproj, s.t() @ dsu, dsu.sum(0), _r(u).t() @ dsv,
            dsv.sum(0), dg2, db2)


def ka_bwd_reference(x, dy2, wexp, g1, b1, wdw, m1, v1, k: int):
    """Plain version of kernel 16: (dx bf16, dwexp, dg1, db1, dwdw (k, k,
    mid) f32); dwexp, dg1 and db1 are ``None`` without an expand."""
    b, h, w, _ = x.shape
    n = b * h * w
    p = k // 2
    wdw = _w(wdw).reshape(k, k, -1)
    if wexp is not None:
        _, _, _, xhat1, inv1, z1 = _expand(x, wexp, g1, b1, m1, v1)
        a1 = _r(F.silu(z1))
    else:
        a1 = x.float()
    dy2f = dy2.float()
    apad = F.pad(a1, (0, 0, p, p, p, p))
    dwdw = torch.stack([
        torch.stack([(apad[:, i:i + h, j:j + w] * dy2f).sum((0, 1, 2))
                     for j in range(k)]) for i in range(k)])
    da1 = _depthwise(dy2f, wdw.flip(0, 1), k)  # transposed stencil
    if wexp is None:
        return da1.to(BF16), None, None, None, dwdw
    dz1 = da1 * _dsilu(z1)
    db1 = dz1.sum((0, 1, 2))
    dg1 = (dz1 * xhat1).sum((0, 1, 2))
    dy1 = _r((g1.float() * inv1) * (dz1 - db1 / n - xhat1 * (dg1 / n)))
    dx = (dy1 @ _w(wexp).t()).to(BF16)
    dwexp = x.float().reshape(n, -1).t() @ dy1.reshape(n, -1)
    return dx, dwexp, dg1, db1, dwdw


# ---------------------------------------------------------------------------
# the kernels: csrc/mbconv_fwd.cu (13, 14) and csrc/mbconv_bwd.cu (15, 16)
# ---------------------------------------------------------------------------

def _declare(lib: ctypes.CDLL, name: str, n_ptr: int, n_int: int) -> None:
    """``name``(n_ptr pointers, n_int ints, stream) -> cudaError_t, and
    ``name_scratch``(the same ints) -> scratch bytes."""
    vp, ci = ctypes.c_void_p, ctypes.c_int
    fn = getattr(lib, name)
    fn.argtypes = [vp] * n_ptr + [ci] * n_int + [vp]
    fn.restype = ci
    size = getattr(lib, f"{name}_scratch")
    size.argtypes = [ci] * n_int
    size.restype = ctypes.c_longlong


@functools.cache
def _fwd_lib() -> ctypes.CDLL:
    lib = build.load("mbconv_fwd")
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.mbconv_ka_fwd.argtypes = [vp] * 11 + [ci] * 7 + [vp]
    lib.mbconv_ka_fwd.restype = ci
    lib.mbconv_kb_fwd.argtypes = [vp] * 18 + [ci] * 6 + [vp]
    lib.mbconv_kb_fwd.restype = ci
    return lib


@functools.cache
def _bwd_lib() -> ctypes.CDLL:
    lib = build.load("mbconv_bwd")
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.mbconv_kb_bwd.argtypes = [vp] * 22 + [ci] * 7 + [vp]
    lib.mbconv_kb_bwd.restype = ci
    _declare(lib, "mbconv_ka_bwd", 13, 8)
    return lib


def _on_cpu(x: torch.Tensor) -> bool:
    """True for a CPU tensor (plain version), False for CUDA (kernel)."""
    if x.device.type == "cpu":
        return True
    if x.device.type != "cuda":
        raise ValueError(f"no MBConv kernel for device {x.device}")
    return False


def _bf(t: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    return None if t is None else t.detach().to(BF16).contiguous()


def _f32(t: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    return None if t is None else t.detach().float().contiguous()


def kernel_channels(c: int) -> int:
    """The channel count the kernels run for ``c`` channels: the next
    multiple of 8 (a row of them is a multiple of 16 bytes, as TMA and the
    16-byte copies read it)."""
    return -(-c // 8) * 8


def check_kernel_size(k: int) -> None:
    """Raise before any launch unless kernels 13 and 16 are built for the
    depthwise size ``k`` (``KERNEL_SIZES``)."""
    if k in KERNEL_SIZES:
        return
    why = (f"an even k, where the reference's plain version pads k // 2 "
           f"on both sides and its output grows by a row and a column, "
           f"unlike JAX's kernel" if k % 2 == 0 and k > 0 else
           f"above MAX_KERNEL_SIZE={MAX_KERNEL_SIZE}: kernel 16 keeps k² "
           f"f32 partial sums of dwdw a thread in registers")
    raise ValueError(f"depthwise kernel size {k} is not one of "
                     f"{KERNEL_SIZES}: {why}")


def _zpad(t: Optional[torch.Tensor], shape) -> Optional[torch.Tensor]:
    """``t`` in the leading block of a zero tensor of ``shape`` (its own
    dtype and device); ``t`` itself where the shapes agree."""
    if t is None or tuple(t.shape) == tuple(shape):
        return t
    out = t.new_zeros(shape)
    out[tuple(slice(0, n) for n in t.shape)] = t
    return out


def _widen(x: torch.Tensor, c: int) -> torch.Tensor:
    """(B, H, W, C) ``x`` with its channels zero-padded to ``c``."""
    return _zpad(x, (*x.shape[:-1], c))


def _cut(t: Optional[torch.Tensor], shape) -> Optional[torch.Tensor]:
    """The leading ``shape`` block of ``t``, contiguous (``t`` itself where
    nothing is cut)."""
    if t is None or tuple(t.shape) == tuple(shape):
        return t
    return t[tuple(slice(0, n) for n in shape)].contiguous()


def pad_mbconv(x, wexp, g1, b1, wdw, g2, b2, wr, br, we, be, wproj,
               k: int):
    """``mbconv_core``'s operands in the kernels' widths: cin, mid and cout
    rounded up to ``kernel_channels``, zero-padded (module docstring);
    ``wdw`` as (k, k, mid). Tensors that need no padding come back as
    given; ``x`` and ``wexp`` (with g1 and b1) may be None."""
    mid, cout = wproj.shape
    cin = mid if wexp is None else wexp.shape[0]
    ci, mi, co = (kernel_channels(c) for c in (cin, mid, cout))
    return (None if x is None else _widen(x, ci), _zpad(wexp, (ci, mi)),
            _zpad(g1, (mi,)), _zpad(b1, (mi,)),
            _zpad(wdw.reshape(k, k, mid), (k, k, mi)), _zpad(g2, (mi,)),
            _zpad(b2, (mi,)), _zpad(wr, (mi, wr.shape[1])), br,
            _zpad(we, (we.shape[0], mi)), _zpad(be, (mi,)),
            _zpad(wproj, (mi, co)))


def unpad_mbconv_grads(grads, cin: int, mid: int, cout: int):
    """The backward's (dx, dwexp, dg1, db1, dwdw, dg2, db2, dwr, dbr, dwe,
    dbe, dwproj) in the kernels' widths cut back to cin, mid and cout, each
    contiguous (None stays None)."""
    dx, dwexp, dg1, db1, dwdw, dg2, db2, dwr, dbr, dwe, dbe, dwproj = grads
    return (_cut(dx, (*dx.shape[:-1], cin)), _cut(dwexp, (cin, mid)),
            _cut(dg1, (mid,)), _cut(db1, (mid,)),
            _cut(dwdw, (*dwdw.shape[:-1], mid)), _cut(dg2, (mid,)),
            _cut(db2, (mid,)), _cut(dwr, (mid, dwr.shape[1])), dbr,
            _cut(dwe, (dwe.shape[0], mid)), _cut(dbe, (mid,)),
            _cut(dwproj, (mid, cout)))


def _layout(sizes):
    """({name: (byte offset, bytes)}, total bytes): the parts back to back,
    each on a 256-byte boundary."""
    layout, offset = {}, 0
    for name, size in sizes.items():
        layout[name] = (offset, size)
        offset += -(-size // 256) * 256
    return layout, offset


def dw_tiles(b: int, h: int, w: int) -> int:
    """Tiles of the depthwise passes (kernels 13 and 16; ``dw_tile`` in
    ``csrc/mbconv.cuh``): 8 rows by W cut into the fewest column tiles of
    at most 32, per sample."""
    cols = -(-w // 32)
    tw = -(-w // cols)
    return b * -(-h // 8) * -(-w // tw)


def ka_fwd_scratch(b: int, h: int, w: int, mid: int, expand: bool):
    """Kernel 13's scratch: ({name: (byte offset, bytes)}, total bytes),
    each part on a 256-byte boundary: y1 (B·H·W, mid) bf16, stored once by
    the expand GEMM; that GEMM's column sums of y1 and y1² per 64-row
    chunk, (2, 2·ceil(B·H·W / 128), mid) f32 (y1 and these empty without an
    expand); the depthwise tiles' column sums of y2 and y2², (2,
    ``dw_tiles``, mid) f32; the first level of the reduction over either,
    (2, ceil(rows / 256), mid) f32."""
    chunks = 2 * -(-(b * h * w) // 128) if expand else 0
    tiles = dw_tiles(b, h, w)
    return _layout({"y1": b * h * w * mid * 2 if expand else 0,
                    "part1": 2 * chunks * mid * 4,
                    "part2": 2 * tiles * mid * 4,
                    "level": 2 * -(-max(chunks, tiles) // 256) * mid * 4})


def kb_fwd_scratch(b: int, h: int, w: int, mid: int, cout: int):
    """Kernel 14's scratch, laid out as ``ka_fwd_scratch``'s: a2 (B·H·W,
    mid) bf16, stored once by the squeeze for the projection; then f32:
    the squeeze's column sums of a2 per tile, (T, mid) for T =
    B·ceil(HW / 64) tiles of one sample each; those added per sample (B,
    mid; where a sample has more than 32 tiles); se (B, mid); the
    projection's column sums of y3 and y3² per tile (2, T, cout); the
    first level of their reduction (2, ceil(T / 256), cout)."""
    tiles = b * -(-(h * w) // 64)
    return _layout({"a2": b * h * w * mid * 2, "sq": tiles * mid * 4,
                    "sample": b * mid * 4, "se": b * mid * 4,
                    "part": 2 * tiles * cout * 4,
                    "level": 2 * -(-tiles // 256) * cout * 4})


def kb_bwd_scratch(b: int, h: int, w: int, mid: int, r: int, cout: int,
                   groups: int):
    """Kernel 15's scratch: ({name: (byte offset, bytes)}, total bytes),
    each part on a 256-byte boundary: the per-tile f32 column sums, 2 × T
    × mid for T = B·ceil(HW / 64) tiles (the first pass's sums of a2 and
    da3·a2, later the second pass's of dz2 and dz2·xhat2); per sample, f32:
    those sums added over the sample's tiles (2, B, mid), the SE values
    se, ds / HW, s and dsv (B, mid), and ub and dsu (B, r); bf16(a2·se)
    (B·H·W, mid) bf16, which dwproj reads; dwproj's f32 group partials
    (groups, mid·cout)."""
    tiles = b * -(-(h * w) // 64)
    return _layout({"part": 2 * tiles * mid * 4,
                    "sample": (6 * b * mid + 2 * b * r) * 4,
                    "a3": b * h * w * mid * 2,
                    "wpart": groups * mid * cout * 4})


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _call(lib: ctypes.CDLL, name: str, tensors, ints, device) -> None:
    """Allocate the entry point's scratch, call it on the current stream
    and raise on a CUDA error."""
    size = getattr(lib, f"{name}_scratch")(*ints)
    scratch = torch.empty(max(int(size), 1), dtype=torch.uint8,
                          device=device)
    err = getattr(lib, name)(*map(_ptr, tensors), _ptr(scratch), *ints,
                             torch.cuda.current_stream(device).cuda_stream)
    build.check_launch(err, lib, name)


def _check_x(x: torch.Tensor, what: str) -> None:
    if x.dim() != 4 or x.dtype != BF16:
        raise ValueError(f"{what} must be (B, H, W, C) bf16, got "
                         f"{tuple(x.shape)} {x.dtype}")


def _scratch_parts(layout, total, device):
    """One scratch allocation of ``total`` bytes and the address of each
    part of ``layout``; the tensor keeps them alive."""
    scratch = torch.empty(max(total, 1), dtype=torch.uint8, device=device)
    return scratch, [scratch.data_ptr() + o for o, _ in layout.values()]


def _aligned_rows(*channels: int) -> None:
    """The route's 16-byte rule: every channel count a kernel is handed is
    a multiple of 8 (the padding route made it so)."""
    assert all(c % 8 == 0 for c in channels), channels


def ka_fwd(x, wexp, g1, b1, wdw, k: int):
    """Kernel 13: the expand, BN1 statistics and apply, SiLU and the
    depthwise conv; (y2 bf16, m1, v1, m2, v2). Any cin and mid (the
    padding route). ``ka_fwd.launches``."""
    if _on_cpu(x):
        return ka_fwd_reference(x, wexp, g1, b1, wdw, k)
    _check_x(x, "x")
    check_kernel_size(k)
    cin = x.shape[-1]
    mid = cin if wexp is None else wexp.shape[1]
    ci, mi = kernel_channels(cin), kernel_channels(mid)
    y2, *stats = _ka_fwd(_widen(x, ci), _zpad(wexp, (ci, mi)),
                         _zpad(g1, (mi,)), _zpad(b1, (mi,)),
                         _zpad(wdw.reshape(k, k, mid), (k, k, mi)), k)
    return (_cut(y2, (*y2.shape[:-1], mid)),
            *(_cut(t, (mid,)) for t in stats))


def _ka_fwd(x, wexp, g1, b1, wdw, k: int):
    """Kernel 13 at channel counts that are multiples of 8."""
    b, h, w, cin = x.shape
    expand = wexp is not None
    mid = wexp.shape[1] if expand else cin
    _aligned_rows(cin, mid)
    device = x.device
    y2 = torch.empty((b, h, w, mid), dtype=BF16, device=device)
    stats = torch.empty((4, mid), dtype=torch.float32, device=device)
    if not expand:
        stats[0].zero_()
        stats[1].fill_(1.0)
    scratch, parts = _scratch_parts(
        *ka_fwd_scratch(b, h, w, mid, expand), device)
    tensors = (_aligned(x), _aligned(_bf(wexp)) if expand else None,
               _f32(g1), _f32(b1), _bf(wdw.reshape(k * k, mid)), y2, stats)
    lib = _fwd_lib()
    err = lib.mbconv_ka_fwd(*map(_ptr, tensors), *parts, b, h, w, cin, mid,
                            k, int(expand),
                            torch.cuda.current_stream(device).cuda_stream)
    build.check_launch(err, lib, "mbconv_ka_fwd")
    ka_fwd.launches += 1
    return y2, stats[0], stats[1], stats[2], stats[3]


def kb_fwd(y2, g2, b2, m2, v2, wr, br, we, be, wproj):
    """Kernel 14: BN2 + SiLU, squeeze-excite and the projection; (y3 bf16,
    m3, v3). Any mid and cout (the padding route). ``kb_fwd.launches``."""
    if _on_cpu(y2):
        return kb_fwd_reference(y2, g2, b2, m2, v2, wr, br, we, be, wproj)
    _check_x(y2, "y2")
    mid, cout = wproj.shape
    mi, co = kernel_channels(mid), kernel_channels(cout)
    y3, m3, v3 = _kb_fwd(_widen(y2, mi), *(_zpad(t, (mi,)) for t in (
        g2, b2, m2, v2)), _zpad(wr, (mi, wr.shape[1])), br,
        _zpad(we, (we.shape[0], mi)), _zpad(be, (mi,)),
        _zpad(wproj, (mi, co)))
    return (_cut(y3, (*y3.shape[:-1], cout)), _cut(m3, (cout,)),
            _cut(v3, (cout,)))


def _kb_fwd(y2, g2, b2, m2, v2, wr, br, we, be, wproj):
    """Kernel 14 at channel counts that are multiples of 8."""
    b, h, w, mid = y2.shape
    r, cout = wr.shape[1], wproj.shape[1]
    _aligned_rows(mid, cout)
    device = y2.device
    y3 = torch.empty((b, h, w, cout), dtype=BF16, device=device)
    stats = torch.empty((2, cout), dtype=torch.float32, device=device)
    scratch, parts = _scratch_parts(
        *kb_fwd_scratch(b, h, w, mid, cout), device)
    tensors = (_aligned(y2), _f32(g2), _f32(b2), _f32(m2), _f32(v2),
               _bf(wr), _f32(br), _bf(we),
               _f32(be), _aligned(_bf(wproj)), y3, stats)
    lib = _fwd_lib()
    stream = torch.cuda.current_stream(device).cuda_stream
    err = lib.mbconv_kb_fwd(*map(_ptr, tensors), *parts, b, h, w, mid, r,
                            cout, stream)
    build.check_launch(err, lib, "mbconv_kb_fwd")
    kb_fwd.launches += 1
    return y3, stats[0], stats[1]


def kb_bwd(y2, dy3, g2, b2, m2, v2, wr, br, we, be, wproj):
    """Kernel 15: (dy2 bf16, dwproj, dwr, dbr, dwe, dbe, dg2, db2). Any mid
    and cout (the padding route). ``kb_bwd.launches``."""
    if _on_cpu(y2):
        return kb_bwd_reference(y2, dy3, g2, b2, m2, v2, wr, br, we, be,
                                wproj)
    _check_x(y2, "y2")
    _check_x(dy3, "dy3")
    mid, cout = wproj.shape
    r = wr.shape[1]
    mi, co = kernel_channels(mid), kernel_channels(cout)
    dy2, dwproj, dwr, dbr, dwe, dbe, dg2, db2 = _kb_bwd(
        _widen(y2, mi), _widen(dy3, co), *(_zpad(t, (mi,)) for t in (
            g2, b2, m2, v2)), _zpad(wr, (mi, r)), br,
        _zpad(we, (we.shape[0], mi)), _zpad(be, (mi,)),
        _zpad(wproj, (mi, co)))
    return (_cut(dy2, (*dy2.shape[:-1], mid)), _cut(dwproj, (mid, cout)),
            _cut(dwr, (mid, r)), dbr, _cut(dwe, (r, mid)),
            *(_cut(t, (mid,)) for t in (dbe, dg2, db2)))


def _kb_bwd(y2, dy3, g2, b2, m2, v2, wr, br, we, be, wproj):
    """Kernel 15 at channel counts that are multiples of 8."""
    b, h, w, mid = y2.shape
    r, cout = wr.shape[1], wproj.shape[1]
    _aligned_rows(mid, cout)
    device = y2.device
    f32 = functools.partial(torch.empty, dtype=torch.float32, device=device)
    dy2 = torch.empty(y2.shape, dtype=BF16, device=device)
    outs = (f32((mid, cout)), f32((mid, r)), f32(r), f32((r, mid)),
            f32(mid), f32(mid), f32(mid))
    groups = hopper_gemm.wgrad_groups(b * h * w, mid, cout,
                                      hopper_gemm.sm_count(device))
    layout, total = kb_bwd_scratch(b, h, w, mid, r, cout, groups)
    scratch = torch.empty(total, dtype=torch.uint8, device=device)
    parts = [scratch.data_ptr() + offset for offset, _ in layout.values()]
    tensors = (_aligned(y2), _aligned(dy3), _f32(g2), _f32(b2),
               _f32(torch.stack([m2, v2])), _bf(wr), _f32(br), _bf(we),
               _f32(be), _aligned(_bf(wproj)), dy2, *outs)
    lib = _bwd_lib()
    err = lib.mbconv_kb_bwd(*map(_ptr, tensors), *parts, b, h, w, mid, r,
                            cout, groups,
                            torch.cuda.current_stream(device).cuda_stream)
    build.check_launch(err, lib, "mbconv_kb_bwd")
    kb_bwd.launches += 1
    return (dy2, *outs)


def ka_bwd(x, dy2, wexp, g1, b1, wdw, m1, v1, k: int):
    """Kernel 16: (dx bf16, dwexp, dg1, db1, dwdw (k, k, mid)); dwexp, dg1
    and db1 are ``None`` without an expand. Any cin and mid (the padding
    route). ``ka_bwd.launches``."""
    if _on_cpu(x):
        return ka_bwd_reference(x, dy2, wexp, g1, b1, wdw, m1, v1, k)
    _check_x(x, "x")
    _check_x(dy2, "dy2")
    check_kernel_size(k)
    cin, mid = x.shape[-1], dy2.shape[-1]
    ci, mi = kernel_channels(cin), kernel_channels(mid)
    dx, dwexp, dg1, db1, dwdw = _ka_bwd(
        _widen(x, ci), _widen(dy2, mi), _zpad(wexp, (ci, mi)),
        *(_zpad(t, (mi,)) for t in (g1, b1)),
        _zpad(wdw.reshape(k, k, mid), (k, k, mi)),
        *(_zpad(t, (mi,)) for t in (m1, v1)), k)
    return (_cut(dx, (*dx.shape[:-1], cin)), _cut(dwexp, (cin, mid)),
            _cut(dg1, (mid,)), _cut(db1, (mid,)), _cut(dwdw, (k, k, mid)))


def _ka_bwd(x, dy2, wexp, g1, b1, wdw, m1, v1, k: int):
    """Kernel 16 at channel counts that are multiples of 8."""
    b, h, w, cin = x.shape
    mid = dy2.shape[-1]
    _aligned_rows(cin, mid)
    f32 = functools.partial(torch.empty, dtype=torch.float32,
                            device=x.device)
    dx = torch.empty_like(x, memory_format=torch.contiguous_format)
    dwdw = f32((k, k, mid))
    dwexp = dg1 = db1 = mv1 = None
    groups = 0
    if wexp is not None:
        dwexp, dg1, db1 = f32((cin, mid)), f32(mid), f32(mid)
        mv1 = _f32(torch.stack([m1, v1]))
        wexp = _aligned(_bf(wexp))
        groups = hopper_gemm.wgrad_groups(b * h * w, cin, mid,
                                          hopper_gemm.sm_count(x.device))
    _call(_bwd_lib(), "mbconv_ka_bwd",
          (_aligned(x), _aligned(dy2), wexp, _f32(g1), _f32(b1),
           _bf(wdw.reshape(k * k, mid)), mv1, dx, dwexp, dwdw, dg1, db1),
          (b, h, w, cin, mid, k, int(wexp is not None), groups), x.device)
    ka_bwd.launches += 1
    return dx, dwexp, dg1, db1, dwdw


ka_fwd.launches = 0
kb_fwd.launches = 0
kb_bwd.launches = 0
ka_bwd.launches = 0


def _grad_as(g: Optional[torch.Tensor], like):
    """``g`` in the (shape, dtype) ``like`` of its parameter (None: no
    parameter, no gradient)."""
    return None if like is None else g.reshape(like[0]).to(like[1])


class _MBConvCore(torch.autograd.Function):
    """Forward: kernels 13 and 14; backward: the m3 / v3 fold, then
    kernels 15 and 16 (recomputing a1 and a3, as the TPU kernels do). On
    the card every operand is padded once (``pad_mbconv``) and kept so
    for the backward; outputs and gradients are cut back."""

    @staticmethod
    def forward(ctx, x, wexp, g1, b1, wdw, g2, b2, wr, br, we, be, wproj, k):
        ctx.x_dtype = x.dtype
        ctx.widths = (x.shape[-1], *wproj.shape)  # cin, mid, cout
        x = x.to(BF16)
        args = (x, wexp, g1, b1, wdw, g2, b2, wr, br, we, be, wproj)
        ctx.likes = [None if t is None else (t.shape, t.dtype)
                     for t in args[1:]]
        if not _on_cpu(x):
            check_kernel_size(k)
            args = pad_mbconv(*args, k)
        x, wexp, g1, b1, wdw, g2, b2, wr, br, we, be, wproj = args
        y2, m1, v1, m2, v2 = ka_fwd(x, wexp, g1, b1, wdw, k)
        y3, m3, v3 = kb_fwd(y2, g2, b2, m2, v2, wr, br, we, be, wproj)
        ctx.save_for_backward(x, y2, y3, wexp, g1, b1, wdw, g2, b2, wr, br,
                              we, be, wproj, m1, v1, m2, v2, m3)
        ctx.k = k
        cin, mid, cout = ctx.widths
        outs = (_cut(y3, (*y3.shape[:-1], cout)),
                *(_cut(t, (mid,)) for t in (m1, v1, m2, v2)),
                _cut(m3, (cout,)), _cut(v3, (cout,)))
        ctx.mark_non_differentiable(*outs[1:5])
        return outs

    @staticmethod
    def backward(ctx, dy3, _dm1, _dv1, _dm2, _dv2, dm3, dv3):
        (x, y2, y3, wexp, g1, b1, wdw, g2, b2, wr, br, we, be, wproj,
         m1, v1, m2, v2, m3) = ctx.saved_tensors
        cin, mid, cout = ctx.widths
        y3, m3 = y3[..., :cout], m3[:cout]
        n = y3.shape[0] * y3.shape[1] * y3.shape[2]
        d = dy3.float() if dy3 is not None else torch.zeros_like(
            y3, dtype=torch.float32)
        if dm3 is not None:
            d = d + dm3 / n
        if dv3 is not None:
            d = d + (y3.float() - m3) * (2.0 / n * dv3)
        dy2, dwproj, dwr, dbr, dwe, dbe, dg2, db2 = kb_bwd(
            y2, _widen(d.to(BF16), wproj.shape[1]), g2, b2, m2, v2, wr, br,
            we, be, wproj)
        dx, dwexp, dg1, db1, dwdw = ka_bwd(x, dy2, wexp, g1, b1, wdw, m1,
                                           v1, ctx.k)
        grads = unpad_mbconv_grads(
            (dx, dwexp, dg1, db1, dwdw, dg2, db2, dwr, dbr, dwe, dbe,
             dwproj), cin, mid, cout)
        return (grads[0].to(ctx.x_dtype),
                *map(_grad_as, grads[1:], ctx.likes), None)


def mbconv_core(x, wexp, g1, b1, wdw, g2, b2, wr, br, we, be, wproj,
                k: int = 3):
    """The fused stride-1 block core (``mbconv.py::mbconv_core``): (y3,
    m1, v1, m2, v2, m3, v3), differentiable in x and every weight."""
    return _MBConvCore.apply(x, wexp, g1, b1, wdw, g2, b2, wr, br, we, be,
                             wproj, k)
