"""The CUDA kernels on a card, against their plain versions: attention
forward (eval and train mode) and backward on packed q|k|v (kernels 1-2)
and on separate q, k, v (kernels 3-4), CLIP and SigLIP loss forward and
backward, the fused FFN (kernels 9-10), the MBConv kernels (13-16), the
fused attention block (kernels 11-12) and the Hopper GEMM they share.

Marked ``gpu``: each test skips without a CUDA card. On the card:

    python -m pytest -m gpu --noconftest tests/test_torch_cuda.py -q

Tolerances: 2e-2 on the bf16 attention output (both sides accumulate in f32
and round the output to bf16 — one bf16 step is 7.8e-3 between 1 and 2 —
but sum in another order, so an output can land one step apart); the
same reason, relative to the largest |dqkv|, 1e-2 for the backward; on
inputs whose every sum is exact (q = k = 0, v = ±1) the train-mode
forward must equal its plain version bit for bit, which pins the dropout
mask. CLIP: the loss to 1e-5 relative (f32 math on both sides), gradients
to 1e-2 of their largest value (rounded to the embedding dtype),
d logit_scale to 1e-3 relative, at one and several 16-row tiles (the
one-block backward) and 32-row tiles (the two-kernel one), the first
bucket past 16 rows, ragged widths and one bucket of
512 (the loss kernels have no bucket cap); a second call
and the backward recomputing the forward's statistics equal the first
call given them bit for bit; SigLIP the same (a bucket of 257 and 512,
widths above 512 at N <= 16, both sides of its tile choices), d
logit_bias like d logit_scale, also at scale 5 with bias ±30 where a
naive softplus would overflow; one profiled call of each SigLIP wrapper
shows one CUDA kernel for the forward and one or two for the backward.
The attention kernels are also held at the SigLIP card's shapes (ViT-S:
L 197, 6 heads of 64; profile: L 225, 4 heads of 32 with mask and
dropout 0.1). Kernels 3-4 share the device code of 1-2 and must equal them
bit for bit. The fused FFN: each output within 2e-2 of max(1, its largest
plain value) and 2e-3 relative L2 (both sides round the hidden through
bf16 at the same points but sum in another order, so a hidden unit can
land one bf16 step apart); on integer inputs with ReLU every sum is exact,
so the outputs must equal the plain ones bit for bit, which pins the
dropout mask. The attention block: y and dx within 2e-2 of max(1, their
largest plain value) and 2e-3 relative L2, the weight and bias gradients
within 1e-2 of their largest plain value (f32 sums over every row in
another order, from bf16 dqkv that can land a step apart); under identity
projections (q = k = 0, v = x = ±1, out the identity) y equals kernel 1's
output and dx kernel 2's dv bit for bit, which pins the shared mask.
Its GEMMs are also held at row counts that leave a ragged last tile (195
and 12,608 rows), kernel 11's kept q|k|v and o against the plain ones;
kernel 12 given them must equal kernel 12 rebuilding them, and a second
call the first, bit for bit.
The tensor-core forward (kernels 1 and 3) is also held at the edges of its
16-key and 128-row tiles and of its 256-key shared-memory chunk (L 15-17,
63-65, 128-129 and 577, every head dim, masked or not, eval and train),
with the exact-sum check there; a base 8 bytes off a 16-byte boundary and
a length above ``MAX_LENGTH`` raise before any launch. So is the
tensor-core backward (kernels 2 and 4), within ``BWD_TOL`` and a relative
L2 error of ``BWD_REL_L2_TOL``, kernel 4 and a second call bit for bit
equal to kernel 2, and an exact-sum check of dV (q = k = 0, v = ±1,
dO = ±1: dV is a sum of ±pd, exact in f32) that must agree bit for bit.
A launch the entry point refuses raises; L 4000 runs both directions.
The shared Hopper GEMM (``csrc/hopper_gemm.cuh``, through
``ops/hopper_gemm.py``) is held against torch.matmul in f32 at widths
that are multiples of 8 but not of 64: ``gemm_rows`` within one bf16 step
(both round one f32 sum, summed in another order), ``wgrad`` within 1e-5
of its largest value (times the square root of the rows), a second call
bit for bit equal to the first; a row of 20 bf16 values (40 bytes) is
refused on the host by the wrapper and by the C entry point. Its
column-sum epilogue (``gemm_sums``, kernel 13's expand) at ragged M and
N 24, 144 and 1152: c within one bf16 step, each 64-row chunk's sums
within 1e-5 of the largest |sum| of torch's sums over the same rounded
rows, a second call bit for bit. Kernels 9
and 10 are held at every width with F 2024 and a row count that is not a
multiple of 128, bf16 and f32 x, p 0 and 0.1 (kernel 9 also with ReLU),
and kernels 13-16 at
B0's eight stride-1 block shapes, a ragged 9 x 9 one (B 3) and (kernels
13-15) B 1, kernels 13-14 also at k 5 without an expand,
each at the FFN or MBConv tolerances and repeated bit for bit; kernels
13 and 16 refuse cin or mid, kernels 14 and 15 mid or cout, that is not
a multiple of 8 before any launch. The train driver
(``train.drivers.train_multi``) trains a small bf16 SigLIP card from
packed pairs on the card for 2 epochs through pinned batches, with the
SigLIP kernels' launches counted. A classifier's train step (a ViT, or a
profile transformer over 257 tokens with padding) runs its attention
through kernels 1 and 2 and its eval step through kernel 1; the kNN
index on the card predicts what the CPU's does. A resnet18 and an lstm_1
classifier's f32 step on the card matches the CPU's (no kernel of the
port); B0's fused blocks under ``remat`` launch kernels 13 and 14 twice
a block and give the no-remat gradients and running statistics bit for
bit.
"""

import pytest
import torch

from multimodal_plankton_recognition_torch.models.attention import (
    FusedSelfAttention,
)
from multimodal_plankton_recognition_torch.ops.attention import (
    SUPPORTED_HEAD_DIMS, mha, mha_bwd, mha_bwd_reference, mha_qkv,
    mha_qkv_bwd, mha_qkv_bwd_reference, mha_qkv_reference, mha_reference,
)
from multimodal_plankton_recognition_torch.ops import attention_block as ab
from multimodal_plankton_recognition_torch.ops.contrastive import (
    clip_bwd, clip_fwd, clip_loss_bwd_reference,
    clip_loss_fused, clip_loss_fused_reference, siglip_bwd, siglip_fwd,
    siglip_loss_bwd_reference, siglip_loss_fused,
    siglip_loss_fused_reference,
)

pytestmark = pytest.mark.gpu
TOL = 2e-2
# the forward at the tile edges, ||kernel - plain|| / ||plain||: on the
# H100 chip_smoke.py's forward rows (L 64-577) read at most 1e-4; a wrong
# 16-key tile or 256-key chunk moves it by orders of magnitude more
FWD_REL_L2_TOL = 1e-3
BWD_TOL = 1e-2
# the backward's ||kernel - plain|| / ||plain||: both sides round ds and pd
# to bf16 at the same points, so a wrong tile or chunk moves it by far more
BWD_REL_L2_TOL = 1e-2
SHAPES = [(1, 1, 1), (3, 33, 2), (2, 100, 5)]  # (B, L, heads)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _inputs(cuda, b, l, heads, d, masked, seed=0):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    qkv = torch.randn((b, l, 3 * heads * d), generator=gen, device=cuda)
    bias = None
    if masked:
        pad = torch.rand((b, l), generator=gen, device=cuda) < 0.3
        pad[:, 0] = False
        bias = torch.where(pad, -1e9, 0.0).to(torch.float32)
    return qkv.to(torch.bfloat16), bias


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("d", SUPPORTED_HEAD_DIMS)
@pytest.mark.parametrize("b,l,heads", SHAPES)
def test_kernel_matches_plain(cuda, b, l, heads, d, masked):
    qkv, bias = _inputs(cuda, b, l, heads, d, masked)
    before = mha_qkv.launches
    out = mha_qkv(qkv, bias, heads)
    assert mha_qkv.launches == before + 1
    ref = mha_qkv_reference(qkv, bias, heads)
    torch.cuda.synchronize()
    assert out.dtype == torch.bfloat16 and out.shape == ref.shape
    assert torch.isfinite(out).all()
    assert (out.float() - ref.float()).abs().max().item() <= TOL


def test_module_kernel_matches_plain_module(cuda):
    """The module on the card (kernel 1) against the same module on the
    CPU, where its core is kernel 1's plain version (``fused=False`` is
    flax's attention, with other rounding points)."""
    torch.manual_seed(0)
    fused = FusedSelfAttention(192, 8).to(torch.bfloat16)
    x = torch.randn((4, 225, 192)).to(torch.bfloat16)
    mask = torch.zeros((4, 225), dtype=torch.bool)
    mask[:, 150:] = True
    with torch.inference_mode():
        want = fused(x, mask)
        before = mha_qkv.launches
        got = fused.to(cuda)(x.to(cuda), mask.to(cuda))
    assert mha_qkv.launches == before + 1
    assert (got.float().cpu() - want.float()).abs().max().item() <= TOL


def test_refuses_what_the_kernel_does_not_take(cuda):
    qkv, _ = _inputs(cuda, 2, 9, 3, 16, False)
    with pytest.raises(TypeError, match="bf16"):
        mha_qkv(qkv.float(), None, 3)
    with pytest.raises(ValueError, match="contiguous"):
        mha_qkv(qkv.transpose(0, 1), None, 3)
    odd, _ = _inputs(cuda, 2, 9, 1, 40, False)
    with pytest.raises(ValueError, match="head dim 40"):
        mha_qkv(odd, None, 1)
    bad_bias = torch.zeros((2, 9), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="bias_rows"):
        mha_qkv(qkv, bad_bias, 3)


def test_launch_failure_raises(cuda):
    """A launch the entry point refuses (head dim 40, called through ctypes
    past the wrapper's checks: ``dispatch`` returns cudaErrorInvalidValue)
    raises in ``build.check_launch`` instead of returning garbage. Both
    directions stream the sequence through shared memory in chunks, so a
    long one (L 4000) runs and agrees with its plain version."""
    from multimodal_plankton_recognition_torch.ops import attention, build

    qkv, _ = _inputs(cuda, 1, 4000, 1, 64, False)
    out = mha_qkv(qkv, None, 1)
    assert (out.float() - mha_qkv_reference(qkv, None, 1).float()
            ).abs().max().item() <= TOL
    dout = torch.randn((1, 4000, 64), device=cuda).to(torch.bfloat16)
    got = mha_qkv_bwd(qkv, None, dout, 1)
    want = mha_qkv_bwd_reference(qkv, None, dout, 1)
    _bwd_close(got, want)

    odd = torch.zeros((1, 9, 120), dtype=torch.bfloat16, device=cuda)
    out = torch.empty_like(odd)
    scratch = attention.bwd_scratch(1, 9, 1, 0.0, cuda)
    lib = attention._bwd_lib()
    err = lib.mha_qkv_bwd_bf16(
        odd.data_ptr(), None, odd.data_ptr(), out.data_ptr(),
        scratch.data_ptr(), 1, 9, 1, 40, 1.0, 0, 0, 1.0,
        torch.cuda.current_stream().cuda_stream)
    with pytest.raises(RuntimeError, match="launch failed"):
        build.check_launch(err, lib, "attention_bwd")


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("d", SUPPORTED_HEAD_DIMS)
@pytest.mark.parametrize("b,l,heads", SHAPES)
def test_train_mode_kernel_matches_plain(cuda, b, l, heads, d, masked):
    qkv, bias = _inputs(cuda, b, l, heads, d, masked, seed=1)
    out = mha_qkv(qkv, bias, heads, 0.1, 4242)
    ref = mha_qkv_reference(qkv, bias, heads, 0.1, 4242)
    torch.cuda.synchronize()
    assert torch.isfinite(out).all()
    assert (out.float() - ref.float()).abs().max().item() <= TOL


@pytest.mark.parametrize("p", [0.1, 0.5])
@pytest.mark.parametrize("d", SUPPORTED_HEAD_DIMS)
def test_train_mode_mask_is_the_plain_mask(cuda, d, p):
    """q = k = 0 makes the softmax uniform and v = ±1 makes every P·V sum
    exact in f32, so kernel and plain version agree bit for bit iff their
    dropout masks do."""
    b, l, heads = 3, 100, 2
    qkv, bias = _inputs(cuda, b, l, heads, d, True, seed=2)
    e = heads * d
    qkv = torch.zeros_like(qkv)
    signs = torch.rand((b, l, e), device=cuda) < 0.5
    qkv[..., 2 * e:] = torch.where(signs, -1.0, 1.0).to(qkv.dtype)
    assert torch.equal(mha_qkv(qkv, bias, heads, p, 99),
                       mha_qkv_reference(qkv, bias, heads, p, 99))


@pytest.mark.parametrize("p", [0.0, 0.1])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("d", SUPPORTED_HEAD_DIMS)
@pytest.mark.parametrize("b,l,heads", SHAPES)
def test_bwd_kernel_matches_plain(cuda, b, l, heads, d, masked, p):
    qkv, bias = _inputs(cuda, b, l, heads, d, masked, seed=3)
    dout = torch.randn((b, l, heads * d), device=cuda).to(torch.bfloat16)
    before = mha_qkv_bwd.launches
    got = mha_qkv_bwd(qkv, bias, dout, heads, p, 17)
    assert mha_qkv_bwd.launches == before + 1
    want = mha_qkv_bwd_reference(qkv, bias, dout, heads, p, 17)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16 and got.shape == qkv.shape
    assert torch.isfinite(got).all()
    scale = max(want.float().abs().max().item(), 1.0)
    assert (got.float() - want.float()).abs().max().item() <= BWD_TOL * scale


def test_autograd_launches_both_attention_kernels(cuda):
    qkv, bias = _inputs(cuda, 2, 40, 4, 24, True)
    qkv.requires_grad_()
    fwd, bwd = mha_qkv.launches, mha_qkv_bwd.launches
    out = mha_qkv(qkv, bias, 4, 0.1, 5)
    out.float().square().sum().backward()
    assert (mha_qkv.launches, mha_qkv_bwd.launches) == (fwd + 1, bwd + 1)
    want = mha_qkv_bwd_reference(qkv.detach(), bias, 2 * out.detach(), 4,
                                 0.1, 5)
    scale = want.float().abs().max().item()
    assert (qkv.grad.float() - want.float()).abs().max().item() \
        <= BWD_TOL * scale


def test_bwd_refuses_unsupported_head_dim(cuda):
    odd, _ = _inputs(cuda, 2, 9, 1, 40, False)
    with pytest.raises(ValueError, match="head dim 40"):
        mha_qkv_bwd(odd, None, odd[..., :40].contiguous(), 1)


# ------------------ forward kernels 1 and 3: the tile edges ------------------
# lengths at the edges of the forward's 16-key tiles, its 16-row warp
# tiles and 128-row block tiles, and its 256-key shared-memory chunks (577:
# three chunks, a ViT at 384 px)
EDGE_LENGTHS = [15, 16, 17, 63, 64, 65, 128, 129, 577]


@pytest.mark.parametrize("p", [0.0, 0.1])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("d", SUPPORTED_HEAD_DIMS)
@pytest.mark.parametrize("l", EDGE_LENGTHS)
def test_forward_at_the_tile_edges(cuda, l, d, masked, p):
    """Kernels 1 and 3 against their plain versions, and kernel 3 bit for
    bit against kernel 1 on the same operands."""
    b, heads = 2, 2
    qkv, bias = _inputs(cuda, b, l, heads, d, masked, seed=l + d)
    before = mha_qkv.launches, mha.launches
    out = mha_qkv(qkv, bias, heads, p, 53)
    sep = mha(*_separate(qkv), bias, heads, p, 53)
    assert (mha_qkv.launches, mha.launches) == (before[0] + 1,
                                                before[1] + 1)
    ref = mha_qkv_reference(qkv, bias, heads, p, 53)
    torch.cuda.synchronize()
    assert out.dtype == torch.bfloat16 and out.shape == ref.shape
    assert torch.isfinite(out).all()
    assert (out.float() - ref.float()).abs().max().item() <= TOL
    rel_l2 = (out.float() - ref.float()).norm() / ref.float().norm()
    assert rel_l2.item() <= FWD_REL_L2_TOL
    assert torch.equal(sep, out)


@pytest.mark.parametrize("l", [17, 65, 129, 577])
@pytest.mark.parametrize("d", SUPPORTED_HEAD_DIMS)
def test_forward_mask_at_the_tile_edges(cuda, d, l):
    """The exact-sum check (q = k = 0, v = ±1: must be 0) of kernels 1 and
    3 at the edges, one chunk and three."""
    b, heads = 2, 2
    _, bias = _inputs(cuda, b, l, heads, d, True, seed=3)
    e = heads * d
    qkv = torch.zeros((b, l, 3 * e), dtype=torch.bfloat16, device=cuda)
    signs = torch.rand((b, l, e), device=cuda) < 0.5
    qkv[..., 2 * e:] = torch.where(signs, -1.0, 1.0).to(qkv.dtype)
    want = mha_qkv_reference(qkv, bias, heads, 0.1, 61)
    assert torch.equal(mha_qkv(qkv, bias, heads, 0.1, 61), want)
    assert torch.equal(mha(*_separate(qkv), bias, heads, 0.1, 61), want)


def _bwd_close(got, want):
    """The backward's error bounds: within ``BWD_TOL`` of max(1, the
    largest plain value), and a relative L2 error of ``BWD_REL_L2_TOL``."""
    assert torch.isfinite(got.float()).all()
    scale = max(want.float().abs().max().item(), 1.0)
    assert (got.float() - want.float()).abs().max().item() <= BWD_TOL * scale
    rel_l2 = (got.float() - want.float()).norm() / want.float().norm()
    assert rel_l2.item() <= BWD_REL_L2_TOL


# ---------------- backward kernels 2 and 4: the tile edges -------------------
@pytest.mark.parametrize("p", [0.0, 0.1])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("d", SUPPORTED_HEAD_DIMS)
@pytest.mark.parametrize("l", EDGE_LENGTHS)
def test_backward_at_the_tile_edges(cuda, l, d, masked, p):
    """Kernel 2 against its plain version at the edges of its 16-row tiles,
    128-row blocks and 256-row chunks (the query side's keys, the key
    side's queries); kernel 4 bit for bit against kernel 2 on the same
    operands; a second call bit for bit against the first (no atomics)."""
    b, heads = 2, 2
    qkv, bias = _inputs(cuda, b, l, heads, d, masked, seed=l + d + 1)
    dout = torch.randn((b, l, heads * d), device=cuda).to(torch.bfloat16)
    before = mha_qkv_bwd.launches, mha_bwd.launches
    got = mha_qkv_bwd(qkv, bias, dout, heads, p, 71)
    sep = mha_bwd(*_separate(qkv), bias, dout, heads, p, 71)
    assert (mha_qkv_bwd.launches, mha_bwd.launches) == (before[0] + 1,
                                                        before[1] + 1)
    want = mha_qkv_bwd_reference(qkv, bias, dout, heads, p, 71)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    _bwd_close(got, want)
    assert torch.equal(torch.cat(sep, dim=-1), got)
    assert torch.equal(mha_qkv_bwd(qkv, bias, dout, heads, p, 71), got)


def _exact_sum_operands(cuda, b, l, heads, d, seed):
    """q = k = 0, v = ±1 and dO = ±1: p is uniform over the unmasked keys,
    pd is 0 or one bf16 constant, and dV, a sum of ±pd, is exact in f32."""
    _, bias = _inputs(cuda, b, l, heads, d, True, seed=seed)
    e = heads * d
    qkv = torch.zeros((b, l, 3 * e), dtype=torch.bfloat16, device=cuda)
    signs = torch.rand((b, l, 2 * e), device=cuda) < 0.5
    pm = torch.where(signs, -1.0, 1.0).to(torch.bfloat16)
    qkv[..., 2 * e:] = pm[..., :e]
    return qkv, bias, pm[..., e:].contiguous()


@pytest.mark.parametrize("p", [0.1, 0.5])
@pytest.mark.parametrize("d", SUPPORTED_HEAD_DIMS)
@pytest.mark.parametrize("l", [17, 129, 577])
def test_backward_mask_is_the_plain_mask(cuda, l, d, p):
    """On the exact-sum operands dV of kernels 2 and 4 equals the plain
    version's bit for bit iff their dropout masks agree."""
    b, heads = 2, 2
    qkv, bias, dout = _exact_sum_operands(cuda, b, l, heads, d, seed=l)
    e = heads * d
    want = mha_qkv_bwd_reference(qkv, bias, dout, heads, p, 83)[..., 2 * e:]
    got = mha_qkv_bwd(qkv, bias, dout, heads, p, 83)[..., 2 * e:]
    assert torch.equal(got, want)
    dv = mha_bwd(*_separate(qkv), bias, dout, heads, p, 83)[2]
    assert torch.equal(dv, want)


def test_forward_refuses_a_misaligned_base(cuda):
    """The kernels copy 16 bytes a thread: a base 8 bytes off a 16-byte
    boundary raises before any launch, on both routes."""
    b, l, heads, d = 2, 33, 2, 16
    n = b * l * 3 * heads * d
    flat = torch.zeros(n + 8, dtype=torch.bfloat16, device=cuda)
    qkv = flat[4:4 + n].view(b, l, 3 * heads * d)
    assert qkv.is_contiguous() and qkv.data_ptr() % 16 == 8
    before = mha_qkv.launches, mha.launches
    with pytest.raises(ValueError, match="16-byte aligned"):
        mha_qkv(qkv, None, heads)
    q = flat[4:4 + b * l * heads * d].view(b, l, heads * d)
    k = torch.zeros_like(q)
    with pytest.raises(ValueError, match="16-byte aligned"):
        mha(q, k, k, None, heads)
    assert (mha_qkv.launches, mha.launches) == before


def test_forward_refuses_a_length_above_the_limit(cuda):
    """Above ``MAX_LENGTH`` the wrapper raises before the launch and names
    the limit."""
    from multimodal_plankton_recognition_torch.ops.attention import (
        MAX_LENGTH,
    )

    qkv = torch.zeros((1, MAX_LENGTH + 1, 24), dtype=torch.bfloat16,
                      device=cuda)
    before = mha_qkv.launches
    with pytest.raises(ValueError, match=f"MAX_LENGTH={MAX_LENGTH}"):
        mha_qkv(qkv, None, 1)
    assert mha_qkv.launches == before


def _embeddings(cuda, rows, d, dtype, seed=0):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    return [torch.randn((rows, d), generator=gen, device=cuda).to(dtype)
            for _ in range(2)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("buckets,n,d", [(1, 1, 8), (4, 16, 512),
                                         (16, 16, 512), (1, 64, 512),
                                         (1, 256, 512), (1, 512, 512),
                                         (3, 17, 40), (2, 100, 33),
                                         (1, 300, 40), (2, 16, 640),
                                         (1, 16, 1000), (1, 12, 603)])
def test_clip_kernels_match_plain(cuda, buckets, n, d, dtype):
    img, prof = _embeddings(cuda, buckets * n, d, dtype)
    scale = torch.full((), 0.7, device=cuda)
    g = torch.full((), 1.3, device=cuda)
    before = clip_fwd.launches, clip_bwd.launches
    loss = clip_fwd(img, prof, scale, buckets)
    grads = clip_bwd(img, prof, scale, g, buckets)
    assert (clip_fwd.launches, clip_bwd.launches) == (before[0] + 1,
                                                      before[1] + 1)
    want = clip_loss_fused_reference(img, prof, scale, buckets)
    want_grads = clip_loss_bwd_reference(img, prof, scale, g, buckets)
    again = (clip_fwd(img, prof, scale, buckets),
             clip_bwd(img, prof, scale, g, buckets))
    torch.cuda.synchronize()
    assert torch.equal(again[0], loss)
    assert all(map(torch.equal, again[1], grads))
    # absolute floors: a bucket of one row has loss and gradients 0
    assert abs(loss.item() - want.item()) <= 1e-5 * max(abs(want.item()), 1)
    for got, ref in zip(grads[:2], want_grads[:2]):
        assert got.dtype == dtype and torch.isfinite(got).all()
        top = ref.float().abs().max().item()
        assert (got.float() - ref.float()).abs().max().item() \
            <= 1e-2 * top + 1e-7
    assert abs(grads[2].item() - want_grads[2].item()) \
        <= 1e-3 * abs(want_grads[2].item()) + 1e-7


def test_clip_autograd_launches_both_kernels(cuda):
    img, prof = _embeddings(cuda, 64, 32, torch.bfloat16, seed=1)
    leaves = [t.requires_grad_() for t in (img, prof)]
    scale = torch.zeros((), device=cuda, requires_grad=True)
    before = clip_fwd.launches, clip_bwd.launches
    clip_loss_fused(*leaves, scale, 4).backward()
    assert (clip_fwd.launches, clip_bwd.launches) == (before[0] + 1,
                                                      before[1] + 1)
    assert all(t.grad is not None for t in (*leaves, scale))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("buckets,n,d", [(16, 16, 512), (2, 20, 512),
                                         (1, 256, 512), (2, 100, 33),
                                         (2, 16, 640), (1, 16, 1000),
                                         (1, 12, 603)])
def test_clip_saved_statistics_give_the_same_gradients(cuda, buckets, n, d,
                                                       dtype):
    """The backward given the forward's statistics (the autograd path)
    equals the backward recomputing them, bit for bit, and autograd
    through ``clip_loss_fused`` equals both."""
    img, prof = _embeddings(cuda, buckets * n, d, dtype, seed=2)
    scale = torch.full((), 0.7, device=cuda)
    g = torch.ones((), device=cuda)
    loss, stats = clip_fwd(img, prof, scale, buckets, keep=True)
    assert stats.shape == (4, buckets * n) and torch.isfinite(stats).all()
    given = clip_bwd(img, prof, scale, g, buckets, stats)
    recomputing = clip_bwd(img, prof, scale, g, buckets)
    leaves = [t.clone().requires_grad_() for t in (img, prof, scale)]
    clip_loss_fused(*leaves, buckets).backward()
    torch.cuda.synchronize()
    assert all(map(torch.equal, given, recomputing))
    assert all(torch.equal(a, t.grad) for a, t in zip(given, leaves))


@pytest.mark.parametrize("tile", [16, 32])
@pytest.mark.parametrize("buckets,n,d", [(4, 16, 512), (1, 40, 512),
                                         (1, 64, 33)])
def test_clip_forward_takes_either_tile(cuda, monkeypatch, buckets, n, d,
                                        tile):
    """The forward kernel on 16- or 32-row tiles at any N (the wrapper
    chooses by N; ``--kernel-profile`` times the other choice) agrees with
    the plain version, statistics included."""
    from multimodal_plankton_recognition_torch.ops import contrastive

    img, prof = _embeddings(cuda, buckets * n, d, torch.bfloat16, seed=4)
    scale = torch.full((), 0.7, device=cuda)
    monkeypatch.setattr(contrastive, "clip_fwd_tile", lambda _n: tile)
    loss, stats = clip_fwd(img, prof, scale, buckets, keep=True)
    want, want_stats = clip_loss_fused_reference(img, prof, scale, buckets,
                                                 keep=True)
    torch.cuda.synchronize()
    assert abs(loss.item() - want.item()) <= 1e-5 * abs(want.item())
    torch.testing.assert_close(stats, want_stats, rtol=1e-5, atol=1e-5)


def test_clip_takes_a_bucket_of_257(cuda):
    """One row past the old 256-row cap: the CLIP kernels take it (a
    ragged last 32-row tile) and agree with the plain versions."""
    img, prof = _embeddings(cuda, 257, 16, torch.bfloat16, seed=3)
    scale = torch.zeros((), device=cuda)
    g = torch.ones((), device=cuda)
    loss = clip_fwd(img, prof, scale, 1)
    grads = clip_bwd(img, prof, scale, g, 1)
    want = clip_loss_fused_reference(img, prof, scale, 1)
    want_grads = clip_loss_bwd_reference(img, prof, scale, g, 1)
    torch.cuda.synchronize()
    assert abs(loss.item() - want.item()) <= 1e-5 * abs(want.item())
    top = max(r.float().abs().max().item() for r in want_grads[:2])
    for got, ref in zip(grads[:2], want_grads[:2]):
        assert (got.float() - ref.float()).abs().max().item() <= 1e-2 * top


SIGLIP_SCALARS = [(0.7, -10.0), (5.0, 30.0), (5.0, -30.0)]


def _siglip_close(loss, grads, want, want_grads, dtype):
    assert torch.isfinite(loss)
    assert abs(loss.item() - want.item()) <= 1e-5 * max(abs(want.item()), 1)
    _siglip_grads_close(grads, want_grads, dtype)


def _siglip_grads_close(grads, want_grads, dtype):
    for got, ref in zip(grads[:2], want_grads[:2]):
        assert got.dtype == dtype and torch.isfinite(got).all()
        top = ref.float().abs().max().item()
        assert (got.float() - ref.float()).abs().max().item() \
            <= 1e-2 * top + 1e-7
    for got, ref in zip(grads[2:], want_grads[2:]):
        assert got.shape == () and got.dtype == torch.float32
        assert torch.isfinite(got)
        assert abs(got.item() - ref.item()) <= 1e-3 * abs(ref.item()) + 1e-7


@pytest.mark.parametrize("scale_bias", SIGLIP_SCALARS,
                         ids=["init", "bias+30", "bias-30"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("buckets,n,d", [(1, 1, 8), (4, 16, 512),
                                         (16, 16, 512), (1, 17, 512),
                                         (1, 64, 512), (1, 256, 512),
                                         (1, 257, 512), (1, 512, 512),
                                         (2, 100, 33), (3, 9, 40),
                                         (2, 16, 640), (1, 16, 1000),
                                         (1, 12, 603)])
def test_siglip_kernels_match_plain(cuda, buckets, n, d, dtype, scale_bias):
    """Both kernels against their plain versions: one bucket of 16 rows or
    fewer (the one-block backward, its ring streamed again at D > 512),
    above that the two-kernel backward, no cap on N; one launch count per
    call, and a second call equal to the first bit for bit."""
    img, prof = _embeddings(cuda, buckets * n, d, dtype)
    scale = torch.full((), scale_bias[0], device=cuda)
    bias = torch.full((), scale_bias[1], device=cuda)
    g = torch.full((), 1.3, device=cuda)
    before = siglip_fwd.launches, siglip_bwd.launches
    loss = siglip_fwd(img, prof, scale, bias, buckets)
    grads = siglip_bwd(img, prof, scale, bias, g, buckets)
    assert (siglip_fwd.launches, siglip_bwd.launches) == (before[0] + 1,
                                                          before[1] + 1)
    want = siglip_loss_fused_reference(img, prof, scale, bias, buckets)
    want_grads = siglip_loss_bwd_reference(img, prof, scale, bias, g,
                                           buckets)
    again = (siglip_fwd(img, prof, scale, bias, buckets),
             siglip_bwd(img, prof, scale, bias, g, buckets))
    torch.cuda.synchronize()
    assert torch.equal(again[0], loss)
    assert all(map(torch.equal, again[1], grads))
    _siglip_close(loss, grads, want, want_grads, dtype)


@pytest.mark.parametrize("n", [16, 64])
def test_siglip_launches_per_call(cuda, n):
    """One profiled call of each wrapper: one CUDA kernel for the forward,
    one (a bucket of 16 rows) or two (above) for the backward, and no
    PyTorch kernel in either."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    img, prof = _embeddings(cuda, 4 * n, 512, torch.bfloat16, seed=6)
    scale = torch.zeros((), device=cuda)
    bias = torch.full((), -10.0, device=cuda)
    g = torch.ones((), device=cuda)
    calls = {"fwd": lambda: siglip_fwd(img, prof, scale, bias, 4),
             "bwd": lambda: siglip_bwd(img, prof, scale, bias, g, 4)}
    for what, call in calls.items():
        call()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as p:
            call()
            torch.cuda.synchronize()
        kernels = {e.key: e.count for e in p.key_averages()
                   if e.device_type == DeviceType.CUDA}
        want = 1 if what == "fwd" or n <= 16 else 2
        assert sum(kernels.values()) == want, kernels
        assert all("siglip_" in k for k in kernels), kernels


@pytest.mark.parametrize("tile", [16, 32])
@pytest.mark.parametrize("buckets,n,d", [(4, 16, 512), (1, 40, 512),
                                         (1, 300, 33)])
def test_siglip_forward_takes_either_tile(cuda, monkeypatch, buckets, n, d,
                                          tile):
    """The forward kernel on 16- or 32-row tiles at any N (the wrapper
    chooses by N; ``--kernel-profile`` times the other choice) agrees with
    the plain version."""
    from multimodal_plankton_recognition_torch.ops import contrastive

    img, prof = _embeddings(cuda, buckets * n, d, torch.bfloat16, seed=4)
    scale = torch.full((), 0.7, device=cuda)
    bias = torch.full((), -10.0, device=cuda)
    monkeypatch.setattr(contrastive, "siglip_fwd_tile", lambda _n: tile)
    loss = siglip_fwd(img, prof, scale, bias, buckets)
    want = siglip_loss_fused_reference(img, prof, scale, bias, buckets)
    torch.cuda.synchronize()
    assert abs(loss.item() - want.item()) <= 1e-5 * abs(want.item())


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("buckets,n,d", [(4, 16, 512), (2, 9, 40),
                                         (1, 16, 1000)])
def test_siglip_backward_two_kernels_at_one_tile(cuda, monkeypatch, buckets,
                                                 n, d, dtype):
    """At one 16-row tile a bucket the two-kernel backward (the other side
    of ``siglip_bwd_tile``, which ``--kernel-profile`` times) agrees with
    the plain version too."""
    from multimodal_plankton_recognition_torch.ops import contrastive

    img, prof = _embeddings(cuda, buckets * n, d, dtype, seed=5)
    args = (img, prof, torch.full((), 0.7, device=cuda),
            torch.full((), -10.0, device=cuda))
    g = torch.full((), 1.3, device=cuda)
    monkeypatch.setattr(contrastive, "siglip_bwd_tile", lambda _n: 32)
    grads = siglip_bwd(*args, g, buckets)
    want = siglip_loss_bwd_reference(*args, g, buckets)
    torch.cuda.synchronize()
    _siglip_grads_close(grads, want, dtype)


def test_siglip_takes_a_bucket_of_257(cuda):
    """One row past the old 256-row cap: the SigLIP kernels take it (a
    ragged last 32-row tile) and agree with the plain versions."""
    img, prof = _embeddings(cuda, 257, 16, torch.bfloat16, seed=3)
    scale = torch.zeros((), device=cuda)
    bias = torch.full((), -10.0, device=cuda)
    g = torch.ones((), device=cuda)
    loss = siglip_fwd(img, prof, scale, bias, 1)
    grads = siglip_bwd(img, prof, scale, bias, g, 1)
    want = siglip_loss_fused_reference(img, prof, scale, bias, 1)
    want_grads = siglip_loss_bwd_reference(img, prof, scale, bias, g, 1)
    torch.cuda.synchronize()
    _siglip_close(loss, grads, want, want_grads, torch.bfloat16)


def test_siglip_autograd_launches_both_kernels(cuda):
    img, prof = _embeddings(cuda, 64, 32, torch.bfloat16, seed=1)
    leaves = [t.requires_grad_() for t in (img, prof)]
    scale = torch.zeros((), device=cuda, requires_grad=True)
    bias = torch.full((), -10.0, device=cuda, requires_grad=True)
    before = siglip_fwd.launches, siglip_bwd.launches
    siglip_loss_fused(*leaves, scale, bias, 4).backward()
    assert (siglip_fwd.launches, siglip_bwd.launches) == (before[0] + 1,
                                                          before[1] + 1)
    assert all(t.grad is not None for t in (*leaves, scale, bias))


def test_siglip_refuses_what_the_kernels_do_not_take(cuda):
    img, prof = _embeddings(cuda, 10, 16, torch.bfloat16)
    scale = torch.zeros((), device=cuda)
    before = siglip_fwd.launches, siglip_bwd.launches
    with pytest.raises(ValueError, match="divisible"):
        siglip_fwd(img, prof, scale, scale, 4)
    img, prof = _embeddings(cuda, 8, 16, torch.bfloat16)
    with pytest.raises(ValueError, match="logit_bias"):
        siglip_fwd(img, prof, scale, torch.zeros(()), 1)  # bias on the CPU
    with pytest.raises(ValueError, match="logit_bias"):
        siglip_bwd(img, prof, scale, scale.double(), torch.ones((),
                                                                device=cuda),
                   1)
    with pytest.raises(ValueError, match="g must be"):
        siglip_bwd(img, prof, scale, scale, torch.ones(2, device=cuda), 1)
    with pytest.raises(TypeError, match="SigLIP"):
        siglip_fwd(img.half(), prof.half(), scale, scale, 1)
    assert (siglip_fwd.launches, siglip_bwd.launches) == before


# the SigLIP card: ViT-S (E 384) and its profile encoder (E 128), batch 64
CARD_SHAPES = [(64, 197, 6, 64, False), (64, 225, 4, 32, True)]


@pytest.mark.parametrize("b,l,heads,d,masked", CARD_SHAPES,
                         ids=["vit_s", "profile"])
def test_attention_at_the_card_shapes(cuda, b, l, heads, d, masked):
    """Forward in eval and train mode, backward, and the bit-exact mask
    check (q = k = 0, v = ±1) at the shapes the card's train step runs."""
    qkv, bias = _inputs(cuda, b, l, heads, d, masked, seed=5)
    p = 0.1 if masked else 0.0
    for rate in {0.0, p}:
        out = mha_qkv(qkv, bias, heads, rate, 31)
        ref = mha_qkv_reference(qkv, bias, heads, rate, 31)
        assert torch.isfinite(out).all()
        assert (out.float() - ref.float()).abs().max().item() <= TOL
    dout = torch.randn((b, l, heads * d), device=cuda).to(torch.bfloat16)
    got = mha_qkv_bwd(qkv, bias, dout, heads, p, 37)
    want = mha_qkv_bwd_reference(qkv, bias, dout, heads, p, 37)
    scale = want.float().abs().max().item()
    assert (got.float() - want.float()).abs().max().item() <= BWD_TOL * scale
    e = heads * d
    exact = torch.zeros_like(qkv)
    signs = torch.rand((b, l, e), device=cuda) < 0.5
    exact[..., 2 * e:] = torch.where(signs, -1.0, 1.0).to(qkv.dtype)
    assert torch.equal(mha_qkv(exact, bias, heads, 0.1, 41),
                       mha_qkv_reference(exact, bias, heads, 0.1, 41))


# --------------------------- MBConv kernels 13-16 ---------------------------
# (B, H, W, cin, mid, cout, k, r): odd sizes and SE widths, no expand, k 5,
# and B0's first and last stride-1 blocks at a small batch
MBCONV_SHAPES = [(2, 9, 7, 8, 48, 16, 3, 3), (3, 12, 12, 16, 16, 8, 3, 4),
                 (2, 10, 10, 24, 144, 40, 5, 6),
                 (4, 112, 112, 32, 32, 16, 3, 8),
                 (4, 7, 7, 192, 1152, 320, 3, 48)]
MBCONV_TOL = 2e-2  # of max(1, the largest |plain value|) of each output
MBCONV_REL_TOL = 1e-3  # relative L2 error of each output


def _mbconv_inputs(cuda, b, h, w, cin, mid, cout, k, r, seed=0):
    """(x, wexp, g1, b1, wdw, g2, b2, wr, br, we, be, wproj, dy3, dy2):
    wexp, g1 and b1 are None without an expand (mid == cin)."""
    gen = torch.Generator(device=cuda).manual_seed(seed)

    def rnd(*shape, scale=1.0, shift=0.0):
        return torch.randn(shape, generator=gen, device=cuda) * scale + shift

    expand = mid != cin
    return (rnd(b, h, w, cin).to(torch.bfloat16),
            rnd(cin, mid, scale=cin ** -0.5) if expand else None,
            rnd(mid, scale=0.1, shift=1.0) if expand else None,
            rnd(mid, scale=0.1) if expand else None,
            rnd(k, k, mid, scale=1.0 / k), rnd(mid, scale=0.1, shift=1.0),
            rnd(mid, scale=0.1), rnd(mid, r, scale=mid ** -0.5),
            rnd(r, scale=0.1), rnd(r, mid, scale=r ** -0.5),
            rnd(mid, scale=0.1), rnd(mid, cout, scale=mid ** -0.5),
            rnd(b, h, w, cout).to(torch.bfloat16),
            rnd(b, h, w, mid).to(torch.bfloat16))


def _close_to_plain(got, want, what):
    for i, (g, w) in enumerate(zip(got, want)):
        if w is None:
            assert g is None, f"{what}[{i}]"
            continue
        assert g.shape == w.shape and g.dtype == w.dtype, f"{what}[{i}]"
        assert torch.isfinite(g).all(), f"{what}[{i}] not finite"
        top = max(1.0, w.float().abs().max().item())
        err = (g.float() - w.float()).abs().max().item()
        assert err <= MBCONV_TOL * top, f"{what}[{i}]: {err} of {top}"
        diff = (g.float() - w.float()).norm().item()
        rel = diff / max(w.float().norm().item(), 1e-30)
        assert rel <= MBCONV_REL_TOL, f"{what}[{i}]: relative L2 {rel}"


@pytest.mark.parametrize("shape", MBCONV_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
def test_mbconv_kernels_match_plain(cuda, shape):
    """Kernels 13-16 each on the inputs their plain versions get."""
    from multimodal_plankton_recognition_torch.ops import mbconv

    k = shape[6]
    (x, wexp, g1, b1, wdw, g2, b2, wr, br, we, be, wproj, dy3,
     dy2) = _mbconv_inputs(cuda, *shape)
    counts = [f.launches for f in (mbconv.ka_fwd, mbconv.kb_fwd,
                                   mbconv.kb_bwd, mbconv.ka_bwd)]
    want = mbconv.ka_fwd_reference(x, wexp, g1, b1, wdw, k)
    _close_to_plain(mbconv.ka_fwd(x, wexp, g1, b1, wdw, k), want, "ka_fwd")
    y2, m1, v1, m2, v2 = want
    kb = (g2, b2, m2, v2, wr, br, we, be, wproj)
    _close_to_plain(mbconv.kb_fwd(y2, *kb),
                    mbconv.kb_fwd_reference(y2, *kb), "kb_fwd")
    _close_to_plain(mbconv.kb_bwd(y2, dy3, *kb),
                    mbconv.kb_bwd_reference(y2, dy3, *kb), "kb_bwd")
    ka = (wexp, g1, b1, wdw, m1, v1, k)
    _close_to_plain(mbconv.ka_bwd(x, dy2, *ka),
                    mbconv.ka_bwd_reference(x, dy2, *ka), "ka_bwd")
    torch.cuda.synchronize()
    assert [f.launches for f in (mbconv.ka_fwd, mbconv.kb_fwd, mbconv.kb_bwd,
                                 mbconv.ka_bwd)] == [c + 1 for c in counts]


def test_mbconv_core_autograd_launches_all_four(cuda):
    """``mbconv_core`` on the card: the forward runs kernels 13 and 14, the
    backward 15 and 16; outputs and gradients as the plain versions give
    them on the CPU."""
    from multimodal_plankton_recognition_torch.ops import mbconv

    args = _mbconv_inputs(cuda, 2, 9, 7, 8, 48, 16, 3, 3)[:12]

    def run(device):
        leaves = [None if a is None else
                  a.detach().to(device).requires_grad_(a.dtype != torch.bfloat16
                                                       or i == 0)
                  for i, a in enumerate(args)]
        out = mbconv.mbconv_core(*leaves, 3)
        (out[0].float().square().sum() + 3.0 * out[5].sum()
         + 2.0 * out[6].sum()).backward()
        return out, [None if t is None else t.grad for t in leaves]

    counts = [f.launches for f in (mbconv.ka_fwd, mbconv.kb_fwd,
                                   mbconv.kb_bwd, mbconv.ka_bwd)]
    got, got_grads = run(cuda)
    torch.cuda.synchronize()
    assert [f.launches for f in (mbconv.ka_fwd, mbconv.kb_fwd, mbconv.kb_bwd,
                                 mbconv.ka_bwd)] == [c + 1 for c in counts]
    want, want_grads = run("cpu")
    _close_to_plain([t.cpu() for t in got], want, "outputs")
    _close_to_plain([None if g is None else g.cpu() for g in got_grads],
                    want_grads, "grads")


def test_f32_fused_block_takes_the_kernels(cuda):
    """An f32 train-mode block at stride 1 with ``fused`` runs kernels
    13-16 once each (x rounded to bf16 for them), returns f32 and its
    gradients as the same block's plain versions give them on the CPU."""
    from multimodal_plankton_recognition_torch.models.image.efficientnet \
        import _MBConv
    from multimodal_plankton_recognition_torch.ops import mbconv

    torch.manual_seed(0)
    block = _MBConv(16, 16, 6, 1, 3, 0.25, fused=True).train()
    x = torch.randn(4, 16, 12, 12).contiguous(
        memory_format=torch.channels_last)

    def run(device):
        b = block.to(device)
        xd = x.to(device).requires_grad_()
        out = b(xd)
        out.square().sum().backward()
        grads = [xd.grad] + [p.grad for p in b.parameters()]
        b.zero_grad()
        return out, grads

    counts = [f.launches for f in (mbconv.ka_fwd, mbconv.kb_fwd,
                                   mbconv.kb_bwd, mbconv.ka_bwd)]
    got, got_grads = run(cuda)
    torch.cuda.synchronize()
    assert [f.launches for f in (mbconv.ka_fwd, mbconv.kb_fwd, mbconv.kb_bwd,
                                 mbconv.ka_bwd)] == [c + 1 for c in counts]
    assert got.dtype == torch.float32
    want, want_grads = run("cpu")
    top = max(1.0, want.abs().max().item())
    assert (got.cpu() - want).abs().max().item() <= MBCONV_TOL * top
    for g, w in zip(got_grads, want_grads):
        assert g.dtype == torch.float32 and torch.isfinite(g).all()
        rel = ((g.cpu() - w).norm() / max(w.norm().item(), 1e-30)).item()
        assert rel <= 2e-2, rel


def test_mbconv_refuses_what_the_kernels_do_not_take(cuda):
    from multimodal_plankton_recognition_torch.ops import mbconv

    (x, wexp, g1, b1, wdw, *_rest) = _mbconv_inputs(cuda, 1, 4, 4, 8, 16,
                                                    8, 3, 2)
    with pytest.raises(ValueError, match="bf16"):
        mbconv.ka_fwd(x.float(), wexp, g1, b1, wdw, 3)
    with pytest.raises(ValueError, match="kernel size 7"):
        mbconv.ka_fwd(x, wexp, g1, b1, torch.zeros((7, 7, 16), device=cuda),
                      7)


# ------------------------ kernels 3-4: separate q, k, v ------------------------

def _separate(qkv):
    return [t.contiguous() for t in qkv.chunk(3, dim=-1)]


@pytest.mark.parametrize("p", [0.0, 0.1])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("d", SUPPORTED_HEAD_DIMS)
@pytest.mark.parametrize("b,l,heads", SHAPES)
def test_separate_kernels_match_plain(cuda, b, l, heads, d, masked, p):
    """Kernels 3 and 4 against their plain versions, and bit for bit
    against kernels 1 and 2 on the same operands packed."""
    qkv, bias = _inputs(cuda, b, l, heads, d, masked, seed=6)
    q, k, v = _separate(qkv)
    dout = torch.randn((b, l, heads * d), device=cuda).to(torch.bfloat16)
    before = mha.launches, mha_bwd.launches
    out = mha(q, k, v, bias, heads, p, 23)
    grads = mha_bwd(q, k, v, bias, dout, heads, p, 23)
    assert (mha.launches, mha_bwd.launches) == (before[0] + 1,
                                                before[1] + 1)
    ref = mha_reference(q, k, v, bias, heads, p, 23)
    want = mha_bwd_reference(q, k, v, bias, dout, heads, p, 23)
    torch.cuda.synchronize()
    assert torch.isfinite(out).all()
    assert (out.float() - ref.float()).abs().max().item() <= TOL
    scale = max(max(w.float().abs().max().item() for w in want), 1.0)
    for g, w in zip(grads, want):
        assert g.dtype == torch.bfloat16 and g.shape == q.shape
        assert (g.float() - w.float()).abs().max().item() <= BWD_TOL * scale
    assert torch.equal(out, mha_qkv(qkv, bias, heads, p, 23))
    assert torch.equal(torch.cat(grads, dim=-1),
                       mha_qkv_bwd(qkv, bias, dout, heads, p, 23))


@pytest.mark.parametrize("d", SUPPORTED_HEAD_DIMS)
def test_separate_train_mode_mask_is_the_plain_mask(cuda, d):
    """The exact-sum check of kernel 1 (q = k = 0, v = ±1) on kernel 3."""
    b, l, heads = 3, 100, 2
    _, bias = _inputs(cuda, b, l, heads, d, True, seed=2)
    q = torch.zeros((b, l, heads * d), dtype=torch.bfloat16, device=cuda)
    signs = torch.rand((b, l, heads * d), device=cuda) < 0.5
    v = torch.where(signs, -1.0, 1.0).to(torch.bfloat16)
    assert torch.equal(mha(q, q, v, bias, heads, 0.1, 99),
                       mha_reference(q, q, v, bias, heads, 0.1, 99))


def test_separate_autograd_launches_both_kernels(cuda):
    qkv, bias = _inputs(cuda, 2, 40, 4, 24, True)
    leaves = [t.requires_grad_() for t in _separate(qkv)]
    fwd, bwd = mha.launches, mha_bwd.launches
    mha(*leaves, bias, 4, 0.1, 5).float().square().sum().backward()
    assert (mha.launches, mha_bwd.launches) == (fwd + 1, bwd + 1)
    assert all(t.grad is not None and torch.isfinite(t.grad).all()
               for t in leaves)


def test_separate_refuses_what_the_kernels_do_not_take(cuda):
    qkv, _ = _inputs(cuda, 2, 9, 3, 16, False)
    q, k, v = _separate(qkv)
    with pytest.raises(TypeError, match="bf16"):
        mha(q.float(), k.float(), v.float(), None, 3)
    with pytest.raises(ValueError, match="share shape"):
        mha(q, k[:1].contiguous(), v, None, 3)
    with pytest.raises(ValueError, match="contiguous"):
        mha(q, k.transpose(1, 2).contiguous().transpose(1, 2), v, None, 3)


@pytest.mark.parametrize("b,l,heads,d,masked", CARD_SHAPES,
                         ids=["vit_s", "profile"])
def test_separate_at_the_card_shapes(cuda, b, l, heads, d, masked):
    qkv, bias = _inputs(cuda, b, l, heads, d, masked, seed=7)
    q, k, v = _separate(qkv)
    p = 0.1 if masked else 0.0
    out = mha(q, k, v, bias, heads, p, 31)
    assert (out.float() - mha_reference(q, k, v, bias, heads, p, 31)
            .float()).abs().max().item() <= TOL
    dout = torch.randn((b, l, heads * d), device=cuda).to(torch.bfloat16)
    got = mha_bwd(q, k, v, bias, dout, heads, p, 37)
    want = mha_bwd_reference(q, k, v, bias, dout, heads, p, 37)
    scale = max(w.float().abs().max().item() for w in want)
    for g, w in zip(got, want):
        assert (g.float() - w.float()).abs().max().item() <= BWD_TOL * scale


# ----------------------------- kernels 9-10: FFN -----------------------------
# (B, L, E, F): odd L, F not a multiple of 64 (padded), each width
FFN_SHAPES = [(2, 29, 64, 256), (3, 17, 128, 200), (1, 70, 192, 768),
              (2, 33, 64, 520), (2, 21, 384, 1536), (1, 1, 64, 64)]
FFN_TOL = 2e-2      # of max(1, the largest |plain value|), each output
FFN_REL_TOL = 2e-3  # relative L2 of each output


def _ffn_inputs(cuda, b, l, e, f, dtype, seed=0):
    gen = torch.Generator(device=cuda).manual_seed(seed)

    def rnd(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=cuda) * scale

    return (rnd(b, l, e).to(dtype), rnd(e, f, scale=e ** -0.5),
            rnd(f, scale=0.1), rnd(f, e, scale=f ** -0.5), rnd(e, scale=0.1),
            rnd(b, l, e).to(dtype))


def _ffn_close(got, want, what):
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape and g.dtype == w.dtype, f"{what}[{i}]"
        assert torch.isfinite(g).all(), f"{what}[{i}] not finite"
        top = max(1.0, w.float().abs().max().item())
        err = (g.float() - w.float()).abs().max().item()
        assert err <= FFN_TOL * top, f"{what}[{i}]: {err} of {top}"
        rel = ((g.float() - w.float()).norm()
               / max(w.float().norm().item(), 1e-30)).item()
        assert rel <= FFN_REL_TOL, f"{what}[{i}]: relative L2 {rel}"


@pytest.mark.parametrize("p", [0.0, 0.1])
@pytest.mark.parametrize("activation", ["gelu", "relu"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", FFN_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
def test_ffn_kernels_match_plain(cuda, shape, dtype, activation, p):
    from multimodal_plankton_recognition_torch.ops import ffn

    x, w1, b1, w2, b2, dy = _ffn_inputs(cuda, *shape, dtype)
    before = ffn.ffn_fwd.launches, ffn.ffn_bwd.launches
    y = ffn.ffn_fwd(x, w1, b1, w2, b2, activation, p, 3)
    grads = ffn.ffn_bwd(x, w1, b1, w2, b2, dy, activation, p, 3)
    assert (ffn.ffn_fwd.launches, ffn.ffn_bwd.launches) == (
        before[0] + 1, before[1] + 1)
    want = ffn.ffn_reference(x, w1, b1, w2, b2, activation, p, 3)
    want_grads = ffn.ffn_bwd_reference(x, w1, b1, w2, b2, dy, activation, p,
                                       3)
    torch.cuda.synchronize()
    _ffn_close([y], [want], "y")
    _ffn_close(grads, want_grads, "grads")


@pytest.mark.parametrize("p", [0.1, 0.5])
@pytest.mark.parametrize("shape", FFN_SHAPES[:5],
                         ids=lambda s: "x".join(map(str, s)))
def test_ffn_dropout_mask_is_the_plain_mask(cuda, shape, p):
    """ReLU on integer x and w1, ±1 w2 and dy, zero biases: every sum of
    the forward and of dx, dw1, dw2, db2 is exact in f32 whatever its
    order, so kernel and plain version agree bit for bit iff their dropout
    masks do."""
    from multimodal_plankton_recognition_torch.ops import ffn

    b, l, e, f = shape
    gen = torch.Generator(device=cuda).manual_seed(1)

    def ints(*shape, lo=-1, hi=2):
        return torch.randint(lo, hi, shape, generator=gen,
                             device=cuda).float()

    x = ints(b, l, e).to(torch.bfloat16)
    w1 = ints(e, f)
    w2 = torch.where(ints(f, e, lo=0) > 0, 1.0, -1.0)
    b1, b2 = torch.zeros(f, device=cuda), torch.zeros(e, device=cuda)
    dy = torch.where(ints(b, l, e, lo=0) > 0, 1.0, -1.0).to(torch.bfloat16)
    args = (x, w1, b1, w2, b2)
    assert torch.equal(ffn.ffn_fwd(*args, "relu", p, 77),
                       ffn.ffn_reference(*args, "relu", p, 77))
    got = ffn.ffn_bwd(*args, dy, "relu", p, 77)
    want = ffn.ffn_bwd_reference(*args, dy, "relu", p, 77)
    for i in (0, 1, 3, 4):  # db1 sums dpre = dh / (1 - p), not exact
        assert torch.equal(got[i], want[i]), i


def test_ffn_core_autograd_launches_both_kernels(cuda):
    """``ffn_core`` on the card: one launch of each kernel; outputs and
    gradients as the plain versions give them on the CPU."""
    from multimodal_plankton_recognition_torch.ops import ffn

    inputs = _ffn_inputs(cuda, 2, 29, 192, 520, torch.bfloat16, seed=2)[:5]

    def run(device):
        leaves = [t.detach().to(device).requires_grad_() for t in inputs]
        out = ffn.ffn_core(*leaves, "gelu", 0.1, 19)
        out.float().square().sum().backward()
        return [out] + [t.grad for t in leaves]

    before = ffn.ffn_fwd.launches, ffn.ffn_bwd.launches
    got = run(cuda)
    torch.cuda.synchronize()
    assert (ffn.ffn_fwd.launches, ffn.ffn_bwd.launches) == (
        before[0] + 1, before[1] + 1)
    _ffn_close([t.cpu() for t in got], run("cpu"), "core")


def test_ffn_refuses_what_the_kernels_do_not_take(cuda):
    from multimodal_plankton_recognition_torch.ops import ffn

    x, w1, b1, w2, b2, _ = _ffn_inputs(cuda, 2, 5, 64, 128, torch.bfloat16)
    with pytest.raises(TypeError, match="bf16 or f32"):
        ffn.ffn_fwd(x.half(), w1, b1, w2, b2)
    odd = _ffn_inputs(cuda, 2, 5, 48, 128, torch.bfloat16)
    with pytest.raises(ValueError, match="width 48"):
        ffn.ffn_fwd(*odd[:5])
    with pytest.raises(ValueError, match="weights"):
        ffn.ffn_fwd(x, w1, b1, w1, b2)
    with pytest.raises(ValueError, match="activation"):
        ffn.ffn_fwd(x, w1, b1, w2, b2, "silu")


# ---------------- kernels 11-12: the fused attention block ----------------

# (B, L, E, heads, mask): the four (E, heads) of the paths, small B
BLOCK_SHAPES = [(2, 197, 192, 3, False), (2, 225, 192, 8, True),
                (2, 197, 384, 6, False), (3, 225, 128, 4, True),
                (1, 1, 128, 4, False), (2, 70, 192, 8, True)]
BLOCK_TOL, BLOCK_REL_TOL, BLOCK_GRAD_TOL = 2e-2, 2e-3, 1e-2


def _block_inputs(cuda, b, l, e, masked, seed=0):
    gen = torch.Generator(device=cuda).manual_seed(seed)

    def rnd(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=cuda) * scale

    bias = None
    if masked:
        pad = torch.rand((b, l), generator=gen, device=cuda) < 0.3
        pad[:, 0] = False
        bias = torch.where(pad, -1e9, 0.0).to(torch.float32)
    return ((rnd(b, l, e).to(torch.bfloat16), rnd(3 * e, e, scale=e ** -0.5)
             .to(torch.bfloat16), rnd(3 * e, scale=0.1),
             rnd(e, e, scale=e ** -0.5).to(torch.bfloat16), rnd(e, scale=0.1),
             bias), rnd(b, l, e).to(torch.bfloat16))


def _block_close(got, want, what):
    """y and dx: BLOCK_TOL of max(1, |plain|) and BLOCK_REL_TOL relative L2;
    weight and bias gradients: BLOCK_GRAD_TOL of their largest value."""
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape and g.dtype == w.dtype, f"{what}[{i}]"
        assert torch.isfinite(g).all(), f"{what}[{i}] not finite"
        err = (g.float() - w.float()).abs().max().item()
        top = w.float().abs().max().item()
        if i == 0:
            assert err <= BLOCK_TOL * max(1.0, top), f"{what}[{i}]: {err}"
            rel = ((g.float() - w.float()).norm()
                   / max(w.float().norm().item(), 1e-30)).item()
            assert rel <= BLOCK_REL_TOL, f"{what}[{i}]: relative L2 {rel}"
        else:
            assert err <= BLOCK_GRAD_TOL * top, f"{what}[{i}]: {err}"


@pytest.mark.parametrize("p", [0.0, 0.1])
@pytest.mark.parametrize("b,l,e,heads,masked", BLOCK_SHAPES)
def test_block_kernels_match_plain(cuda, b, l, e, heads, masked, p):
    args, dy = _block_inputs(cuda, b, l, e, masked)
    before = ab.attn_block_fwd.launches, ab.attn_block_bwd.launches
    y = ab.attn_block_fwd(*args, heads, p, 23)
    got = ab.attn_block_bwd(*args, dy, heads, p, 23)
    torch.cuda.synchronize()
    assert (ab.attn_block_fwd.launches, ab.attn_block_bwd.launches) == (
        before[0] + 1, before[1] + 1)
    _block_close([y], [ab.attn_block_reference(*args, heads, p, 23)], "fwd")
    _block_close(got, ab.attn_block_bwd_reference(*args, dy, heads, p, 23),
                 "bwd")


# row counts that leave a ragged last 128-row tile of the GEMMs (195 and
# 12,608 rows) and a ragged last 64-row chunk of the weight gradients
BLOCK_RAGGED = [(3, 65, 192, 3, False), (3, 65, 192, 8, True),
                (64, 197, 384, 6, False)]


@pytest.mark.parametrize("p", [0.0, 0.1])
@pytest.mark.parametrize("b,l,e,heads,masked", BLOCK_RAGGED)
def test_block_ragged_rows_match_plain(cuda, b, l, e, heads, masked, p):
    """Kernel 11 with ``keep`` (y, q|k|v and o against the plain forward)
    and kernel 12 on those residuals against the plain backward, at row
    counts that are no multiple of the GEMMs' tiles."""
    args, dy = _block_inputs(cuda, b, l, e, masked, seed=5)
    y, qkv, o = ab.attn_block_fwd(*args, heads, p, 31, keep=True)
    want = ab.attn_block_reference(*args, heads, p, 31, keep=True)
    _block_close([y], want[:1], "fwd y")
    _block_close([qkv], want[1:2], "fwd qkv")
    _block_close([o], want[2:], "fwd o")
    got = ab.attn_block_bwd(*args, dy, heads, p, 31, qkv=qkv, o=o)
    torch.cuda.synchronize()
    _block_close(got, ab.attn_block_bwd_reference(*args, dy, heads, p, 31,
                                                  qkv=qkv, o=o), "bwd")


@pytest.mark.parametrize("b,l,e,heads,masked,p",
                         [(2, 197, 192, 3, False, 0.0),
                          (3, 225, 128, 4, True, 0.1),
                          (2, 70, 192, 8, True, 0.1),
                          (2, 197, 384, 6, False, 0.0)])
def test_block_bwd_residuals_and_repeats_bit_for_bit(cuda, b, l, e, heads,
                                                      masked, p):
    """Kernel 12 given the forward's q|k|v and o equals kernel 12
    rebuilding them, and a second call equals the first, bit for bit (no
    atomics; the groups are added in index order); one launch a call."""
    args, dy = _block_inputs(cuda, b, l, e, masked, seed=6)
    _, qkv, o = ab.attn_block_fwd(*args, heads, p, 17, keep=True)
    before = ab.attn_block_bwd.launches
    given = ab.attn_block_bwd(*args, dy, heads, p, 17, qkv=qkv, o=o)
    again = ab.attn_block_bwd(*args, dy, heads, p, 17, qkv=qkv, o=o)
    rebuilt = ab.attn_block_bwd(*args, dy, heads, p, 17)
    torch.cuda.synchronize()
    assert ab.attn_block_bwd.launches == before + 3
    for i, (g, a, r) in enumerate(zip(given, again, rebuilt)):
        assert torch.equal(g, a), f"output {i}: two calls differ"
        assert torch.equal(g, r), f"output {i}: residuals differ"


@pytest.mark.parametrize("p", [0.1, 0.5])
@pytest.mark.parametrize("e,heads", [(192, 8), (128, 4)])  # D 24 and 32
def test_block_mask_is_kernel_1s_mask(cuda, e, heads, p):
    """Identity projections: kernel 11's y equals kernel 1's output on
    q = k = 0, v = x, and kernel 12's dx equals kernel 2's dv, bit for
    bit."""
    (x, _, _, _, _, bias), dy = _block_inputs(cuda, 3, 225, e, True, seed=4)
    x, dy = (torch.where(t > 0, 1.0, -1.0).to(torch.bfloat16)
             for t in (x, dy))
    wqkv = torch.zeros((3 * e, e), device=cuda)
    wqkv[2 * e:] = torch.eye(e, device=cuda)
    args = (x, wqkv, torch.zeros(3 * e, device=cuda),
            torch.eye(e, device=cuda), torch.zeros(e, device=cuda), bias)
    qkv = torch.cat([torch.zeros_like(x), torch.zeros_like(x), x], dim=-1)
    assert torch.equal(ab.attn_block_fwd(*args, heads, p, 41),
                       mha_qkv(qkv, bias, heads, p, 41))
    dx = ab.attn_block_bwd(*args, dy, heads, p, 41)[0]
    dv = mha_qkv_bwd(qkv, bias, dy, heads, p, 41)[..., 2 * e:]
    assert torch.equal(dx, dv)


def test_block_module_route_on_card(cuda, monkeypatch):
    """``FusedSelfAttention`` under ``PLANKTON_ATTN_FUSE_PROJ=1``: one launch
    of kernel 11 and 12 and none of kernels 1-4; output and gradients as
    the same module gives them on the CPU (the plain versions)."""
    monkeypatch.setenv("PLANKTON_ATTN_FUSE_PROJ", "1")
    torch.manual_seed(3)
    cpu = FusedSelfAttention(128, 4).to(torch.bfloat16)
    card = FusedSelfAttention(128, 4).to(torch.bfloat16)
    card.load_state_dict(cpu.state_dict())
    card.to(cuda)
    x = torch.randn((2, 225, 128)).to(torch.bfloat16)
    mask = torch.zeros((2, 225), dtype=torch.bool)
    mask[1, 100:] = True

    def run(mod, device):
        leaf = x.to(device).requires_grad_()
        out = mod(leaf, mask.to(device))
        out.float().square().sum().backward()
        return [out.detach(), leaf.grad, mod.qkv.weight.grad,
                mod.qkv.bias.grad, mod.out.weight.grad, mod.out.bias.grad]

    counters = (ab.attn_block_fwd, ab.attn_block_bwd, mha_qkv, mha_qkv_bwd,
                mha, mha_bwd)
    before = [c.launches for c in counters]
    got = run(card, cuda)
    torch.cuda.synchronize()
    assert [c.launches - n for c, n in zip(counters, before)] == [
        1, 1, 0, 0, 0, 0]
    want = run(cpu, "cpu")
    _block_close([got[0].cpu()], want[:1], "module y")
    for i, (g, w) in enumerate(zip(got[1:], want[1:])):
        assert g.dtype == w.dtype == torch.bfloat16
        err = (g.float().cpu() - w.float()).abs().max().item()
        assert err <= 2 * BLOCK_GRAD_TOL * w.float().abs().max().item(), i


def test_block_refuses_what_the_kernels_do_not_take(cuda):
    args, dy = _block_inputs(cuda, 2, 9, 128, False)
    with pytest.raises(TypeError, match="bf16"):
        ab.attn_block_fwd(args[0].float(), *args[1:], 4)
    with pytest.raises(ValueError, match="not in"):
        ab.attn_block_fwd(*args, 8)
    with pytest.raises(ValueError, match="weights"):
        ab.attn_block_fwd(args[0], args[3], *args[2:], 4)
    # the backward's residuals: both or neither, the forward's shapes
    _, qkv, o = ab.attn_block_fwd(*args, 4, keep=True)
    before = ab.attn_block_bwd.launches
    with pytest.raises(ValueError, match="both"):
        ab.attn_block_bwd(*args, dy, 4, qkv=qkv)
    with pytest.raises(ValueError, match="qkv must be"):
        ab.attn_block_bwd(*args, dy, 4, qkv=o, o=o)
    with pytest.raises(ValueError, match="o must be"):
        ab.attn_block_bwd(*args, dy, 4, qkv=qkv, o=o.float())
    with pytest.raises(ValueError, match="aligned"):
        ab.attn_block_bwd(*args, dy, 4, qkv=qkv[:, :, :].transpose(0, 1)
                          .contiguous().transpose(0, 1), o=o)
    assert ab.attn_block_bwd.launches == before


# ------------- the shared Hopper GEMM (csrc/hopper_gemm.cuh) -------------

# (M, N, K): widths that are multiples of 8 but not of 64 (B0's channels,
# the FFN's padded F), ragged row tiles, a K of one box and of many
GEMM_SHAPES = [(195, 24, 144), (1000, 144, 24), (130, 40, 1152),
               (64, 200, 72), (12608, 672, 112), (77, 1152, 192),
               (300, 2048, 384)]


@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("transposed", [False, True])
@pytest.mark.parametrize("m,n,k", GEMM_SHAPES,
                         ids=lambda s: str(s))
def test_hopper_gemm_rows_at_any_width(cuda, m, n, k, transposed,
                                       with_bias):
    """``gemm_rows_kernel`` against torch.matmul in f32, rounded once to
    bf16: one bf16 step (at most 2^-7 relative) apart at most, where the
    two sums land on either side of a rounding boundary."""
    from multimodal_plankton_recognition_torch.ops import hopper_gemm as hg

    gen = torch.Generator(device=cuda).manual_seed(m + n + k)
    a = torch.randn((m, k), generator=gen, device=cuda).to(torch.bfloat16)
    w = (torch.randn((k, n) if transposed else (n, k), generator=gen,
                     device=cuda) * k ** -0.5).to(torch.bfloat16)
    bias = torch.randn(n, generator=gen, device=cuda) if with_bias else None
    before = hg.gemm_rows.launches
    got = hg.gemm_rows(a, w, bias, transposed)
    want = (a.float() @ (w.float() if transposed else w.float().t())
            + (0.0 if bias is None else bias)).to(torch.bfloat16)
    torch.cuda.synchronize()
    assert hg.gemm_rows.launches == before + 1
    assert got.shape == (m, n) and torch.isfinite(got.float()).all()
    err = (got.float() - want.float()).abs()
    assert (err <= 2 ** -7 * want.float().abs() + 1e-6).all(), \
        err.max().item()
    assert torch.equal(got, hg.gemm_rows(a, w, bias, transposed))


@pytest.mark.parametrize("rows,n,k", [(195, 24, 144), (12608, 144, 24),
                                      (1000, 2048, 384), (64, 40, 1152),
                                      (3000, 672, 112), (70, 8, 8)],
                         ids=lambda s: str(s))
def test_hopper_wgrad_at_any_width(cuda, rows, n, k):
    """``wgrad_kernel`` and its group sum against torch.matmul in f32 (the
    sums run in another order: 1e-5 of the largest |value| apart), and a
    second call bit for bit equal to the first."""
    from multimodal_plankton_recognition_torch.ops import hopper_gemm as hg

    gen = torch.Generator(device=cuda).manual_seed(rows + n)
    g = torch.randn((rows, n), generator=gen, device=cuda).to(torch.bfloat16)
    x = torch.randn((rows, k), generator=gen, device=cuda).to(torch.bfloat16)
    dw, db = hg.wgrad(g, x)
    want_dw, want_db = g.float().t() @ x.float(), g.float().sum(0)
    torch.cuda.synchronize()
    for got, want in ((dw, want_dw), (db, want_db)):
        assert got.shape == want.shape
        err = (got - want).abs().max().item()
        assert err <= 1e-5 * want.abs().max().item() * rows ** 0.5, err
    again = hg.wgrad(g, x)
    assert torch.equal(dw, again[0]) and torch.equal(db, again[1])


@pytest.mark.parametrize("m,n,k", [(195, 24, 24), (1000, 144, 24),
                                   (12608, 144, 24), (77, 1152, 192),
                                   (130, 1152, 192), (300, 240, 40)],
                         ids=lambda s: str(s))
def test_hopper_gemm_sums_at_any_width(cuda, m, n, k):
    """``gemm_sums`` (the row GEMM with its column-sum epilogue): c as
    torch.matmul rounds it, within one bf16 step; each 64-row chunk's
    column sums of c and c^2 as torch sums the same rounded rows, within
    1e-5 of the largest |sum| (another order), chunks past M 0; a second
    call bit for bit equal to the first."""
    from multimodal_plankton_recognition_torch.ops import hopper_gemm as hg

    gen = torch.Generator(device=cuda).manual_seed(m + n + k)
    a = torch.randn((m, k), generator=gen, device=cuda).to(torch.bfloat16)
    w = (torch.randn((k, n), generator=gen, device=cuda)
         * k ** -0.5).to(torch.bfloat16)
    before = hg.gemm_sums.launches
    c, sums = hg.gemm_sums(a, w)
    again = hg.gemm_sums(a, w)
    torch.cuda.synchronize()
    assert hg.gemm_sums.launches == before + 2
    want = (a.float() @ w.float()).to(torch.bfloat16)
    err = (c.float() - want.float()).abs()
    assert (err <= 2 ** -7 * want.float().abs() + 1e-6).all(), \
        err.max().item()
    chunks = 2 * -(-m // 128)
    rows = torch.zeros((chunks * 64, n), device=cuda)
    rows[:m] = c.float()
    rows = rows.reshape(chunks, 64, n)
    assert sums.shape == (2, chunks, n)
    for got, ref in ((sums[0], rows.sum(1)), (sums[1], rows.square().sum(1))):
        err = (got - ref).abs().max().item()
        assert err <= 1e-5 * max(1.0, ref.abs().max().item()), err
    assert torch.equal(c, again[0]) and torch.equal(sums, again[1])


def test_hopper_gemm_refuses_unaligned_rows(cuda):
    """A row stride that is not a multiple of 16 bytes is refused on the
    host, by the wrapper and by the entry point, before any launch."""
    from multimodal_plankton_recognition_torch.ops import hopper_gemm as hg

    a = torch.zeros((64, 20), dtype=torch.bfloat16, device=cuda)
    w = torch.zeros((16, 20), dtype=torch.bfloat16, device=cuda)
    before = hg.gemm_rows.launches, hg.wgrad.launches
    with pytest.raises(ValueError, match="16 bytes"):
        hg.gemm_rows(a, w)
    with pytest.raises(ValueError, match="16 bytes"):
        hg.wgrad(a, a)
    assert (hg.gemm_rows.launches, hg.wgrad.launches) == before
    c = torch.empty((64, 16), dtype=torch.bfloat16, device=cuda)
    lib = hg._lib()
    stream = torch.cuda.current_stream().cuda_stream
    assert lib.hopper_gemm_rows(a.data_ptr(), w.data_ptr(), 0, None,
                                c.data_ptr(), 64, 16, 20, stream) != 0
    part = torch.empty(64 * 20 * 20, device=cuda)
    assert lib.hopper_wgrad(a.data_ptr(), a.data_ptr(), part.data_ptr(), 1,
                            part.data_ptr(), None, 64, 20, 20, stream) != 0
    torch.cuda.synchronize()


# (B, L, E, F): each width at F 2024 (padded to 2048, not a multiple of 64)
FFN_WIDE_SHAPES = [(2, 33, 64, 2024), (1, 70, 128, 2024),
                   (1, 70, 192, 2024), (1, 41, 384, 2024)]


@pytest.mark.parametrize("p", [0.0, 0.1])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", FFN_WIDE_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
def test_ffn_bwd_at_every_width_repeats(cuda, shape, dtype, p):
    """Kernel 10 at E 64-384 with F 2024, bf16 and f32 x, p 0 and 0.1:
    within the FFN tolerances of its plain version, and a second call
    bit for bit equal to the first (no float atomics)."""
    from multimodal_plankton_recognition_torch.ops import ffn

    x, w1, b1, w2, b2, dy = _ffn_inputs(cuda, *shape, dtype, seed=5)
    before = ffn.ffn_bwd.launches
    got = ffn.ffn_bwd(x, w1, b1, w2, b2, dy, "gelu", p, 11)
    again = ffn.ffn_bwd(x, w1, b1, w2, b2, dy, "gelu", p, 11)
    want = ffn.ffn_bwd_reference(x, w1, b1, w2, b2, dy, "gelu", p, 11)
    torch.cuda.synchronize()
    assert ffn.ffn_bwd.launches == before + 2
    _ffn_close(got, want, "grads")
    assert all(torch.equal(g, a) for g, a in zip(got, again))


@pytest.mark.parametrize("p", [0.0, 0.1])
@pytest.mark.parametrize("activation", ["gelu", "relu"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", FFN_WIDE_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
def test_ffn_fwd_at_every_width_repeats(cuda, shape, dtype, activation, p):
    """Kernel 9 at E 64-384 with F 2024 and a ragged last tile, bf16 and
    f32 x, GELU and ReLU, p 0 and 0.1: within the FFN tolerances of its
    plain version, and a second call bit for bit equal to the first."""
    from multimodal_plankton_recognition_torch.ops import ffn

    x, w1, b1, w2, b2, _ = _ffn_inputs(cuda, *shape, dtype, seed=6)
    args = (x, w1, b1, w2, b2, activation, p, 13)
    before = ffn.ffn_fwd.launches
    got, again = ffn.ffn_fwd(*args), ffn.ffn_fwd(*args)
    assert ffn.ffn_fwd.launches == before + 2
    want = ffn.ffn_reference(*args)
    torch.cuda.synchronize()
    _ffn_close([got], [want], "y")
    assert torch.equal(got, again)


# B0's eight stride-1 block shapes (chip_smoke.py MBCONV_SHAPES: H = W,
# cin, mid, cout, k, SE width) at a small batch, and a ragged 9 x 9 one
KA_BWD_SHAPES = [(2, 112, 112, 32, 32, 16, 3, 8),
                 (2, 56, 56, 24, 144, 24, 3, 6),
                 (2, 28, 28, 40, 240, 40, 5, 10),
                 (4, 14, 14, 80, 480, 80, 3, 20),
                 (4, 14, 14, 80, 480, 112, 5, 20),
                 (4, 14, 14, 112, 672, 112, 5, 28),
                 (8, 7, 7, 192, 1152, 192, 5, 48),
                 (8, 7, 7, 192, 1152, 320, 3, 48),
                 (3, 9, 9, 24, 144, 24, 3, 6)]


@pytest.mark.parametrize("shape", KA_BWD_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
def test_mbconv_ka_bwd_at_b0_shapes_repeats(cuda, shape):
    """Kernel 16 at B0's block shapes: within the MBConv tolerances of its
    plain version, and a second call bit for bit equal to the first."""
    from multimodal_plankton_recognition_torch.ops import mbconv

    k = shape[6]
    (x, wexp, g1, b1, wdw, *_, dy2) = _mbconv_inputs(cuda, *shape, seed=3)
    _, m1, v1, _, _ = mbconv.ka_fwd_reference(x, wexp, g1, b1, wdw, k)
    args = (x, dy2, wexp, g1, b1, wdw, m1, v1, k)
    before = mbconv.ka_bwd.launches
    got = mbconv.ka_bwd(*args)
    again = mbconv.ka_bwd(*args)
    torch.cuda.synchronize()
    assert mbconv.ka_bwd.launches == before + 2
    _close_to_plain(got, mbconv.ka_bwd_reference(*args), "ka_bwd")
    assert all(g is None and a is None or torch.equal(g, a)
               for g, a in zip(got, again))


def test_mbconv_ka_bwd_refuses_unaligned_channels(cuda):
    """Channels that are not a multiple of 8 (16-byte rows) are refused
    before any launch."""
    from multimodal_plankton_recognition_torch.ops import mbconv

    (x, wexp, g1, b1, wdw, *_, dy2) = _mbconv_inputs(cuda, 1, 5, 5, 12, 72,
                                                     8, 3, 2)
    _, m1, v1, _, _ = mbconv.ka_fwd_reference(x, wexp, g1, b1, wdw, 3)
    before = mbconv.ka_bwd.launches
    with pytest.raises(ValueError, match="16 bytes"):
        mbconv.ka_bwd(x, dy2, wexp, g1, b1, wdw, m1, v1, 3)
    assert mbconv.ka_bwd.launches == before


@pytest.mark.parametrize("shape", KA_BWD_SHAPES + [(1, 28, 28, 40, 240, 40,
                                                     5, 10)],
                         ids=lambda s: "x".join(map(str, s)))
def test_mbconv_kb_bwd_at_b0_shapes_repeats(cuda, shape):
    """Kernel 15 at B0's block shapes, a ragged 9 x 9 one and B 1: within
    the MBConv tolerances of its plain version, and a second call bit for
    bit equal to the first (fixed-order sums, no float atomics)."""
    from multimodal_plankton_recognition_torch.ops import mbconv

    k = shape[6]
    (x, wexp, g1, b1, wdw, g2, b2, wr, br, we, be, wproj, dy3,
     _) = _mbconv_inputs(cuda, *shape, seed=4)
    y2, _, _, m2, v2 = mbconv.ka_fwd_reference(x, wexp, g1, b1, wdw, k)
    args = (y2, dy3, g2, b2, m2, v2, wr, br, we, be, wproj)
    before = mbconv.kb_bwd.launches
    got = mbconv.kb_bwd(*args)
    again = mbconv.kb_bwd(*args)
    torch.cuda.synchronize()
    assert mbconv.kb_bwd.launches == before + 2
    _close_to_plain(got, mbconv.kb_bwd_reference(*args), "kb_bwd")
    assert all(torch.equal(g, a) for g, a in zip(got, again))


def test_mbconv_kb_bwd_refuses_unaligned_cout(cuda):
    """A cout that is not a multiple of 8 (16-byte rows of dy3 and wproj)
    is refused before any launch."""
    from multimodal_plankton_recognition_torch.ops import mbconv

    (x, wexp, g1, b1, wdw, g2, b2, wr, br, we, be, wproj, dy3,
     _) = _mbconv_inputs(cuda, 1, 5, 5, 8, 48, 12, 3, 2)
    y2, _, _, m2, v2 = mbconv.ka_fwd_reference(x, wexp, g1, b1, wdw, 3)
    before = mbconv.kb_bwd.launches
    with pytest.raises(ValueError, match="cout = 12.*16 bytes"):
        mbconv.kb_bwd(y2, dy3, g2, b2, m2, v2, wr, br, we, be, wproj)
    assert mbconv.kb_bwd.launches == before


# kernels 13 and 14: B0's shapes and the ragged 9 x 9 one (B 3), B 1, and
# k 5 without an expand
FWD_SHAPES = KA_BWD_SHAPES + [(1, 28, 28, 40, 240, 40, 5, 10),
                              (2, 14, 14, 32, 32, 16, 5, 8)]


@pytest.mark.parametrize("shape", FWD_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
def test_mbconv_ka_fwd_at_b0_shapes_repeats(cuda, shape):
    """Kernel 13 at B0's block shapes: within the MBConv tolerances of its
    plain version, and a second call bit for bit equal to the first
    (fixed-order sums, no float atomics)."""
    from multimodal_plankton_recognition_torch.ops import mbconv

    k = shape[6]
    (x, wexp, g1, b1, wdw, *_) = _mbconv_inputs(cuda, *shape, seed=5)
    args = (x, wexp, g1, b1, wdw, k)
    before = mbconv.ka_fwd.launches
    got = mbconv.ka_fwd(*args)
    again = mbconv.ka_fwd(*args)
    torch.cuda.synchronize()
    assert mbconv.ka_fwd.launches == before + 2
    _close_to_plain(got, mbconv.ka_fwd_reference(*args), "ka_fwd")
    assert all(torch.equal(g, a) for g, a in zip(got, again))


@pytest.mark.parametrize("shape", FWD_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
def test_mbconv_kb_fwd_at_b0_shapes_repeats(cuda, shape):
    """Kernel 14 at B0's block shapes, on the plain y2 and statistics:
    within the MBConv tolerances of its plain version, and a second call
    bit for bit equal to the first."""
    from multimodal_plankton_recognition_torch.ops import mbconv

    k = shape[6]
    (x, wexp, g1, b1, wdw, g2, b2, wr, br, we, be, wproj, *_) = \
        _mbconv_inputs(cuda, *shape, seed=6)
    y2, _, _, m2, v2 = mbconv.ka_fwd_reference(x, wexp, g1, b1, wdw, k)
    args = (y2, g2, b2, m2, v2, wr, br, we, be, wproj)
    before = mbconv.kb_fwd.launches
    got = mbconv.kb_fwd(*args)
    again = mbconv.kb_fwd(*args)
    torch.cuda.synchronize()
    assert mbconv.kb_fwd.launches == before + 2
    _close_to_plain(got, mbconv.kb_fwd_reference(*args), "kb_fwd")
    assert all(torch.equal(g, a) for g, a in zip(got, again))


def test_mbconv_fwd_refuses_unaligned_channels(cuda):
    """Kernels 13 and 14 refuse cin, mid or cout that is not a multiple of
    8 (16-byte rows) before any launch."""
    from multimodal_plankton_recognition_torch.ops import mbconv

    (x, wexp, g1, b1, wdw, *_) = _mbconv_inputs(cuda, 1, 5, 5, 12, 72, 8, 3,
                                                2)
    (_, _, _, _, _, g2, b2, wr, br, we, be, wproj, *_) = _mbconv_inputs(
        cuda, 1, 5, 5, 8, 48, 12, 3, 2)
    y2 = torch.zeros((1, 5, 5, 48), dtype=torch.bfloat16, device=cuda)
    z = torch.zeros(48, device=cuda)
    before = mbconv.ka_fwd.launches, mbconv.kb_fwd.launches
    with pytest.raises(ValueError, match="cin = 12.*kernels 13-16"):
        mbconv.ka_fwd(x, wexp, g1, b1, wdw, 3)
    with pytest.raises(ValueError, match="cout = 12.*kernels 13-16"):
        mbconv.kb_fwd(y2, g2, b2, z, z, wr, br, we, be, wproj)
    assert (mbconv.ka_fwd.launches, mbconv.kb_fwd.launches) == before


def test_checkpoint_round_trip_on_the_card(cuda, tmp_path):
    """The ViT flagship's card (batch 32) trained 2 steps on the card,
    saved, and ``load_from_checkpoint(..., device="cuda")``: the module's
    parameters are the masters in bf16 bit for bit, and it encodes a batch
    bit for bit as the in-memory module holding the same masters."""
    from multimodal_plankton_recognition_torch.config import ModelCard
    from multimodal_plankton_recognition_torch.models.build import (
        build_multi_model, step_buckets,
    )
    from multimodal_plankton_recognition_torch.models.flagships import (
        flagship_card, init_weights_, synthetic_batch_vit,
    )
    from multimodal_plankton_recognition_torch.retrieval.encode import (
        encode_arrays,
    )
    from multimodal_plankton_recognition_torch.train import (
        create_train_state, make_multi_steps, make_optimizer,
    )
    from multimodal_plankton_recognition_torch.train.checkpoint import (
        CheckpointManager, load_from_checkpoint,
    )

    d = flagship_card("vit")
    d["bs"] = 32
    card = ModelCard.from_dict(d)
    model = build_multi_model(card).to(cuda)
    init = init_weights_(build_multi_model(card, dtype=torch.float32),
                         torch.Generator().manual_seed(0)).state_dict()
    tx = make_optimizer(card.optim_args)
    state = create_train_state(model, init, tx)
    step, _ = make_multi_steps(model, tx, step_buckets(card))
    batch = synthetic_batch_vit(32, seed=1, device=cuda)
    for _ in range(2):
        state, _ = step(state, batch, 0)
    mngr = CheckpointManager(tmp_path, metadata={
        "card": card.to_dict(), "kind": "multi", "class_names": []})
    assert mngr.save(0, state, {"valid_loss": 1.0})
    restored, payload, _ = load_from_checkpoint(tmp_path, device="cuda")
    assert all(t.device.type == "cpu" for t in payload["params"].values())
    params = dict(restored.named_parameters())
    for n, m in state.params.items():
        assert params[n].device == m.device
        assert torch.equal(params[n], m.to(params[n].dtype)), n
    state.load_into(model)
    labels = torch.arange(32).numpy()
    want = encode_arrays(model, batch, labels, 16, cuda)
    got = encode_arrays(restored, batch, labels, 16, cuda)
    for key in ("image", "profile"):
        assert (got[key] == want[key]).all(), key


def test_augment_on_the_card_equals_the_cpu_apply(cuda):
    """``apply_augment`` on CUDA tensors equals its CPU run on the same
    draws, and ``multi_train_augment`` on a CUDA batch uses the draws of
    its (CPU) generator, for every tokenize contract."""
    from multimodal_plankton_recognition_torch.ops.augment import (
        apply_augment, draw_augment, multi_train_augment,
    )

    gen = torch.Generator().manual_seed(0)
    batch = {"image": torch.rand(8, 236, 236, 1, generator=gen) * 2 - 1,
             "profile": torch.randn(8, 236, 6, generator=gen),
             "image_shape": torch.randint(50, 400, (8, 2), generator=gen,
                                          dtype=torch.int32)}
    on_card = {k: v.to(cuda) for k, v in batch.items()}
    for kind in ("transformer", "lstm", "cnn"):
        draws = draw_augment(batch, 224, torch.Generator().manual_seed(1))
        want = apply_augment(batch, draws, 224, kind)
        got = apply_augment(on_card, draws, 224, kind)
        again = multi_train_augment(on_card, 224,
                                    torch.Generator().manual_seed(1), kind)
        torch.cuda.synchronize()
        assert sorted(got) == sorted(want) == sorted(again)
        for k in want:
            assert got[k].device.type == "cuda", k
            assert torch.equal(got[k].cpu(), want[k]), (kind, k)
            assert torch.equal(again[k].cpu(), want[k]), (kind, k)


def test_driver_trains_a_packed_card_on_the_card(cuda, tmp_path):
    """``train.drivers.train_multi`` on a small bf16 SigLIP card from
    packed pairs (``chip_smoke.write_packed_splits``, numpy alone): 2
    epochs on the card through pinned batches and the non-blocking put,
    the SigLIP kernels launched once a micro-step each and once an eval
    step, finite losses, a checkpoint kept."""
    import importlib.util
    from pathlib import Path

    from multimodal_plankton_recognition_torch.config import ModelCard
    from multimodal_plankton_recognition_torch.ops import contrastive
    from multimodal_plankton_recognition_torch.train import drivers

    repo = Path(__file__).resolve().parent.parent
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  repo / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    root = smoke.write_packed_splits(tmp_path / "data", 32, 48, 16, 4,
                                     seed=0)
    card = ModelCard.from_dict({
        "bs": 8, "buckets": 2, "target_size": 32, "dim_embedding": 32,
        "num_workers": 2, "save_top_k": 1, "packed_cache": True,
        "image_encoder_args": {
            "name": "vit_tiny_patch16_224", "in_chans": 1,
            "metadata": True, "fused_attention": True, "dropout": 0.1,
            "backbone_kwargs": {"img_size": 32, "depth": 2,
                                "embed_dim": 48, "num_heads": 3}},
        "profile_encoder_args": {
            "kind": "transformer", "dim_in": 6, "dim_hidden": 64,
            "num_layers": 2, "num_head": 4, "target_size": 32,
            "dim_feedforward": 96, "fused_attention": True, "dropout": 0.1},
        "coordination_args": {"method": "siglip", "fused": True},
        "trainer_args": {"precision": "16-mixed", "max_epochs": 2}})
    train_set, test_set = drivers.multi_datasets(card, root)
    loader, _ = drivers.multi_loaders(card, train_set, test_set, cuda)
    assert all(t.is_pinned() for t in next(iter(loader)).values())
    for fn in (contrastive.siglip_fwd, contrastive.siglip_bwd):
        fn.launches = 0
    out = drivers.train_multi(root, card, logdir=tmp_path / "logs",
                              device="cuda")
    torch.cuda.synchronize()
    train_steps, eval_steps = 48 // 8, 16 // 8
    assert contrastive.siglip_fwd.launches == 2 * (train_steps + eval_steps)
    assert contrastive.siglip_bwd.launches == 2 * train_steps
    assert out["state"].step == 2 * train_steps
    assert all(m.device.type == "cuda" and m.dtype == torch.float32
               for m in out["state"].params.values())
    assert all(torch.isfinite(torch.tensor([h["train_loss"],
                                            h["valid_loss"]])).all()
               for h in out["history"])
    assert out["best_step"] in (0, 1)


@pytest.mark.parametrize("kind", ["image", "profile"])
def test_classifier_step_launches_the_attention_kernels(cuda, kind):
    """A bf16 classifier's train step on the card (a 2-block ViT at 32 px,
    or a 2-layer profile transformer over 257 tokens with padding) runs
    every attention layer through kernels 1 and 2, its eval step through
    kernel 1; loss, gradients and predictions finite."""
    import numpy as np

    from multimodal_plankton_recognition_torch.config import ModelCard
    from multimodal_plankton_recognition_torch.data.tokenize import (
        tokenize_transformer,
    )
    from multimodal_plankton_recognition_torch.models.build import (
        build_for_kind,
    )
    from multimodal_plankton_recognition_torch.models.initializers import (
        init_weights_,
    )
    from multimodal_plankton_recognition_torch.train import (
        create_train_state, make_classifier_steps, make_optimizer,
    )

    d = {"bs": 8, "target_size": 32, "max_len": 256,
         "trainer_args": {"precision": "16-mixed"}}
    rs = np.random.RandomState(0)
    label = torch.arange(8, device=cuda) % 5
    if kind == "image":
        d["image_encoder_args"] = {
            "name": "vit_tiny_patch16_224", "in_chans": 1, "dropout": 0.1,
            "fused_attention": True,
            "backbone_kwargs": {"img_size": 32, "depth": 2, "embed_dim": 48,
                                "num_heads": 3}}
        batch = {"image": torch.randn(8, 32, 32, 1, device=cuda),
                 "image_shape": torch.randint(50, 400, (8, 2), device=cuda)}
    else:
        d["profile_encoder_args"] = {
            "kind": "transformer", "dim_in": 6, "dim_hidden": 64,
            "num_layers": 2, "num_head": 4, "target_size": 256,
            "dim_feedforward": 96, "fused_attention": True, "dropout": 0.1}
        tokens = tokenize_transformer(
            [rs.randn(n, 6).astype(np.float32)
             for n in rs.randint(100, 257, 8)], 256, pad_to=257)
        batch = {k: torch.as_tensor(v).to(cuda) for k, v in tokens.items()}
        batch["profile_len"] = torch.randint(20, 2000, (8, 1), device=cuda)
    card = ModelCard.from_dict(d)
    names = [f"c{i}" for i in range(5)]
    model = build_for_kind(card, kind, names).to(cuda)
    init = init_weights_(build_for_kind(card, kind, names,
                                        dtype=torch.float32),
                         torch.Generator().manual_seed(0)).state_dict()
    tx = make_optimizer(card.optim_args)
    state = create_train_state(model, init, tx)
    train_step, eval_step = make_classifier_steps(model, tx)
    before = (mha_qkv.launches, mha_qkv_bwd.launches)
    state, loss = train_step(state, {**batch, "label": label}, 0)
    assert (mha_qkv.launches - before[0], mha_qkv_bwd.launches - before[1]) \
        == (2, 2)
    out = eval_step(state, {**batch, "label": label})
    torch.cuda.synchronize()
    assert mha_qkv.launches - before[0] == 4
    assert torch.isfinite(loss) and torch.isfinite(out["loss"])
    assert out["pred"].shape == (8,) and out["pred"].max() < 5
    assert all(torch.isfinite(p.grad).all() for p in model.parameters())


def test_knn_on_the_card_predicts_as_the_cpu(cuda):
    """``ANNClassifier`` with its index on the card gives the CPU index's
    predictions on continuous random embeddings (TF32 off)."""
    import numpy as np

    from multimodal_plankton_recognition_torch.ops.knn import ANNClassifier

    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        rs = np.random.RandomState(0)
        gallery = rs.randn(600, 64).astype(np.float32)
        labels = rs.randint(0, 12, 600)
        queries = [rs.randn(300, 64).astype(np.float32) for _ in range(2)]
        got = ANNClassifier(gallery, labels, cuda).predict_many(
            *queries, ks=(1, 5, 15))
        want = ANNClassifier(gallery, labels, "cpu").predict_many(
            *queries, ks=(1, 5, 15))
        for k in (1, 5, 15):
            np.testing.assert_array_equal(got[k], want[k])
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


@pytest.mark.parametrize("label", ["resnet18", "lstm_1"])
def test_module_6_classifier_step_matches_the_cpu(cuda, label):
    """A resnet18 (32 px) and an lstm_1 (128 wide, 64 ragged steps)
    classifier's f32 train step on the card against the same step on the
    CPU, from the same seeded weights (TF32 off): the loss within 1e-4
    relative, the running statistics within 1e-4, the gradients' median
    relative L2 within 1e-3 and each within 5e-2 (cuDNN and the CPU sum
    in other orders, and a pre-activation that lands on the other side
    of a ReLU moves a gradient by a few percent); no kernel of the
    port."""
    import numpy as np

    from multimodal_plankton_recognition_torch.config import ModelCard
    from multimodal_plankton_recognition_torch.data.tokenize import (
        tokenize_lstm,
    )
    from multimodal_plankton_recognition_torch.models.build import (
        build_for_kind,
    )
    from multimodal_plankton_recognition_torch.models.initializers import (
        init_weights_,
    )
    from multimodal_plankton_recognition_torch.train import (
        create_train_state, make_classifier_steps, make_optimizer,
    )

    rs = np.random.RandomState(0)
    d = {"bs": 8, "target_size": 32, "max_len": 64,
         "trainer_args": {"precision": "32"}}
    if label == "resnet18":
        kind = "image"
        d["image_encoder_args"] = {"name": "resnet18", "dropout": 0.0}
        batch = {"image": rs.randn(8, 32, 32, 1).astype(np.float32),
                 "image_shape": rs.randint(50, 400, (8, 2))}
    else:
        kind = "profile"
        d["profile_encoder_args"] = {"kind": "lstm", "dim_hidden": 128,
                                     "num_layers": 1, "dropout": 0.0}
        batch = tokenize_lstm([rs.randn(n, 6).astype(np.float32)
                               for n in rs.randint(20, 65, 8)], pad_to=64)
        batch["profile_len"] = rs.randint(20, 2000, (8, 1))
    batch["label"] = np.arange(8) % 5
    card = ModelCard.from_dict(d)
    names = [f"c{i}" for i in range(5)]
    init = init_weights_(build_for_kind(card, kind, names),
                         torch.Generator().manual_seed(0)).state_dict()
    old = torch.backends.cuda.matmul.allow_tf32, \
        torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    counts = {n: getattr(f, "launches") for n, f in _port_kernels().items()}
    try:
        runs = {}
        for device in ("cpu", cuda):
            model = build_for_kind(card, kind, names).to(device)
            tx = make_optimizer(card.optim_args)
            state = create_train_state(model, init, tx)
            train_step, _ = make_classifier_steps(model, tx)
            state, loss = train_step(state, {k: torch.as_tensor(v).to(device)
                                             for k, v in batch.items()}, 0)
            runs[str(device)] = (
                loss.item(),
                {n: p.grad.double().cpu()
                 for n, p in model.named_parameters()},
                {n: b.cpu() for n, b in model.named_buffers()})
    finally:
        torch.backends.cuda.matmul.allow_tf32, \
            torch.backends.cudnn.allow_tf32 = old
    assert counts == {n: getattr(f, "launches")
                      for n, f in _port_kernels().items()}
    (loss, grads, stats), (want_loss, want_grads, want_stats) = \
        runs[str(cuda)], runs["cpu"]
    assert abs(loss - want_loss) <= 1e-4 * abs(want_loss)
    rel = [((grads[n] - g).norm() / g.norm().clamp_min(1e-30)).item()
           for n, g in want_grads.items()]
    assert np.median(rel) <= 1e-3 and max(rel) <= 5e-2, max(rel)
    for n, b in want_stats.items():
        assert (stats[n] - b).abs().max() <= 1e-4 * max(1.0, b.abs().max())


def _port_kernels():
    from multimodal_plankton_recognition_torch.ops import (
        attention, contrastive, ffn, mbconv,
    )
    return {"mha_qkv": attention.mha_qkv, "mha_qkv_bwd": attention.mha_qkv_bwd,
            "ffn_fwd": ffn.ffn_fwd, "clip_fwd": contrastive.clip_fwd,
            "ka_fwd": mbconv.ka_fwd, "kb_fwd": mbconv.kb_fwd,
            "kb_bwd": mbconv.kb_bwd, "ka_bwd": mbconv.ka_bwd}


@pytest.mark.parametrize("remat", [True, "conv_saves"])
def test_remat_relaunches_kernels_13_14_and_updates_once(cuda, remat):
    """B0 with ``fused`` in bf16 at 32 px, B 8, one train-mode step with
    and without ``remat``: under remat kernels 13 and 14 run twice a
    stride-1 block (the recompute), 15 and 16 once; the gradients and the
    running statistics equal the no-remat step's bit for bit (one
    update)."""
    from multimodal_plankton_recognition_torch.models.image.efficientnet import (  # noqa: E501
        EfficientNet,
    )
    from multimodal_plankton_recognition_torch.models.initializers import (
        init_weights_,
    )
    from multimodal_plankton_recognition_torch.ops import mbconv

    kernels = (mbconv.ka_fwd, mbconv.kb_fwd, mbconv.kb_bwd, mbconv.ka_bwd)
    x = torch.randn(8, 32, 32, 1, generator=torch.Generator().manual_seed(1))
    runs = {}
    for mode in (False, remat):
        model = init_weights_(EfficientNet(fused=True, remat=mode),
                              torch.Generator().manual_seed(0))
        model = model.to(cuda, torch.bfloat16).train()
        before = [k.launches for k in kernels]
        model(x.to(cuda)).float().square().mean().backward()
        torch.cuda.synchronize()
        runs[mode] = ([k.launches - b for k, b in zip(kernels, before)],
                      {n: p.grad.clone() for n, p in model.named_parameters()},
                      {n: b.clone() for n, b in model.named_buffers()})
    assert runs[False][0] == [12, 12, 12, 12]
    assert runs[remat][0] == [24, 24, 12, 12]
    for n, g in runs[False][1].items():
        assert torch.equal(runs[remat][1][n], g), n
    for n, b in runs[False][2].items():
        assert torch.equal(runs[remat][2][n], b), n
