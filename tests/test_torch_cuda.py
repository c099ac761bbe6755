"""The attention kernel on a CUDA card, against its plain version.

Marked ``gpu``: each test skips without a CUDA card. On the card:

    python -m pytest -m gpu --noconftest tests/test_torch_cuda.py -q

Tolerance 2e-2 in bf16: both sides accumulate in f32 and round the output
to bf16 (one bf16 step is 7.8e-3 between 1 and 2), but sum in another
order, so an output can land one step apart.
"""

import pytest
import torch

from multimodal_plankton_recognition_torch.models.attention import (
    FusedSelfAttention,
)
from multimodal_plankton_recognition_torch.ops.attention import (
    SUPPORTED_HEAD_DIMS, mha_qkv, mha_qkv_reference,
)

pytestmark = pytest.mark.gpu
TOL = 2e-2


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
@pytest.mark.parametrize("b,l,heads", [(1, 1, 1), (3, 33, 2), (2, 100, 5)])
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
    torch.manual_seed(0)
    fused = FusedSelfAttention(192, 8).to(cuda, torch.bfloat16)
    plain = FusedSelfAttention(192, 8, fused=False).to(cuda, torch.bfloat16)
    plain.load_state_dict(fused.state_dict())
    x = torch.randn((4, 225, 192), device=cuda).to(torch.bfloat16)
    mask = torch.zeros((4, 225), dtype=torch.bool, device=cuda)
    mask[:, 150:] = True
    before = mha_qkv.launches
    with torch.inference_mode():
        got, want = fused(x, mask), plain(x, mask)
    assert mha_qkv.launches == before + 1
    assert (got.float() - want.float()).abs().max().item() <= TOL


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
    """Too long a sequence for shared memory: the launch is refused and
    the wrapper raises instead of returning garbage."""
    qkv, _ = _inputs(cuda, 1, 4000, 1, 64, False)
    with pytest.raises(RuntimeError, match="launch failed"):
        mha_qkv(qkv, None, 1)
