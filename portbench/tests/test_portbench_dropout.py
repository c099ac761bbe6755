"""The dropout numbers: the reference's statistics hold on sound
dropout drawn here and fail under each fault; the taps keep one call of
each kind of the program's dropout and change nothing."""

import math

import pytest
import torch

from multimodal_plankton_recognition_torch.models import attention as port_attn
from multimodal_plankton_recognition_torch.models import dropout as port_drop
from multimodal_plankton_recognition_torch.models.image import vit as port_vit
from multimodal_plankton_recognition_torch.ops import attention as port_ops
from portbench.harness.taps import tap_dropout
from portbench.reference.dropout import attention_numbers, \
    elementwise_numbers

P = 0.1


def _attention(gen, rate, scale, b=8, l=33, heads=4, d=16, shift=0.0):
    """(qkv, bias, o): o the dropped attention of qkv at ``rate``, kept
    probabilities times ``scale``; ``shift`` added to every value."""
    qkv = torch.randn(b, l, 3 * heads * d, generator=gen)
    qkv[..., 2 * heads * d:] += shift
    qkv = qkv.bfloat16().float()
    bias = torch.where(torch.arange(l) >= l - 5, -1e9, 0.0).expand(b, l)
    x = qkv.reshape(b, l, 3, heads, d)
    q, k, v = (x[:, :, j].transpose(1, 2) for j in range(3))
    prob = torch.softmax(q @ k.transpose(-1, -2) / math.sqrt(d)
                         + bias[:, None, None, :], dim=-1)
    keep = torch.bernoulli(torch.full(prob.shape, 1 - rate), generator=gen)
    o = (prob * keep * scale) @ v
    return qkv, bias, o.transpose(1, 2).reshape(b, l, heads * d)


@pytest.mark.parametrize("rate,scale,sound", [
    (P, 1 / (1 - P), True), (0.0, 1.0, False), (P, 1.0, False),
    (2 * P, 1 / (1 - 2 * P), False)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_numbers(rate, scale, sound, dtype):
    """In float32 and rounded to bfloat16, with a common part in v that
    makes the rounding as large as the dropout's spread on some rows."""
    gen = torch.Generator().manual_seed(3)
    qkv, bias, o = _attention(gen, rate, scale, shift=3.0)
    numbers = attention_numbers(qkv.to(dtype), bias, 4, P, o.to(dtype))
    assert (max(numbers.values()) < 4.0) == sound, numbers


@pytest.mark.parametrize("rate,scale,sound", [
    (P, 1 / (1 - P), True), (0.0, 1.0, False), (P, 1.0, False),
    (2 * P, 1 / (1 - 2 * P), False)])
def test_elementwise_numbers(rate, scale, sound):
    gen = torch.Generator().manual_seed(4)
    x = torch.randn(64, 200, generator=gen).bfloat16()
    keep = torch.bernoulli(torch.full(x.shape, 1 - rate), generator=gen)
    y = x * keep.bfloat16() * scale
    numbers = elementwise_numbers(x, y, P)
    held = numbers["drop_share_z"] < 4.0 and numbers["drop_scale_gap"] < 0.02
    assert held == sound, numbers


def test_taps_keep_one_call_of_each_and_change_nothing():
    """Through the names the model modules call them by: the first call
    at a rate above 0 of each kind is kept, every output is as untapped,
    and the names point back at the program's own functions after."""
    qkv = torch.randn(2, 9, 3 * 32, dtype=torch.bfloat16)
    x = torch.randn(4, 16, dtype=torch.bfloat16)

    def calls():
        with port_drop.dropout_rng(torch.Generator().manual_seed(5)):
            return (port_attn.mha_qkv(qkv, None, 2, P, 11),
                    port_attn.mha_qkv(qkv, None, 2, 0.0, 0),
                    port_vit.dropout(x, P, True))

    plain = calls()
    record = {}
    with tap_dropout(record):
        tapped = calls()
    for a, b in zip(plain, tapped):
        assert torch.equal(a, b)
    assert port_attn.mha_qkv is port_ops.mha_qkv
    assert port_vit.dropout is port_drop.dropout
    assert set(record) == {"attention", "elementwise"}
    assert len(record["attention"]) == 1  # the second call is at p 0
    assert record["attention"][0][3] == P
    assert torch.equal(record["attention"][0][4], plain[0])
    assert torch.equal(record["elementwise"][1], plain[2])
