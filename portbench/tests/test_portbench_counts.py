"""The frozen counts: model FLOPs against torch's own count of the
reference at the cells' shapes and against counts by hand; the attention
work and the least time by hand."""

import json

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench.counts import attention, model_flops, peaks
from portbench.counts.encoders import count_file
from portbench.harness.manifest import ROOT, load_manifest
from portbench.reference.multi import MultiModel, clip_loss

CARDS = {c["name"]: json.loads((ROOT / c["file"]).read_text())["card"]
         for c in load_manifest()["configs"]}


def _meta_batch(card, b):
    s = card["target_size"]
    batch = {"image": torch.zeros(b, s, s, 1),
             "image_shape": torch.zeros(b, 2),
             "profile_len": torch.zeros(b, 1)}
    if card["profile_encoder_args"]["kind"] == "transformer":
        batch.update(profile=torch.zeros(b, s + 1, 6),
                     time=torch.zeros(b, s + 1, dtype=torch.long),
                     padding_mask=torch.zeros(b, s + 1, dtype=torch.bool))
    else:
        batch["profile"] = torch.zeros(b, s, 6)
    return batch


@pytest.mark.parametrize("name", sorted(CARDS))
def test_forward_flops_match_torch_count_of_reference(name):
    """Every product of the reference's forward and loss at the cell's
    shapes (meta tensors: nothing runs), as torch counts them."""
    card, b, buckets = CARDS[name], 32, 2
    with torch.device("meta"):
        model = MultiModel(card)
        with FlopCounterMode(display=False) as fc:
            img, prof = model.encode(_meta_batch(card, b), stats={})
            clip_loss(img, prof, model.coordination.logit_scale, buckets)
    assert fc.get_total_flops() == model_flops.forward_flops(card, b) \
        + model_flops.clip_flops(card, b, buckets)
    assert model_flops.train_step_flops(card, b, buckets) \
        == 3 * fc.get_total_flops()


def test_vit_card_by_hand():
    """ViT-T/16 at 224: 196 patches of 256 pixels into 192; 12 blocks over
    197 tokens (q|k|v, q kᵀ, P v, out, MLP 768); the profile transformer:
    6 → 128 over 225 tokens, 2 layers of FFN 1,024; projections 194 and
    129 → 512; 2 operations a multiply-add."""
    vit = 2 * 196 * 256 * 192 + 12 * (
        2 * 197 * 192 * 576 + 2 * 2 * 197 * 197 * 192
        + 2 * 197 * 192 * 192 + 2 * 2 * 197 * 192 * 768)
    prof = 2 * 225 * 6 * 128 + 2 * (
        2 * 225 * 128 * 384 + 2 * 2 * 225 * 225 * 128
        + 2 * 225 * 128 * 128 + 2 * 2 * 225 * 128 * 1024)
    proj = 2 * 512 * (194 + 129)
    assert model_flops.forward_flops(CARDS["vit_t16_tf2_clip"], 1) \
        == vit + prof + proj
    assert model_flops.clip_flops(CARDS["vit_t16_tf2_clip"], 256, 16) \
        == 2 * 256 * 16 * 512
    # the kNN: two query modalities against 18,706 fused rows of 512
    assert model_flops.knn_flops(CARDS["vit_t16_tf2_clip"], 256, 18706) \
        == 2 * 2 * 256 * 18706 * 512


def test_b0_stem_and_head_by_hand():
    """B0's stem (3x3, stride 2, 1 → 32 at 112²) and head (320 → 1,280 at
    7²) are part of its count; the profile CNN's stem (k 3, stride 2, 6 →
    32 over 112 steps)."""
    card = CARDS["effb0_cnn2_clip"]
    img, prof = card["image_encoder_args"], card["profile_encoder_args"]
    b0 = count_file(img, "image").flops(img, 224)
    assert b0 > 2 * 112 * 112 * 9 * 32 + 2 * 7 * 7 * 320 * 1280
    cnn = count_file(prof, "profile").flops(prof, 224)
    assert cnn > 2 * 112 * 3 * 6 * 32
    assert model_flops.encoder_dims(card) == {
        "image": 1280 + 2, "profile": 256 + 1, "embed": 512}


@pytest.mark.parametrize("role,args", [
    ("image", {"name": "resnet50"}),
    ("profile", {"kind": "lstm"})])
def test_an_encoder_without_a_count_file_is_refused(role, args):
    """No count falls back to another architecture's: an encoder with no
    file under counts/encoders/ raises, for the FLOPs and for the
    attention calls alike."""
    card = dict(CARDS["vit_t16_tf2_clip"])
    card[f"{role}_encoder_args"] = args
    with pytest.raises(NotImplementedError, match="no count"):
        count_file(args, role)
    with pytest.raises(NotImplementedError):
        model_flops.forward_flops(card, 1)
    with pytest.raises(NotImplementedError):
        attention.attention_calls(card, 1)


def test_attention_work_by_hand():
    card = CARDS["vit_t16_tf2_clip"]
    calls = attention.attention_calls(card, 256, profile_keys=170.0)
    assert calls == [(256, 197, 3, 64, 197, False)] * 12 \
        + [(256, 225, 4, 32, 170.0, True)] * 2
    nbytes, flops = attention.forward_work(calls[0])
    assert nbytes == 256 * 197 * 576 * 2 + 256 * 197 * 192 * 2
    assert flops == 4 * 256 * 197 * 197 * 192
    nbytes, flops = attention.backward_work(calls[-1])
    assert nbytes == 2 * 256 * 225 * 384 * 2 + 256 * 225 * 128 * 2 \
        + 256 * 225 * 4
    assert flops == 8 * 256 * 225 * 170.0 * 128
    assert attention.attention_calls(CARDS["effb0_cnn2_clip"], 256) == []


def test_least_time_is_the_larger_bound():
    assert peaks.least_time_s(3.35e12) == pytest.approx(1.0)
    assert peaks.least_time_s(0, bf16_flops=989e12) == pytest.approx(1.0)
    assert peaks.least_time_s(3.35e12, 2 * 989e12, 67e12) \
        == pytest.approx(3.0)
