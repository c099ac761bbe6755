"""Serving-slice parity: the port's small ``MultiModel`` (ViT +
ProfileTransformer) against the JAX package's on converted weights —
``encode`` -> ``l2_normalize`` on arrays, and ``encode_csv`` against the
JAX ``retrieval.encode._encode_csv`` on the synthetic dataset.

Tolerances: 1e-4 in f32 (conftest sets the JAX matmul precision to
"highest", so both sides multiply in full f32); 5e-2 in bf16 on the
normalized embeddings, where the two frameworks round intermediate bf16
values (LayerNorm, GELU, residual sums) at different points. The bf16
batch has a padded profile and image shapes / profile lengths above 256,
so the bf16 rounding of the metadata features is exercised.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_plankton_recognition_tpu.models.multi import (
    MultiModel as JaxMultiModel,
)
from multimodal_plankton_recognition_tpu.ops.losses import (
    l2_normalize as jax_l2_normalize,
)
from multimodal_plankton_recognition_torch.convert import load_flax
from multimodal_plankton_recognition_torch.data.tokenize import (
    tokenize_transformer,
)
from multimodal_plankton_recognition_torch.models.multi import MultiModel
from multimodal_plankton_recognition_torch.ops.losses import l2_normalize
from multimodal_plankton_recognition_torch.retrieval.encode import (
    encode_arrays, encode_csv,
)
from torch_threads import one_thread  # noqa: F401  (autouse)


def _model_args(img: int, target_size: int) -> dict:
    return dict(
        dim_embed=32,
        image_encoder_args={
            "name": "vit_tiny_patch16_224", "in_chans": 1, "metadata": True,
            "fused_attention": True,
            "backbone_kwargs": {"img_size": img, "depth": 2, "embed_dim": 48,
                                "num_heads": 3}},
        profile_encoder_args={
            "kind": "transformer", "dim_in": 6, "dim_hidden": 64,
            "num_layers": 2, "num_head": 4, "target_size": target_size,
            "dim_feedforward": 96, "fused_attention": True},
        coordination_args={"method": "clip", "fused": True})


def _batch(bs: int = 6, img: int = 32, target_size: int = 16, seed: int = 0):
    rs = np.random.RandomState(seed)
    lengths = rs.randint(3, target_size + 1, bs)
    lengths[0] = target_size
    tokens = tokenize_transformer(
        [rs.randn(n, 6).astype(np.float32) for n in lengths], target_size,
        pad_to=target_size + 1)
    assert tokens["padding_mask"].any()
    return {"image": rs.randn(bs, img, img, 1).astype(np.float32),
            "image_shape": rs.randint(200, 400, (bs, 2)).astype(np.int32),
            "profile_len": rs.randint(100, 2000, (bs, 1)).astype(np.int32),
            **tokens}


def _jax_model(dtype, img=32, target_size=16):
    model = JaxMultiModel(dtype=dtype, **_model_args(img, target_size))
    jbatch = {k: jnp.asarray(v)
              for k, v in _batch(img=img, target_size=target_size).items()}
    variables = jax.jit(lambda key: model.init(key, **jbatch))(
        jax.random.key(0))
    return model, variables


def _port_model(variables, dtype, img=32, target_size=16):
    model = MultiModel(dtype=dtype, **_model_args(img, target_size))
    load_flax(model, jax.tree.map(np.asarray, variables))
    return model.eval()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encode_matches_jax(dtype, monkeypatch):
    jmodel, variables = _jax_model(getattr(jnp, dtype))
    batch = _batch(seed=1)
    if dtype == "bfloat16":  # JAX side through the Pallas kernel (interpret)
        monkeypatch.setenv("PLANKTON_FUSED_INTERPRET", "1")
    jemb = jax.jit(lambda v, b: jmodel.apply(v, method="encode",
                                             train=False, **b))(
        variables, {k: jnp.asarray(v) for k, v in batch.items()})

    model = _port_model(variables, getattr(torch, dtype))
    with torch.inference_mode():
        emb = model.encode(**{k: torch.from_numpy(v)
                              for k, v in batch.items()})
    tol = 1e-4 if dtype == "float32" else 5e-2
    for key in ("image_emb", "profile_emb"):
        assert emb[key].dtype == getattr(torch, dtype)
        np.testing.assert_allclose(
            l2_normalize(emb[key]).float().numpy(),
            np.asarray(jax_l2_normalize(jemb[key]), np.float32),
            rtol=tol, atol=tol, err_msg=key)


def test_encode_arrays_batches_and_layout():
    """Batching does not change the embeddings; the flat layout holds
    unit-norm f32 rows and the labels."""
    _, variables = _jax_model(jnp.float32)
    model = _port_model(variables, torch.float32)
    batch = _batch(bs=5, seed=2)
    labels = np.arange(5) % 2
    whole = encode_arrays(model, batch, labels, batch_size=5, device="cpu")
    split = encode_arrays(model, batch, labels, batch_size=2, device="cpu")
    assert sorted(whole) == ["image", "label", "profile"]
    for key in ("image", "profile"):
        assert whole[key].dtype == np.float32 and whole[key].shape == (5, 32)
        np.testing.assert_allclose(np.linalg.norm(whole[key], axis=1), 1.0,
                                   rtol=1e-5)
        np.testing.assert_allclose(split[key], whole[key],
                                   rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(whole["label"], labels)


def test_encode_csv_matches_jax(synthetic_dataset):
    from multimodal_plankton_recognition_tpu.config import ModelCard
    from multimodal_plankton_recognition_tpu.retrieval.encode import (
        _encode_csv,
    )

    ts = 32  # card target_size = ViT img_size = profile resample length
    args = _model_args(ts, ts)
    card = ModelCard.from_dict({
        "target_size": ts, "image_encoder_args": args["image_encoder_args"],
        "profile_encoder_args": args["profile_encoder_args"]})
    jmodel, variables = _jax_model(jnp.float32, img=ts, target_size=ts)
    csv = synthetic_dataset / "test.csv"
    want = _encode_csv(jmodel, variables, card, csv, batch_size=5,
                       num_workers=1)
    model = _port_model(variables, torch.float32, img=ts, target_size=ts)
    got = encode_csv(model, csv, ts, batch_size=5, num_workers=1,
                     device="cpu")
    for key in ("image", "profile"):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-4, atol=1e-4,
                                   err_msg=key)
    np.testing.assert_array_equal(got["label"], want["label"])


def test_entry_points_default_to_the_card(monkeypatch):
    """``encode_arrays``, ``encode_csv`` and ``ANNClassifier`` run on the
    card unless told otherwise: without a card, a call that names no device
    raises instead of returning a CPU result."""
    from multimodal_plankton_recognition_torch.ops.knn import ANNClassifier

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, variables = _jax_model(jnp.float32)
    model = _port_model(variables, torch.float32)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        encode_arrays(model, _batch(bs=2), np.arange(2))
    with pytest.raises(RuntimeError, match="no CUDA card"):
        encode_csv(model, "unused.csv", 16)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        ANNClassifier(np.zeros((3, 4), np.float32), np.arange(3))
