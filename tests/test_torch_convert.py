"""Weight bridge: the full ViT flagship's Flax tree converts into the
port's flagship with no leaf left over and no parameter left unset; an
unknown or missing leaf raises."""

import jax
import numpy as np
import pytest
import torch

from multimodal_plankton_recognition_tpu.models.flagships import (
    flagship_vit as jax_flagship_vit,
    synthetic_batch_vit as jax_synthetic_batch_vit,
)
from multimodal_plankton_recognition_torch.convert import from_flax, load_flax
from multimodal_plankton_recognition_torch.models.flagships import (
    flagship_vit, synthetic_batch_vit,
)
from torch_threads import one_thread  # noqa: F401  (autouse)


@pytest.fixture(scope="module")
def flagship_variables():
    """Init only (one sample): the full-width tree, no forward is compared."""
    batch = jax_synthetic_batch_vit(1)
    variables = jax.jit(lambda key: jax_flagship_vit().init(key, **batch))(
        jax.random.key(0))
    return jax.tree.map(np.asarray, variables)


def test_full_flagship_tree_converts(flagship_variables):
    model = flagship_vit()
    load_flax(model, flagship_variables)  # strict: raises on any mismatch
    state = from_flax(flagship_variables)
    n_flax = sum(x.size for x in jax.tree.leaves(flagship_variables))
    assert sum(t.numel() for t in state.values()) == n_flax
    assert sum(p.numel() for p in model.parameters()) == n_flax
    # 12 ViT blocks + 2 profile layers, each one packed (3E, E) projection
    qkv = [k for k in state if k.endswith("qkv.weight")]
    assert len(qkv) == 14 and all(state[k].shape == (576, 192) for k in qkv)
    assert model.image_encoder.backbone.pos_embed.dtype == torch.bfloat16
    assert model.coordination.logit_scale.dtype == torch.float32
    pe = flagship_variables["params"]["vit_tiny_patch16_224"]["backbone"][
        "patch_embed"]["kernel"]  # HWIO
    np.testing.assert_array_equal(
        state["image_encoder.backbone.patch_embed.weight"].numpy(),
        pe.transpose(3, 2, 0, 1))


def test_unknown_leaf_raises(flagship_variables):
    params = dict(flagship_variables["params"])
    params["profile_encoder"] = dict(params["profile_encoder"],
                                     mystery={"gamma": np.ones(3, np.float32)})
    with pytest.raises(KeyError, match="mystery/gamma"):
        from_flax({"params": params})
    with pytest.raises(KeyError, match="only a 'params' collection"):
        from_flax({**flagship_variables, "cache": {}})


def test_missing_leaf_raises(flagship_variables):
    params = dict(flagship_variables["params"])
    params.pop("profile_projection")
    with pytest.raises(RuntimeError, match="profile_projection.weight"):
        load_flax(flagship_vit(), {"params": params})


def _small_args(coordination_args):
    return dict(
        dim_embed=32,
        image_encoder_args={
            "name": "vit_tiny_patch16_224", "in_chans": 1, "metadata": True,
            "fused_attention": True, "dropout": 0.0,
            "backbone_kwargs": {"img_size": 32, "depth": 2, "embed_dim": 48,
                                "num_heads": 3}},
        profile_encoder_args={
            "kind": "transformer", "dim_in": 6, "dim_hidden": 64,
            "num_layers": 2, "num_head": 4, "target_size": 16,
            "dim_feedforward": 96, "fused_attention": True, "dropout": 0.0},
        coordination_args=coordination_args)


@pytest.mark.parametrize("coordination_args", [
    {"method": "siglip", "fused": False},
    {"method": "arcface", "out_features": 5},
], ids=["siglip", "arcface"])
def test_coordination_trees_convert_and_losses_match(coordination_args):
    """A SigLIP tree (``coordination/logit_bias``) and an ArcFace tree
    (``coordination/weight``, (out, in) in both trees, no transpose)
    convert and load strictly; ``MultiModel.loss`` (eval mode, f32) and
    its ``label`` argument match the JAX model to 1e-5 relative."""
    from multimodal_plankton_recognition_tpu.models.multi import (
        MultiModel as JaxMultiModel,
    )
    from multimodal_plankton_recognition_torch.models.multi import MultiModel

    args = _small_args(coordination_args)
    jbatch = dict(jax_synthetic_batch_vit(8, img=32, target_size=16, seed=5))
    label = np.random.RandomState(6).randint(0, 5, 8).astype(np.int32)
    jmodel = JaxMultiModel(**args)
    variables = jmodel.init(jax.random.key(0), buckets=2, label=label,
                            train=False, **jbatch)
    variables = jax.tree.map(np.asarray, variables)
    want = float(jmodel.apply(variables, buckets=2, label=label, train=False,
                              method="loss", **jbatch))
    coord = variables["params"]["coordination"]
    model = load_flax(MultiModel(**args), variables).eval()
    if coordination_args["method"] == "siglip":
        assert model.coordination.logit_bias.item() == -10.0
    else:
        np.testing.assert_array_equal(
            model.coordination.weight.detach().numpy(), coord["weight"])
        assert model.coordination.weight.shape == (5, 32)
    batch = synthetic_batch_vit(8, img=32, target_size=16, seed=5)
    with torch.no_grad():
        got = model.loss(buckets=2, label=torch.from_numpy(label), **batch)
    np.testing.assert_allclose(got.item(), want, rtol=1e-5)


def test_synthetic_batch_matches_jax():
    """Same numpy RandomState stream as the JAX package's batch."""
    want = jax_synthetic_batch_vit(3, img=32, target_size=16, seed=4)
    got = synthetic_batch_vit(3, img=32, target_size=16, seed=4)
    assert sorted(got) == sorted(want)
    for key, value in want.items():
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(value),
                                      err_msg=key)
