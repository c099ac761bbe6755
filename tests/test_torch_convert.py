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


@pytest.fixture(scope="module")
def flagship_variables():
    """Init only (one sample): the full-width tree, no forward is compared."""
    batch = jax_synthetic_batch_vit(1)
    variables = jax_flagship_vit().init(jax.random.key(0), **batch)
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
        from_flax({**flagship_variables, "batch_stats": {}})


def test_missing_leaf_raises(flagship_variables):
    params = dict(flagship_variables["params"])
    params.pop("profile_projection")
    with pytest.raises(RuntimeError, match="profile_projection.weight"):
        load_flax(flagship_vit(), {"params": params})


def test_synthetic_batch_matches_jax():
    """Same numpy RandomState stream as the JAX package's batch."""
    want = jax_synthetic_batch_vit(3, img=32, target_size=16, seed=4)
    got = synthetic_batch_vit(3, img=32, target_size=16, seed=4)
    assert sorted(got) == sorted(want)
    for key, value in want.items():
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(value),
                                      err_msg=key)
