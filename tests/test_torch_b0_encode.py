"""The B0 family's serving path against the JAX package's: ``flagship_b0``
encode parity in eval mode, the port's own host layers (dataset, eval
transforms, loader, CNN tokenizer) item for item, and ``encode_csv`` for a
B0 card against the JAX ``_encode_csv``.

Tolerances: normalized embeddings to 1e-4 in f32 and 5e-2 in bf16 (as
``tests/test_torch_slice.py``); the host layers exactly.
"""

import copy
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from multimodal_plankton_recognition_tpu import config as jax_config
from multimodal_plankton_recognition_tpu.models.build import (
    build_multi_model as jax_build_multi_model,
)
from multimodal_plankton_recognition_tpu.models.flagships import (
    flagship_b0 as jax_flagship_b0,
)
from multimodal_plankton_recognition_tpu.ops.losses import (
    l2_normalize as jax_l2_normalize,
)
from multimodal_plankton_recognition_torch import config
from multimodal_plankton_recognition_torch.convert import load_flax
from multimodal_plankton_recognition_torch.models.build import (
    build_multi_model,
)
from multimodal_plankton_recognition_torch.models.flagships import (
    flagship_b0, synthetic_batch_b0,
)
from multimodal_plankton_recognition_torch.ops.losses import l2_normalize
from torch_threads import one_thread  # noqa: F401  (autouse)

REPO = Path(__file__).resolve().parent.parent
B0_CLIP_CARD = REPO / "model_cards/multi/efficientnet_b0_cnn_2_512_clip.yaml"
SIZE, BS = 32, 8


def b0_batch(seed: int) -> dict:
    """The synthetic B0 batch (numpy), the JAX package's stream."""
    return {k: v.numpy() for k, v in synthetic_batch_b0(
        BS, img=SIZE, plen=SIZE, seed=seed).items()}


@pytest.fixture(scope="module")
def flagship_variables():
    """The JAX ``flagship_b0`` tree (f32 init; the dtype does not change
    the tree) with random running statistics."""
    jmodel = jax_flagship_b0().clone(dtype=jnp.float32)
    batch = {k: jnp.asarray(v) for k, v in b0_batch(2).items()}
    variables = jax.jit(lambda key: jmodel.init(key, **batch))(
        jax.random.key(0))
    rs = np.random.RandomState(3)

    def draw(path, leaf):
        if path[-1].key == "mean":
            return (0.1 * rs.randn(*leaf.shape)).astype(np.float32)
        return (0.5 + rs.rand(*leaf.shape)).astype(np.float32)

    return {"params": jax.tree.map(np.asarray, variables["params"]),
            "batch_stats": jax.tree_util.tree_map_with_path(
                draw, variables["batch_stats"])}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flagship_b0_encode_matches_jax(dtype, flagship_variables):
    """EfficientNet-B0 + ProfileCNN 2-2-2-2 + CLIP, dim 512, in eval mode
    (the serving path: running statistics, no MBConv kernel)."""
    jmodel = jax_flagship_b0().clone(dtype=getattr(jnp, dtype))
    batch = b0_batch(4)
    # one compile (op-by-op, B0's encode took most of this file's time)
    jemb = jax.jit(lambda v, b: jmodel.apply(v, method="encode",
                                             train=False, **b))(
        flagship_variables, {k: jnp.asarray(v) for k, v in batch.items()})
    model = flagship_b0(dtype=getattr(torch, dtype))
    load_flax(model, flagship_variables)
    model.eval()
    with torch.inference_mode():
        emb = model.encode(**{k: torch.from_numpy(v)
                              for k, v in batch.items()})
    tol = 1e-4 if dtype == "float32" else 5e-2
    for key in ("image_emb", "profile_emb"):
        assert emb[key].shape == (BS, 512)
        assert emb[key].dtype == getattr(torch, dtype)
        np.testing.assert_allclose(
            l2_normalize(emb[key]).float().numpy(),
            np.asarray(jax_l2_normalize(jemb[key]), np.float32),
            rtol=tol, atol=tol, err_msg=key)


def test_host_layers_match_jax(synthetic_dataset):
    """``MultiSet`` with the eval transforms, item for item, and the
    ``Loader`` batches with the CNN tokenizer, as the JAX package's."""
    from multimodal_plankton_recognition_tpu.data.dataset import (
        MultiSet as JaxMultiSet,
    )
    from multimodal_plankton_recognition_tpu.data.pipeline import (
        Loader as JaxLoader, multi_collate_fn as jax_multi_collate_fn,
    )
    from multimodal_plankton_recognition_tpu.data.tokenize import (
        get_tokenizer as jax_get_tokenizer,
    )
    from multimodal_plankton_recognition_tpu.data.transforms import (
        ImageTransformTest as JaxImageTransformTest,
        ProfileTransformTest as JaxProfileTransformTest,
    )
    from multimodal_plankton_recognition_torch.data.dataset import MultiSet
    from multimodal_plankton_recognition_torch.data.pipeline import (
        Loader, multi_collate_fn,
    )
    from multimodal_plankton_recognition_torch.data.tokenize import (
        get_tokenizer,
    )
    from multimodal_plankton_recognition_torch.data.transforms import (
        ImageTransformTest, ProfileTransformTest,
    )

    csv = synthetic_dataset / "test.csv"
    want_set = JaxMultiSet(csv, JaxImageTransformTest(SIZE),
                           JaxProfileTransformTest(SIZE))
    got_set = MultiSet(csv, ImageTransformTest(SIZE),
                       ProfileTransformTest(SIZE))
    assert len(got_set) == len(want_set) > 0
    np.testing.assert_array_equal(got_set.class_names, want_set.class_names)
    for i in range(len(want_set)):
        want, got = want_set[i], got_set[i]
        assert sorted(got) == sorted(want)
        for key in want:
            np.testing.assert_array_equal(got[key], want[key],
                                          err_msg=f"{i} {key}")
    loaders = [
        JaxLoader(want_set, 5, jax_multi_collate_fn(
            jax_get_tokenizer("cnn", SIZE, SIZE)), num_workers=2),
        Loader(got_set, 5, multi_collate_fn(get_tokenizer("cnn", SIZE, SIZE)),
               num_workers=2)]
    batches = [list(loader) for loader in loaders]
    assert len(batches[1]) == len(batches[0]) == len(loaders[1])
    for want, got in zip(*batches):
        assert sorted(got) == sorted(want) == [
            "image", "image_shape", "profile", "profile_len"]
        for key in want:
            assert got[key].dtype == want[key].dtype, key
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def test_encode_csv_b0_card_matches_jax(synthetic_dataset):
    """A B0 card's CSV: the CNN tokenizer pads to ``target_size``."""
    from multimodal_plankton_recognition_tpu.retrieval.encode import (
        _encode_csv,
    )
    from multimodal_plankton_recognition_torch.retrieval.encode import (
        encode_csv,
    )

    d = yaml.safe_load(B0_CLIP_CARD.read_text())
    d.update(target_size=SIZE, bs=BS)
    d["trainer_args"]["precision"] = "32"
    jcard = jax_config.ModelCard.from_dict(copy.deepcopy(d))
    jmodel = jax_build_multi_model(jcard)
    batch = {k: jnp.asarray(v) for k, v in b0_batch(0).items()}
    variables = jax.jit(lambda key: jmodel.init(key, **batch))(
        jax.random.key(0))
    variables = jax.tree.map(np.asarray, variables)
    csv = synthetic_dataset / "test.csv"
    want = _encode_csv(jmodel, variables, jcard, csv, batch_size=5,
                       num_workers=1)
    model = build_multi_model(config.ModelCard.from_dict(d))
    load_flax(model, variables)
    got = encode_csv(model, csv, SIZE, batch_size=5, num_workers=1,
                     device="cpu")
    for key in ("image", "profile"):
        assert got[key].shape == want[key].shape == (len(want["label"]), 512)
        np.testing.assert_allclose(got[key], want[key], rtol=1e-4,
                                   atol=1e-4, err_msg=key)
    np.testing.assert_array_equal(got["label"], want["label"])
