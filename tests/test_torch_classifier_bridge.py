"""A supervised classifier's checkpoint from the JAX package in the port:
the JAX ``train_image`` trains the tiny f32 image card of
``tests/test_torch_classifier_driver.py`` for one epoch on the synthetic
dataset, ``scripts/checkpoint_from_jax.py`` bridges its orbax directory,
and ``predict_classifier`` gives JAX's logits within 1e-4, labels and
classes equal; ``scripts/encode_torch.py --logits`` writes the pickle
``scripts/encode.py --logits`` writes."""

import pickle
import sys
from pathlib import Path

import numpy as np
import pytest

from multimodal_plankton_recognition_tpu.retrieval.encode import (
    predict_classifier as jax_predict_classifier,
)
from multimodal_plankton_recognition_tpu.train.drivers import (
    train_image as jax_train_image,
)
from multimodal_plankton_recognition_torch.retrieval.encode import (
    predict_classifier,
)
from multimodal_plankton_recognition_torch.train.checkpoint import (
    read_metadata,
)
from test_torch_classifier_driver import _card, _script, _write_card
from torch_threads import one_thread  # noqa: F401  (autouse)

LOGITS_TOL = 1e-4


@pytest.fixture(scope="module")
def jax_run(synthetic_dataset, tmp_path_factory):
    """The JAX ``train_image`` for one epoch on the tiny image card, its
    orbax directory bridged to the port's format."""
    tmp = tmp_path_factory.mktemp("classifier_bridge")
    card_path = _write_card(tmp / "tiny.json", _card("image"))
    result = jax_train_image(synthetic_dataset, card_path,
                             logdir=tmp / "jax", max_epochs=1)
    jax_ckpt = Path(result["logdir"]) / "checkpoints"
    port_ckpt = tmp / "bridged"
    _script("checkpoint_from_jax").bridge(jax_ckpt, port_ckpt)
    return {"tmp": tmp, "jax": jax_ckpt, "port": port_ckpt}


def test_bridged_jax_classifier_predicts_as_jax(jax_run, synthetic_dataset):
    csv = Path(synthetic_dataset) / "test.csv"
    want = jax_predict_classifier(jax_run["jax"], csv, batch_size=5,
                                  num_workers=1)
    got = predict_classifier(jax_run["port"], csv, batch_size=5,
                             num_workers=1, device="cpu")
    assert sorted(got) == sorted(want) == ["classes", "label", "logits"]
    np.testing.assert_allclose(got["logits"], want["logits"], rtol=0,
                               atol=LOGITS_TOL)
    np.testing.assert_array_equal(got["label"], want["label"])
    np.testing.assert_array_equal(got["classes"], want["classes"])
    assert read_metadata(jax_run["port"])["kind"] == "image"


def test_encode_cli_logits_write_the_jax_schema(jax_run, synthetic_dataset,
                                                tmp_path, monkeypatch):
    common = ["-d", str(Path(synthetic_dataset) / "test.csv"), "--logits",
              "--name", "vit_t", "--fold", "2", "--batch-size", "5",
              "--num-workers", "1"]
    jax_out, port_out = tmp_path / "jax.pkl", tmp_path / "port.pkl"
    monkeypatch.setattr(sys, "argv", ["encode.py", "-k", str(jax_run["jax"]),
                                      "-o", str(jax_out), *common])
    _script("encode").main()
    _script("encode_torch").main(["-k", str(jax_run["port"]), "-o",
                                  str(port_out), "--device", "cpu", *common])
    with open(jax_out, "rb") as f:
        want = pickle.load(f)
    with open(port_out, "rb") as f:
        got = pickle.load(f)

    def schema(tree):
        if isinstance(tree, dict):
            return {k: schema(v) for k, v in tree.items()}
        return (type(tree).__name__, str(getattr(tree, "dtype", None)),
                getattr(tree, "shape", None))

    assert schema(got) == schema(want)
    np.testing.assert_allclose(got["vit_t"][2]["logits"],
                               want["vit_t"][2]["logits"], rtol=0,
                               atol=LOGITS_TOL)


