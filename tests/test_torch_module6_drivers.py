"""The module-6 cards through the port's drivers and CLIs, on the CPU:

* ``scripts/train_image_torch.py`` on the shipped ``resnet18.yaml`` card
  and ``scripts/train_profile_torch.py`` on the shipped ``lstm_1.yaml``
  card, each cut to size (32 px / ``max_len`` 32, bs 4, one epoch) and
  written as JSON, over the port's ``data/synthetic.py`` dataset: the run
  directory, its metrics and checkpoint, and ``test_acc`` equal to the
  argmax accuracy of ``predict_classifier`` on the kept checkpoint;
* an LSTM card's eval pipelines pad as JAX's ``eval_pipeline`` does
  (``max_len`` steps for ``profile``, ``target_size`` for ``multi``, the
  batch's own length for ``image``), with ``last_idx``;
* the JAX ``train_profile`` on a tiny f32 LSTM card (one epoch, SGD with
  momentum), bridged by ``scripts/checkpoint_from_jax.py`` (the cells'
  gates, and their momentum traces, stacked by ``convert.py``), then
  predicted within 1e-4 of JAX's ``predict_classifier``; labels and
  classes equal.
"""

import copy
import json
from pathlib import Path

import numpy as np
import pytest
import yaml

from multimodal_plankton_recognition_tpu import config as jax_config
from multimodal_plankton_recognition_tpu.retrieval.encode import (
    eval_pipeline as jax_eval_pipeline,
    predict_classifier as jax_predict_classifier,
)
from multimodal_plankton_recognition_tpu.train.drivers import (
    train_profile as jax_train_profile,
)
from multimodal_plankton_recognition_torch import config
from multimodal_plankton_recognition_torch.data.synthetic import (
    make_synthetic_dataset,
)
from multimodal_plankton_recognition_torch.retrieval.encode import (
    eval_pipeline, predict_classifier,
)
from multimodal_plankton_recognition_torch.train.checkpoint import (
    read_metadata,
)

from test_torch_classifier_driver import _script
from torch_threads import one_thread  # noqa: F401  (autouse)

REPO = Path(__file__).resolve().parent.parent
LOGITS_TOL = 1e-4


def _shipped(path, **overrides):
    d = yaml.safe_load((REPO / "model_cards" / path).read_text())
    d.update(bs=4, num_workers=2, **overrides)
    return d


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    return make_synthetic_dataset(tmp_path_factory.mktemp("module6_data"),
                                  n_classes=3, n_per_class=8, seed=0)


@pytest.mark.parametrize("script,path,overrides", [
    ("train_image_torch", "image/resnet18.yaml", {"target_size": 32}),
    ("train_profile_torch", "profile/lstm_1.yaml", {"max_len": 32}),
], ids=["resnet18", "lstm_1"])
def test_cli_trains_the_shipped_card(script, path, overrides, dataset,
                                     tmp_path):
    card = tmp_path / f"{Path(path).stem}.json"
    card.write_text(json.dumps(_shipped(path, **overrides)))
    result = _script(script).main(
        ["-d", str(dataset), "-m", str(card), "-l", str(tmp_path / "logs"),
         "--max-epochs", "1", "--device", "cpu"])
    logdir = Path(result["logdir"])
    assert logdir.parent.name == f"{card.stem}_" + "_".join(
        Path(dataset).parts[-2:])
    assert np.isfinite(result["history"][0]["train_loss"])
    records = [json.loads(x) for x in
               (logdir / "metrics.jsonl").read_text().splitlines()]
    assert "valid_acc" in records[0]
    meta = read_metadata(logdir / "checkpoints")
    assert meta["kind"] == ("image" if "image" in script else "profile")
    pred = predict_classifier(logdir / "checkpoints",
                              Path(dataset) / "test.csv", batch_size=4,
                              num_workers=1, device="cpu")
    acc = float((pred["classes"][pred["logits"].argmax(1)]
                 == pred["label"]).mean())
    assert result["test_acc"] == acc


@pytest.mark.parametrize("kind", ["profile", "multi", "image"])
def test_lstm_eval_pipelines_pad_as_jax(kind):
    d = _shipped("profile/lstm_2.yaml", max_len=48, target_size=40)
    rs = np.random.RandomState(0)
    profiles = [rs.randn(n, 6).astype(np.float32) for n in (5, 30, 17)]
    got = eval_pipeline(config.ModelCard.from_dict(copy.deepcopy(d)),
                        kind)[2](profiles)
    want = jax_eval_pipeline(jax_config.ModelCard.from_dict(
        copy.deepcopy(d)), kind)[2](profiles)
    assert sorted(got) == sorted(want) == ["last_idx", "profile"]
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    assert got["profile"].shape[1] == {"profile": 48, "multi": 40,
                                       "image": 32}[kind]


@pytest.fixture(scope="module")
def jax_lstm_run(dataset, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("lstm_bridge")
    d = _shipped("profile/lstm_1.yaml", max_len=32,
                 trainer_args={"precision": "32", "max_epochs": 1})
    d["profile_encoder_args"]["dim_hidden"] = 16
    card = tmp / "tiny_lstm.json"
    card.write_text(json.dumps(d))
    result = jax_train_profile(dataset, card, logdir=tmp / "jax",
                               max_epochs=1)
    jax_ckpt = Path(result["logdir"]) / "checkpoints"
    port_ckpt = tmp / "bridged"
    _script("checkpoint_from_jax").bridge(jax_ckpt, port_ckpt)
    return {"jax": jax_ckpt, "port": port_ckpt}


def test_bridged_jax_lstm_classifier_predicts_as_jax(jax_lstm_run, dataset):
    csv = Path(dataset) / "test.csv"
    want = jax_predict_classifier(jax_lstm_run["jax"], csv, batch_size=5,
                                  num_workers=1)
    got = predict_classifier(jax_lstm_run["port"], csv, batch_size=5,
                             num_workers=1, device="cpu")
    assert sorted(got) == sorted(want) == ["classes", "label", "logits"]
    np.testing.assert_allclose(got["logits"], want["logits"], rtol=0,
                               atol=LOGITS_TOL)
    np.testing.assert_array_equal(got["label"], want["label"])
    np.testing.assert_array_equal(got["classes"], want["classes"])
    assert read_metadata(jax_lstm_run["port"])["kind"] == "profile"
