"""The plain reference against the measured program on the CPU at tiny
sizes, both in float32: the encoders, the loss, a train step's losses,
gradients and updates, the kNN's classes."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from multimodal_plankton_recognition_torch.config import ModelCard
from multimodal_plankton_recognition_torch.models.build import \
    build_multi_model
from multimodal_plankton_recognition_torch.ops.knn import ANNClassifier
from multimodal_plankton_recognition_torch.ops.losses import clip_loss
from multimodal_plankton_recognition_torch.train.loop import \
    make_multi_steps
from multimodal_plankton_recognition_torch.train.optim import make_optimizer
from multimodal_plankton_recognition_torch.train.state import \
    create_train_state
from portbench.drivers.train_closed_loop import dropout_off, make_pool
from portbench.harness.weights import make_weights
from portbench.reference import multi as ref
from portbench.reference.precision import FP8
from portbench.tests.cells import tiny

CELLS = ["vit_t16_tf2_clip.train_b512", "effb0_cnn2_clip.train_b256"]
torch.set_num_threads(4)


def _f32(card):
    card = dict(card, trainer_args=dict(card["trainer_args"],
                                        precision="32"))
    return card


@pytest.mark.parametrize("name", CELLS)
def test_encode_matches_the_program(name):
    cell = tiny(name)
    card = _f32(cell.config["card"])
    weights = make_weights(card, 7, "cpu")
    batch = make_pool(card, cell.traffic, 7, "cpu", 1)[0]
    weights = ref.calibrate(card, weights, batch)
    model = build_multi_model(ModelCard.from_dict(card))
    model.load_state_dict(weights)
    with torch.no_grad():
        out = model.eval().encode(**batch)
    img, prof = ref.embed(card, weights, [batch])
    torch.testing.assert_close(F.normalize(out["image_emb"], dim=-1), img,
                               atol=2e-5, rtol=0)
    torch.testing.assert_close(F.normalize(out["profile_emb"], dim=-1), prof,
                               atol=2e-5, rtol=0)


@pytest.mark.parametrize("name", CELLS)
def test_train_steps_match_the_program(name):
    """Three steps of the card in float32 without dropout: losses,
    the first gradient and every leaf's weights after the steps."""
    cell = tiny(name)
    card = _f32(cell.config["card"])
    mc = ModelCard.from_dict(card)
    weights = make_weights(card, 11, "cpu")
    batches = make_pool(card, cell.traffic, 11, "cpu", 3)
    model = build_multi_model(mc)
    tx = make_optimizer(mc.optim_args, 1)
    state = create_train_state(model, weights, tx)
    step, _ = make_multi_steps(model, tx, mc.buckets)
    dropout_off(model)
    losses = []
    for i, b in enumerate(batches):
        state, loss = step(state, b, 0)
        losses.append(float(loss))
        if i == 0:
            grad1 = {n: p.grad.clone() for n, p in state.params.items()}
    want = ref.train_steps(card, weights, batches, mc.buckets)
    np.testing.assert_allclose(losses, want["losses"], rtol=1e-5)
    for n in want["grad1"]:
        torch.testing.assert_close(grad1[n], want["grad1"][n], atol=1e-5,
                                   rtol=1e-3)
        torch.testing.assert_close(state.params[n], want["params"][n],
                                   atol=1e-6, rtol=1e-4)


def test_clip_loss_matches_the_program():
    g = torch.Generator().manual_seed(3)
    i, p = torch.randn(32, 16, generator=g), torch.randn(32, 16, generator=g)
    scale = torch.tensor(0.7)
    torch.testing.assert_close(ref.clip_loss(i, p, scale, 4),
                               clip_loss(i, p, scale, 4))


def test_knn_classes_match_the_program():
    """The reference's weighted vote over the fused gallery gives the
    classes of the program's ``ANNClassifier`` on the same embeddings."""
    g = torch.Generator().manual_seed(5)
    gal_i = F.normalize(torch.randn(200, 8, generator=g), dim=-1)
    gal_p = F.normalize(torch.randn(200, 8, generator=g), dim=-1)
    labels = torch.randint(0, 6, (200,), generator=g)
    q = (F.normalize(torch.randn(40, 8, generator=g), dim=-1),
         F.normalize(torch.randn(40, 8, generator=g), dim=-1))
    votes = ref.knn_votes(q, torch.cat([gal_i, gal_p]), labels.repeat(2), 6,
                          9)
    clf = ANNClassifier(torch.cat([gal_i, gal_p]).numpy(),
                        labels.repeat(2).numpy(), device="cpu")
    np.testing.assert_array_equal(
        votes.argmax(1).numpy(), clf.predict(q[0].numpy(), q[1].numpy(),
                                             k=9))


def test_fp8_control_rounds_to_three_mantissa_bits():
    x = torch.linspace(-3, 3, 1001)
    y = FP8.op(x)
    assert (y != x).any()
    scale = x.abs().max() / 448
    torch.testing.assert_close(y, (x / scale).to(torch.float8_e4m3fn)
                               .float() * scale)
