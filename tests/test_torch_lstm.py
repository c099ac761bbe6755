"""The profile LSTM (``models/profile/lstm.py``) against the JAX
package's ``ProfileLSTM`` (flax ``nn.RNN(nn.OptimizedLSTMCell)``), on
weights converted by ``convert.py``, at the shipped width (H 128, 1 and 2
layers), ragged profiles over 257 steps, B 4:

* f32 output within 1e-4 of max|output|;
* bf16 (both modules at ``dtype=bfloat16``): the output f32 on both
  sides (the carry is f32 and c', h' come out f32, as the Flax cell
  computes them) and within a relative L2 error of 1e-2 of JAX's
  (measured on this CPU: 1.9-2.4e-3; the two frameworks round the bf16
  products and sums at different points);
* the classifier (``profile-lstm`` of ``tests/test_torch_classifier.py``:
  2 layers of 128 over 40 ragged steps, B 16, f32): logits within 1e-4 of
  max(1, max|logit|), one dropout-0 train step against JAX's
  ``make_classifier_steps``: loss within 1e-5 relative, every gradient
  and update within 1e-3 relative L2;
* a bf16 contrastive model with an LSTM encoder casts the f32 feature to
  its projection's dtype, as a Flax Dense does;
* the seeded init (``models/initializers.py``): every gate's (H, H)
  recurrent block orthogonal (W Wᵀ = I within 1e-5), the input blocks
  ``lecun_normal`` by statistics against Flax's draw, the biases zero;
* ``convert``: the gates stacked i|f|g|o, and ``to_flax`` the inverse.
"""

import copy

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_plankton_recognition_tpu.models.profile.lstm import (
    ProfileLSTM as JaxProfileLSTM,
)
from multimodal_plankton_recognition_torch import config
from multimodal_plankton_recognition_torch.convert import from_flax, to_flax
from multimodal_plankton_recognition_torch.data.tokenize import tokenize_lstm
from multimodal_plankton_recognition_torch.models.build import (
    build_multi_model,
)
from multimodal_plankton_recognition_torch.models.profile.lstm import (
    ProfileLSTM,
)
from multimodal_plankton_recognition_torch.train.drivers import init_masters

from test_torch_classifier import check_logits, check_train_step
from torch_threads import one_thread  # noqa: F401  (autouse)

F32_TOL, BF16_REL = 1e-4, 1e-2
ORTHO_TOL = 1e-5
H, T, B = 128, 257, 4


def _tokens(seed=0):
    rs = np.random.RandomState(seed)
    lengths = rs.randint(100, T + 1, B)
    lengths[0] = T  # one row runs to the last step
    tok = tokenize_lstm([rs.randn(n, 6).astype(np.float32) for n in lengths],
                        pad_to=T)
    tok["profile_len"] = rs.randint(20, 2000, (B, 1)).astype(np.int32)
    return tok


def _variables(jm, tok, seed=1):
    """Random Flax variables for ``jm`` (its init's shapes): kernels
    N(0, 1/fan_in), biases N(0, 0.1²)."""
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.key(0), tok["profile"], tok["last_idx"],
        tok["profile_len"]))
    rs = np.random.RandomState(seed)
    return jax.tree_util.tree_map_with_path(
        lambda p, s: (rs.randn(*s.shape) / (np.sqrt(s.shape[0])
                                            if p[-1].key == "kernel"
                                            else 10)).astype(np.float32),
        dict(shapes))


def _run(layers, dtype, seed):
    tok = _tokens(seed)
    jm = JaxProfileLSTM(num_layers=layers, dim_hidden=H, dropout=0.0,
                        dtype=dtype)
    variables = _variables(jm, tok)
    want = jax.jit(jm.apply)(variables, tok["profile"], tok["last_idx"],
                             tok["profile_len"])
    pm = ProfileLSTM(num_layers=layers, dim_hidden=H, dropout=0.0)
    pm.load_state_dict(from_flax(variables), strict=True)
    if dtype == jnp.bfloat16:
        pm = pm.to(torch.bfloat16)
    got = pm.eval()(**{k: torch.from_numpy(v) for k, v in tok.items()})
    return got.detach(), np.asarray(want)


@pytest.mark.parametrize("layers", [1, 2])
def test_output_matches_jax_f32(layers):
    got, want = _run(layers, jnp.float32, layers)
    assert got.shape == (B, H + 1) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=F32_TOL * np.abs(want).max())


@pytest.mark.parametrize("layers", [1, 2])
def test_output_matches_jax_bf16(layers):
    got, want = _run(layers, jnp.bfloat16, 10 + layers)
    assert got.dtype == torch.float32 and want.dtype == np.float32
    rel = np.linalg.norm(got.numpy() - want) / np.linalg.norm(want)
    assert rel <= BF16_REL


def test_classifier_logits_match_jax():
    check_logits("profile-lstm")


def test_classifier_train_step_matches_jax():
    check_train_step("profile-lstm")


def test_bf16_multi_model_casts_the_feature():
    card = config.ModelCard.from_dict({
        "dim_embedding": 32,
        "image_encoder_args": {"name": "resnet18"},
        "profile_encoder_args": {"kind": "lstm", "dim_hidden": 16,
                                 "num_layers": 2},
        "trainer_args": {"precision": "16-mixed"}})
    model = build_multi_model(card).eval()
    tok = _tokens(3)
    emb = model.encode(**{k: torch.from_numpy(v) for k, v in tok.items()})
    assert emb["image_emb"] is None
    assert emb["profile_emb"].dtype == torch.bfloat16
    assert emb["profile_emb"].shape == (B, 32)
    feat = model.profile_encoder(**{k: torch.from_numpy(v)
                                    for k, v in tok.items()})
    assert feat.dtype == torch.float32


def test_seeded_init_draws_the_cells_as_flax():
    card = config.ModelCard.from_dict({"profile_encoder_args": {
        "kind": "lstm", "dim_hidden": H, "num_layers": 2}})
    got = init_masters(card, "profile", ["a", "b"])
    for i in range(2):
        w_hh = got[f"profile_encoder.layers.{i}.weight_hh"].double()
        for block in w_hh.chunk(4):
            eye = block @ block.t()
            assert (eye - torch.eye(H, dtype=torch.float64)).abs().max() \
                <= ORTHO_TOL
        assert not got[f"profile_encoder.layers.{i}.bias"].any()
    # the input blocks: lecun_normal (std 1/sqrt(fan_in), truncated at 2
    # std), by statistics against Flax's draw of one gate's kernel
    w_ih = got["profile_encoder.layers.0.weight_ih"].double()
    want = np.asarray(fnn.initializers.lecun_normal()(
        jax.random.key(0), (H, 4 * H), jnp.float32), np.float64)
    n, sw = w_ih.numel(), want.std()
    assert abs(w_ih.mean().item()) <= 6 * sw / np.sqrt(n)
    assert abs(w_ih.std().item() - sw) <= 6 * sw / np.sqrt(n)
    # Flax's own recurrent draw is orthogonal the same way
    flax_hh = np.asarray(fnn.initializers.orthogonal()(
        jax.random.key(1), (H, H), jnp.float32), np.float64)
    assert np.abs(flax_hh @ flax_hh.T - np.eye(H)).max() <= ORTHO_TOL


def test_convert_stacks_the_gates():
    tok = _tokens(4)
    jm = JaxProfileLSTM(num_layers=2, dim_hidden=8, dropout=0.0)
    variables = _variables(jm, tok)
    sd = from_flax(copy.deepcopy(variables))
    cell = variables["params"]["OptimizedLSTMCell_1"]
    for j, g in enumerate("ifgo"):
        rows = slice(8 * j, 8 * (j + 1))
        np.testing.assert_array_equal(
            sd["layers.1.weight_ih"][rows].numpy(), cell["i" + g]["kernel"].T)
        np.testing.assert_array_equal(
            sd["layers.1.weight_hh"][rows].numpy(), cell["h" + g]["kernel"].T)
        np.testing.assert_array_equal(sd["layers.1.bias"][rows].numpy(),
                                      cell["h" + g]["bias"])
    pm = ProfileLSTM(num_layers=2, dim_hidden=8)
    pm.load_state_dict(sd, strict=True)
    back = to_flax(pm)
    assert jax.tree.map(np.shape, back) == jax.tree.map(np.shape, variables)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(variables)):
        np.testing.assert_array_equal(a, b)
