"""W8A8 quantisation of the port (``ops/quant.py``, ``models/dense.py``)
against the JAX package's ``ops/quant.py``.

Tolerances: the int8 values and scales, and ``int8_matmul``, exactly
JAX's on the same f32 inputs (the same f32 divisions, half-to-even
rounding, an exact integer product and the same dequantisation order);
the encode of a small ViT + profile transformer card under
``quantized_dense`` within 1e-5 of JAX's ``with quantized_dense():`` in
f32. In bf16 the port quantises the bf16 weights its model holds where
JAX quantises the f32 params, so an int8 weight can differ by one step:
the embeddings within 5e-2 abs, ``test_torch_attention_flax.py``'s bf16
tolerance for a layer (measured: 1.4e-2).
"""

import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_plankton_recognition_tpu import config as jax_config
from multimodal_plankton_recognition_tpu.models import build as jax_build
from multimodal_plankton_recognition_tpu.ops import quant as jax_quant
from multimodal_plankton_recognition_torch import config
from multimodal_plankton_recognition_torch.convert import from_flax
from multimodal_plankton_recognition_torch.models import dense as port_dense
from multimodal_plankton_recognition_torch.models.build import build_for_kind
from multimodal_plankton_recognition_torch.ops import quant
from multimodal_plankton_recognition_torch.ops.losses import l2_normalize
from torch_threads import one_thread  # noqa: F401

TS = 32
F32_TOL = 1e-5
BF16_TOL = 5e-2


def _rand(seed, *shape, scale=1.0):
    rs = np.random.RandomState(seed)
    return (rs.randn(*shape) * scale).astype(np.float32)


@pytest.mark.parametrize("shape", [(64, 32), (6, 192), (192, 38)])
def test_int8_values_and_scales_are_jax(shape):
    w = _rand(0, *shape) * np.random.RandomState(1).rand(shape[1]).astype(
        np.float32)
    w[:, 0] = 0.0  # an all-zero channel: the scale's floor
    w8, scale = quant.quantize_per_channel(torch.from_numpy(w))
    jw8, jscale = jax_quant.quantize_per_channel(jnp.asarray(w))
    assert w8.dtype == torch.int8 and tuple(scale.shape) == (1, shape[1])
    np.testing.assert_array_equal(w8.numpy(), np.asarray(jw8))
    np.testing.assert_array_equal(scale.numpy(), np.asarray(jscale))
    x = _rand(2, 8, shape[0], scale=3.0)
    x[0, :4] = [0.5, 1.5, -2.5, 2.5]  # half-way cases, after scaling too
    x8, xs = quant.quantize_dynamic(torch.from_numpy(x))
    jx8, jxs = jax_quant.quantize_dynamic(jnp.asarray(x))
    np.testing.assert_array_equal(x8.numpy(), np.asarray(jx8))
    assert xs.item() == float(jxs)


@pytest.mark.parametrize("lead", [(16,), (4, 4), (3, 5, 2)])
def test_int8_matmul_is_jax_bit_for_bit(lead):
    x = _rand(3, *lead, 128)
    w = _rand(4, 128, 64)
    w8, s = quant.quantize_per_channel(torch.from_numpy(w))
    got = quant.int8_matmul(torch.from_numpy(x), w8, s)
    jw8, js = jax_quant.quantize_per_channel(jnp.asarray(w))
    want = jax_quant.int8_matmul(jnp.asarray(x), jw8, js)
    assert got.dtype == torch.float32 and got.shape == (*lead, 64)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("m,k,n", [(16, 6, 192), (256, 192, 38),
                                   (1, 64, 64), (197, 192, 768)])
def test_padded_int_mm_equals_the_unpadded_product(m, k, n, monkeypatch):
    """The card's path pads to ``torch._int_mm``'s shapes (more than 16
    rows, K and N multiples of 8: the profile ``expand``'s K = 6, a
    classifier's 38 classes); here ``torch._int_mm`` is a stand-in that
    enforces those rules and multiplies exactly."""
    def int_mm(a, b):
        assert a.dtype == b.dtype == torch.int8
        assert a.shape[0] > 16 and a.shape[1] % 8 == 0 \
            and b.shape[1] % 8 == 0 and a.shape[1] == b.shape[0]
        return quant.int8_mm_reference(a, b)

    monkeypatch.setattr(torch, "_int_mm", int_mm)
    gen = torch.Generator().manual_seed(m * n)
    a = torch.randint(-127, 128, (m, k), generator=gen).to(torch.int8)
    b = torch.randint(-127, 128, (k, n), generator=gen).to(torch.int8)
    got = quant._padded_int_mm(a, b)
    assert got.shape == (m, n) and got.dtype == torch.int32
    assert torch.equal(got, quant.int8_mm_reference(a, b))
    assert torch.equal(quant.int8_mm_reference(a, b),
                       (a.long() @ b.long()).to(torch.int32))


def _card(precision):
    return {
        "bs": 4, "dim_embedding": 16, "target_size": TS,
        "image_encoder_args": {
            "name": "vit_tiny_patch16_224", "in_chans": 1, "metadata": True,
            "fused_attention": False, "dropout": 0.0,
            "backbone_kwargs": {"img_size": TS, "depth": 2, "embed_dim": 48,
                                "num_heads": 3}},
        "profile_encoder_args": {
            "kind": "transformer", "dim_in": 6, "dim_hidden": 64,
            "num_layers": 2, "num_head": 4, "target_size": TS,
            "dim_feedforward": 96, "fused_attention": False,
            "dropout": 0.0},
        "coordination_args": {"method": "clip"},
        "trainer_args": {"precision": precision}}


def _batch(b, seed):
    rs = np.random.default_rng(seed)
    lens = rs.integers(3, TS + 1, b)
    mask = np.arange(TS + 1)[None, :] > lens[:, None]
    return {"image": rs.normal(size=(b, TS, TS, 1)).astype(np.float32),
            "image_shape": rs.integers(100, 400, (b, 2)).astype(np.int32),
            "profile_len": rs.integers(10, 900, (b, 1)).astype(np.int32),
            "profile": rs.normal(size=(b, TS + 1, 6)).astype(np.float32),
            "time": np.tile(np.arange(TS + 1, dtype=np.int32), (b, 1)),
            "padding_mask": mask}


@pytest.mark.parametrize("precision,tol", [("32", F32_TOL),
                                           ("16-mixed", BF16_TOL)])
def test_quantized_encode_matches_jax(precision, tol, monkeypatch):
    """``quantized_dense`` over the encode: embeddings against JAX's on
    converted weights; the layers swapped are those JAX intercepts (11:
    the ViT's 2 x 2 MLP Denses, the profile transformer's ``expand`` and 2
    x 2 feed-forward Denses, the two projections), none of attention's
    projections; outside the context nothing is swapped."""
    d = _card(precision)
    jcard = jax_config.ModelCard.from_dict(copy.deepcopy(d))
    jmodel = jax_build.build_multi_model(jcard)
    batch = _batch(5, seed=0)
    arrays = {k: jnp.asarray(v) for k, v in batch.items()}
    variables = jax.jit(functools.partial(
        jmodel.init, method="encode", train=False))(jax.random.PRNGKey(0),
                                                     **arrays)
    card = config.ModelCard.from_dict(copy.deepcopy(d))
    model = build_for_kind(card, "multi").eval()
    model.load_state_dict(from_flax(jax.tree.map(np.asarray, variables)),
                          strict=False)

    jax_calls, port_calls = [], []
    real_jax, real_port = jax_quant.dense_int8, port_dense.dense_int8
    monkeypatch.setattr(jax_quant, "dense_int8", lambda m, x: (
        jax_calls.append(m.name) or real_jax(m, x)))
    monkeypatch.setattr(port_dense, "dense_int8", lambda m, x: (
        port_calls.append(type(m).__name__) or real_port(m, x)))

    def quantized_apply(v, a):
        with jax_quant.quantized_dense():
            return jmodel.apply(v, method="encode", train=False, **a)

    want = jax.jit(quantized_apply)(variables, arrays)
    inputs = {k: torch.from_numpy(v) for k, v in batch.items()}
    with torch.no_grad():
        plain = model.encode(**inputs)
        assert port_calls == []
        with quant.quantized_dense():
            got = model.encode(**inputs)
    assert len(port_calls) == len(jax_calls) == 11
    assert set(port_calls) == {"Dense"}
    assert sorted(jax_calls).count("ff1") == 2
    for key in ("image_emb", "profile_emb"):
        g = l2_normalize(got[key]).float().numpy()
        w = np.asarray(jax.numpy.asarray(want[key], jnp.float32))
        w = w / np.linalg.norm(w, axis=-1, keepdims=True)
        np.testing.assert_allclose(g, w, rtol=tol, atol=tol, err_msg=key)
        assert got[key].dtype == plain[key].dtype
        assert not torch.equal(got[key], plain[key])


def test_dense_int8_keeps_the_module_dtype_and_bias():
    lin = port_dense.Dense(64, 38).to(torch.bfloat16)
    x = torch.randn(4, 64)
    y = quant.dense_int8(lin, x)
    assert y.dtype == torch.bfloat16 and y.shape == (4, 38)
    nob = port_dense.Dense(64, 38, bias=False)
    ref = quant.int8_matmul(x, *quant.quantize_per_channel(nob.weight.t()))
    assert torch.equal(quant.dense_int8(nob, x), ref)
