"""Train-step parity: the port's ``make_optimizer`` / ``create_train_state``
/ ``make_multi_steps`` against the JAX package's on converted weights, for
a small ``MultiModel`` (ViT depth 2 width 48, ProfileTransformer width 64,
batch 8, buckets 2, dropout 0 on both sides).

Tolerances, per parameter tensor, on the update (parameters after the
step minus the initial ones), as the relative L2 error
``|Δport − Δjax| / |Δjax|``:

* f32: the loss to 1e-5 relative and every update to 1e-3 (both sides
  compute the same f32 gradients and the same SGD arithmetic, summing in
  another order; measured on this CPU: largest 4e-5);
* bf16: the loss to 2e-3 relative, the median update to 5e-2 and every
  update to 0.3. The forward and backward run in bf16 on both sides, and
  the two frameworks round intermediate bf16 values (LayerNorm with its
  f32 scale in JAX and bf16 weight here, GELU, residual sums, the f32 →
  bf16 cast of each weight) at different points, so gradients differ by a
  few bf16 steps (2⁻⁸ relative each) compounded over four layers; the
  scalar ``logit_scale`` has the largest error, its gradient being a sum
  with cancellation (measured on this CPU: median 1.4e-2, largest 0.15).
  Master weights held in bf16 lose updates below half a bf16 step of the
  weight (2.4e-4 at 0.07) and fail this check by far (median 1.0).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_plankton_recognition_tpu.config import (
    OptimConfig as JaxOptimConfig,
)
from multimodal_plankton_recognition_tpu.models.multi import (
    MultiModel as JaxMultiModel,
)
from multimodal_plankton_recognition_tpu.train.loop import (
    make_multi_steps as jax_make_multi_steps,
)
from multimodal_plankton_recognition_tpu.train.optim import (
    make_optimizer as jax_make_optimizer,
)
from multimodal_plankton_recognition_tpu.train.state import (
    create_train_state as jax_create_train_state,
)
from multimodal_plankton_recognition_torch.config import OptimConfig
from multimodal_plankton_recognition_torch.convert import from_flax
from multimodal_plankton_recognition_torch.data.tokenize import (
    tokenize_transformer,
)
from multimodal_plankton_recognition_torch.models.multi import MultiModel
from multimodal_plankton_recognition_torch.train import (
    TrainState, create_train_state, make_multi_steps, make_optimizer,
)
from torch_threads import one_thread  # noqa: F401  (autouse)

BUCKETS = 2
F32_LOSS_TOL, F32_UPDATE_TOL = 1e-5, 1e-3
BF16_LOSS_TOL, BF16_MEDIAN_TOL, BF16_UPDATE_TOL = 2e-3, 5e-2, 0.3


def _model_args(dropout: float = 0.0, img: int = 32,
                target_size: int = 16) -> dict:
    return dict(
        dim_embed=32,
        image_encoder_args={
            "name": "vit_tiny_patch16_224", "in_chans": 1, "metadata": True,
            "fused_attention": True, "dropout": dropout,
            "backbone_kwargs": {"img_size": img, "depth": 2, "embed_dim": 48,
                                "num_heads": 3}},
        profile_encoder_args={
            "kind": "transformer", "dim_in": 6, "dim_hidden": 64,
            "num_layers": 2, "num_head": 4, "target_size": target_size,
            "dim_feedforward": 96, "fused_attention": True,
            "dropout": dropout},
        coordination_args={"method": "clip", "fused": True})


def _batch(seed: int, bs: int = 8, img: int = 32, target_size: int = 16):
    rs = np.random.RandomState(seed)
    lengths = rs.randint(3, target_size + 1, bs)
    lengths[0] = target_size
    tokens = tokenize_transformer(
        [rs.randn(n, 6).astype(np.float32) for n in lengths], target_size,
        pad_to=target_size + 1)
    return {"image": rs.randn(bs, img, img, 1).astype(np.float32),
            "image_shape": rs.randint(200, 400, (bs, 2)).astype(np.int32),
            "profile_len": rs.randint(100, 2000, (bs, 1)).astype(np.int32),
            **tokens}


@functools.cache
def _jax_run(dtype: str, steps: int, every_k: int = 1):
    """The JAX package's train steps on batches 0, 1, 0, 1, ...: the
    initial f32 parameters and, after each step, the loss and the
    parameters, converted to the port's names."""
    import os

    jdt = getattr(jnp, dtype)
    interpret = dtype == "bfloat16"  # bf16 runs the Pallas kernels
    old = os.environ.get("PLANKTON_FUSED_INTERPRET")
    if interpret:
        os.environ["PLANKTON_FUSED_INTERPRET"] = "1"
    try:
        model = JaxMultiModel(dtype=jdt, **_model_args())
        tx = jax_make_optimizer(JaxOptimConfig(), every_k)
        batches = [{k: jnp.asarray(v) for k, v in _batch(s).items()}
                   for s in (0, 1)]
        state = jax.jit(lambda key: jax_create_train_state(
            model, key, batches[0], tx, init_kwargs={"buckets": BUCKETS}))(
                jax.random.key(0))
        train_step, _ = jax_make_multi_steps(model, tx, buckets=BUCKETS)
        init = from_flax({"params": jax.tree.map(np.asarray, state.params)})
        after = []
        for i in range(steps):
            state, loss = train_step(state, batches[i % 2], jax.random.key(1))
            after.append((float(loss), from_flax(
                {"params": jax.tree.map(np.asarray, state.params)})))
    finally:
        if interpret:
            if old is None:
                os.environ.pop("PLANKTON_FUSED_INTERPRET")
            else:
                os.environ["PLANKTON_FUSED_INTERPRET"] = old
    return init, after


def _port(dtype: str, init, every_k: int = 1, dropout: float = 0.0):
    model = MultiModel(dtype=getattr(torch, dtype), **_model_args(dropout))
    tx = make_optimizer(OptimConfig(), every_k)
    state = create_train_state(model, init, tx)
    train_step, eval_step = make_multi_steps(model, tx, buckets=BUCKETS)
    return model, state, train_step, eval_step


def _torch_batch(seed: int):
    return {k: torch.from_numpy(v) for k, v in _batch(seed).items()}


def _update_errors(init, port_params, jax_params):
    """Relative L2 error of each tensor's update, port against JAX."""
    errs = {}
    for name, start in init.items():
        want = (jax_params[name] - start).double()
        got = port_params[name].double() - start.double()
        errs[name] = ((got - want).norm() / want.norm()).item()
    return errs


def _run_port(state, train_step, steps):
    losses = []
    for i in range(steps):
        state, loss = train_step(state, _torch_batch(i % 2), 0)
        losses.append((loss.item(), {n: m.clone()
                                     for n, m in state.params.items()}))
    return losses


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_train_steps_match_jax(dtype):
    """One and two steps: the loss and every master tensor's update."""
    init, want = _jax_run(dtype, 2)
    model, state, train_step, _ = _port(dtype, init)
    got = _run_port(state, train_step, 2)
    for step, ((loss, params), (jloss, jparams)) in enumerate(
            zip(got, want), 1):
        errs = _update_errors(init, params, jparams)
        worst = max(errs, key=errs.get)
        if dtype == "float32":
            assert abs(loss - jloss) <= F32_LOSS_TOL * abs(jloss), step
            assert errs[worst] <= F32_UPDATE_TOL, (step, worst, errs[worst])
        else:
            assert abs(loss - jloss) <= BF16_LOSS_TOL * abs(jloss), step
            assert np.median(list(errs.values())) <= BF16_MEDIAN_TOL, step
            assert errs[worst] <= BF16_UPDATE_TOL, (step, worst, errs[worst])
    assert all(m.dtype == torch.float32 for m in state.params.values())
    assert all(p.dtype == getattr(torch, dtype)
               for n, p in model.named_parameters()
               if not n.startswith("coordination."))


def test_bf16_master_weights_fail_the_update_check():
    """The fault the f32 masters repair: the same bf16 model with its
    masters held in bf16 (the serving module's own weights) loses the
    small SGD updates and fails the bf16 check above by far."""
    init, want = _jax_run("bfloat16", 2)
    model, _, train_step, _ = _port("bfloat16", init)
    params = {n: p.detach().clone() for n, p in model.named_parameters()}
    state = TrainState(step=0, params=params,
                       opt=make_optimizer(OptimConfig()).init(
                           list(params.values())))
    got = _run_port(state, train_step, 2)
    errs = _update_errors(init, got[-1][1], want[-1][1])
    assert np.median(list(errs.values())) > 10 * BF16_MEDIAN_TOL
    assert max(errs.values()) > BF16_UPDATE_TOL


def test_accumulation_matches_optax_multisteps():
    """k = 2: the running mean of two micro-step gradients makes one
    update; between updates the masters do not move."""
    init, want = _jax_run("float32", 4, every_k=2)
    _, state, train_step, _ = _port("float32", init, every_k=2)
    got = _run_port(state, train_step, 4)
    before = init
    for step, ((loss, params), (jloss, jparams)) in enumerate(
            zip(got, want), 1):
        assert abs(loss - jloss) <= F32_LOSS_TOL * abs(jloss), step
        if step % 2:  # first micro-step of two: no update
            assert all(torch.equal(params[n], before[n]) for n in init), step
        else:
            errs = _update_errors(init, params, jparams)
            assert max(errs.values()) <= F32_UPDATE_TOL, step
        before = params


def test_eval_step_matches_jax():
    init, _ = _jax_run("float32", 2)
    model = JaxMultiModel(dtype=jnp.float32, **_model_args())
    tx = jax_make_optimizer(JaxOptimConfig())
    batch = {k: jnp.asarray(v) for k, v in _batch(2).items()}
    jstate = jax_create_train_state(model, jax.random.key(0), batch, tx,
                                    init_kwargs={"buckets": BUCKETS})
    _, jax_eval = jax_make_multi_steps(model, tx, buckets=BUCKETS)
    want = float(jax_eval(jstate, batch)["loss"])
    _, state, _, eval_step = _port("float32", init)
    got = eval_step(state, _torch_batch(2))["loss"]
    np.testing.assert_allclose(got.item(), want, rtol=F32_LOSS_TOL)


def test_dropout_steps_are_reproducible_from_seed_and_step():
    """Train-mode dropout (0.1 everywhere, attention probabilities
    included) draws from (seed, step): the same seed repeats a step
    exactly, another seed changes it, and it differs from no dropout."""
    init, _ = _jax_run("float32", 2)
    runs = {}
    for label, seed, dropout in (("a", 0, 0.1), ("b", 0, 0.1),
                                 ("c", 1, 0.1), ("off", 0, 0.0)):
        _, state, train_step, _ = _port("float32", init, dropout=dropout)
        _, loss = train_step(state, _torch_batch(0), seed)
        runs[label] = (loss.item(), state.params)
    assert runs["a"][0] == runs["b"][0]
    assert all(torch.equal(runs["a"][1][n], runs["b"][1][n]) for n in init)
    assert runs["a"][0] != runs["c"][0]
    assert runs["a"][0] != runs["off"][0]


def test_create_train_state_holds_f32_masters():
    init, _ = _jax_run("float32", 2)
    model, state, _, _ = _port("bfloat16", init)
    for name, master in state.params.items():
        assert master.dtype == torch.float32
        assert torch.equal(master, init[name])  # not rounded through bf16
        assert master.data_ptr() != init[name].data_ptr()
    bad = dict(init)
    bad.pop("coordination.logit_scale")
    with pytest.raises(KeyError, match="coordination.logit_scale"):
        create_train_state(model, bad, make_optimizer(OptimConfig()))
