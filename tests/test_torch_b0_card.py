"""The B0 family's train path against the JAX package's: two micro-steps
of the B0 CLIP model card
(``model_cards/multi/efficientnet_b0_cnn_2_512_clip.yaml``) shrunk to 32 px,
bs 8, buckets 2, accumulation 2 and dropout 0, against the JAX train step,
and the BatchNorm running statistics through the train loop. The serving
path is in ``tests/test_torch_b0_encode.py``.

Tolerances: ``tests/test_torch_card.py``'s f32 bounds (the loss to 1e-5
relative, every master's update to 1e-3 relative L2) and the running
statistics to 1e-4 of max(1, |·|). A master whose JAX update is below
1e-4 of the median one is a structural zero (the bias of a BatchNorm whose
output only reaches another train-mode BatchNorm: its gradient is 0 up to
rounding); the port's update must be as small. The bf16 fused
micro-steps are in ``tests/test_torch_b0_card_bf16.py``.
"""

import copy
import functools
import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import torch
import yaml

from multimodal_plankton_recognition_tpu import config as jax_config
from multimodal_plankton_recognition_tpu.models.build import (
    build_multi_model as jax_build_multi_model,
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
from multimodal_plankton_recognition_torch import config
from multimodal_plankton_recognition_torch.convert import from_flax
from multimodal_plankton_recognition_torch.models.build import (
    build_multi_model, step_buckets,
)
from multimodal_plankton_recognition_torch.models.flagships import (
    synthetic_batch_b0,
)
from multimodal_plankton_recognition_torch.train import (
    create_train_state, make_multi_steps, make_optimizer,
)
from torch_threads import one_thread  # noqa: F401  (autouse)

REPO = Path(__file__).resolve().parent.parent
B0_CLIP_CARD = REPO / "model_cards/multi/efficientnet_b0_cnn_2_512_clip.yaml"
SIZE, BS = 32, 8
F32_LOSS_TOL, F32_UPDATE_TOL, STATS_TOL = 1e-5, 1e-3, 1e-4
STRUCTURAL_ZERO = 1e-4  # of the median per-element update


def small_b0_card(precision: str, fused_mbconv: bool = False) -> dict:
    """The B0 CLIP card at 32 px, bs 8 in 2 buckets, accumulation 2,
    dropout 0."""
    d = yaml.safe_load(B0_CLIP_CARD.read_text())
    d.update(target_size=SIZE, bs=BS, buckets=2)
    d["image_encoder_args"].update(dropout=0.0, fused_mbconv=fused_mbconv)
    d["profile_encoder_args"].update(dropout=0.0)
    d["trainer_args"].update(precision=precision, accumulate_grad_batches=2)
    return d


def b0_batch(seed: int) -> dict:
    """The synthetic B0 batch (numpy), the JAX package's stream."""
    return {k: v.numpy() for k, v in synthetic_batch_b0(
        BS, img=SIZE, plen=SIZE, seed=seed).items()}


def _variables(state) -> dict:
    return from_flax({"params": jax.tree.map(np.asarray, state.params),
                      "batch_stats": jax.tree.map(np.asarray,
                                                  state.batch_stats)})


@functools.cache
def jax_card_run(precision: str, fused_mbconv: bool):
    """The JAX card-built model and train step on batches 0 and 1: the
    initial variables and (loss, variables) after each micro-step, in the
    port's names. bf16 runs the Pallas kernels in interpret mode."""
    d = small_b0_card(precision, fused_mbconv)
    card = jax_config.ModelCard.from_dict(copy.deepcopy(d))
    interpret = card.trainer_args.compute_dtype == "bfloat16"
    old = os.environ.get("PLANKTON_FUSED_INTERPRET")
    if interpret:
        os.environ["PLANKTON_FUSED_INTERPRET"] = "1"
    try:
        model = jax_build_multi_model(card)
        tx = jax_make_optimizer(card.optim_args,
                                card.trainer_args.accumulate_grad_batches)
        batches = [{k: jnp.asarray(v) for k, v in b0_batch(s).items()}
                   for s in (0, 1)]
        state = jax.jit(lambda key: jax_create_train_state(
            model, key, batches[0], tx,
            init_kwargs={"buckets": card.buckets}))(jax.random.key(0))
        train_step, _ = jax_make_multi_steps(model, tx, card.buckets)
        init = _variables(state)
        after = []
        for i in range(2):
            state, loss = train_step(state, batches[i], jax.random.key(1))
            after.append((float(loss), _variables(state)))
    finally:
        if interpret:
            if old is None:
                os.environ.pop("PLANKTON_FUSED_INTERPRET")
            else:
                os.environ["PLANKTON_FUSED_INTERPRET"] = old
    return d, init, after


def port_card_run(d: dict, init: dict):
    """The port's card-built model and train step from ``init`` on batches
    0 and 1: (state, [(loss, masters and running statistics)])."""
    card = config.ModelCard.from_dict(copy.deepcopy(d))
    model = build_multi_model(card)
    tx = make_optimizer(card.optim_args,
                        card.trainer_args.accumulate_grad_batches)
    state = create_train_state(model, init, tx)
    train_step, _ = make_multi_steps(model, tx, step_buckets(card))
    out = []
    for i in range(2):
        batch = {k: torch.from_numpy(v) for k, v in b0_batch(i).items()}
        state, loss = train_step(state, batch, 0)
        out.append((loss.item(), {
            **{n: m.clone() for n, m in state.params.items()},
            **{n: b.clone() for n, b in state.batch_stats.items()}}))
    return state, out


def update_errors(init: dict, got: dict, want: dict, names):
    """{name: relative L2 error of the port's update}, and the structural
    zeros as {name: port update RMS / median JAX update RMS}."""
    rms = {n: ((want[n] - init[n]).double().norm()
               / want[n].numel() ** 0.5).item() for n in names}
    median = float(np.median(list(rms.values())))
    errs, zeros = {}, {}
    for n in names:
        delta = (got[n] - init[n]).double()
        if rms[n] < STRUCTURAL_ZERO * median:
            zeros[n] = (delta.norm() / delta.numel() ** 0.5).item() / median
            continue
        w = (want[n] - init[n]).double()
        errs[n] = ((delta - w).norm() / w.norm()).item()
    return errs, zeros


def _stats_close(got: dict, want: dict, names, tol: float) -> None:
    for n in names:
        assert got[n].dtype == torch.float32, n
        w = want[n].numpy()
        np.testing.assert_allclose(got[n].numpy(), w, rtol=0,
                                   atol=tol * max(1.0, np.abs(w).max()),
                                   err_msg=n)


def test_b0_card_f32_micro_steps_match_jax():
    """``build_multi_model(card)`` with the card's optimizer at
    accumulation 2: the first micro-step leaves the masters as they were
    and updates every running statistic, the second updates both, each as
    the JAX step does."""
    d, init, want = jax_card_run("32", False)
    state, got = port_card_run(d, init)
    params = sorted(state.params)
    stats = sorted(state.batch_stats)
    assert len(stats) == 2 * (49 + 20)  # B0's 49 BatchNorms, the CNN's 20
    for step, ((loss, values), (jloss, jvalues)) in enumerate(
            zip(got, want), 1):
        assert abs(loss - jloss) <= F32_LOSS_TOL * abs(jloss), step
        _stats_close(values, jvalues, stats, STATS_TOL)
        assert not any(torch.equal(values[n], init[n]) for n in stats
                       if n.endswith("running_var"))
        if step == 1:
            assert all(torch.equal(values[n], init[n]) for n in params)
            continue
        errs, zeros = update_errors(init, values, jvalues, params)
        worst = max(errs, key=errs.get)
        assert errs[worst] <= F32_UPDATE_TOL, (worst, errs[worst])
        assert zeros and all(n.endswith("project_bn.bias") for n in zeros)
        assert max(zeros.values()) < STRUCTURAL_ZERO, zeros


def test_running_statistics_through_the_train_loop():
    """Once per micro-step, also while gradients accumulate; the eval step
    normalizes with them and leaves them alone; they stay f32 in a bf16
    module; ``TrainState.batch_stats`` holds the live buffers and
    ``load_into`` never writes them."""
    card = config.ModelCard.from_dict(small_b0_card("16-mixed"))
    model = build_multi_model(card)
    init = {n: t.detach().float().clone()
            for n, t in model.state_dict().items()}
    tx = make_optimizer(card.optim_args, 2)
    state = create_train_state(model, init, tx)
    train_step, eval_step = make_multi_steps(model, tx, step_buckets(card))
    buffers = dict(model.named_buffers())
    assert state.batch_stats.keys() == buffers.keys()
    assert all(state.batch_stats[n] is b for n, b in buffers.items())
    batch = {k: torch.from_numpy(v) for k, v in b0_batch(0).items()}

    def snapshot():
        return {n: b.clone() for n, b in state.batch_stats.items()}

    before = snapshot()
    for i in range(2):
        state, _ = train_step(state, batch, 0)
        now = snapshot()
        moved = [n for n in now if not torch.equal(now[n], before[n])]
        assert len(moved) == len(now), i  # every statistic, every step
        before = now
    out = eval_step(state, batch)
    assert torch.isfinite(out["loss"])
    assert all(torch.equal(b, before[n])
               for n, b in state.batch_stats.items())
    state.load_into(model)
    assert all(torch.equal(b, before[n])
               for n, b in state.batch_stats.items())
    assert all(b.dtype == torch.float32 for b in buffers.values())
    assert model.image_encoder.backbone.stem_conv.weight.dtype == \
        torch.bfloat16
