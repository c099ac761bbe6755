"""Closed-loop training: one train step after another on batches resident
on the card, as the thesis's pretraining sweeps spend their card time.

Set-up builds the card's model at its compute dtype, its optimizer and
its train state from weights made from the seed (``train/drivers.py``
``multi_state`` without the init: the benchmark makes the weights), and
the step ``train/loop.py`` ``make_multi_steps(model, tx,
step_buckets(card))``; it makes the traffic's pool of distinct batches on
the card. The same state and step then run:

1. the check steps: the first ``check_steps`` steps, on pool batches 0,
   1, 2..., with the model's dropout rates set to 0 (the reference cannot
   draw the masks the program draws inside its kernels); their losses,
   the first gradient from the optimizer's state and the weights after
   them are kept;
2. ``warm_steps`` steps at the card's dropout; the first is tapped
   (``harness/taps.py``): the first call of the attention core of each
   shape and of elementwise dropout at a rate above 0, inputs and output,
   for the dropout numbers (``reference/dropout.py``);
3. the window: steps on the pool in turn until ``seconds`` have passed
   on the host, then a synchronize; train pairs/s is every pair of every
   step over the window's time; each step's dispatch on the host is
   timed too. With ``--trace 1`` a profiled sub-window of
   ``trace_steps`` steps follows.

After the window the peak memory is read, the program's state freed, and
the reference runs the check steps from the same weights on the same
batches in float32 (``reference/multi.py``) and judges the tapped
dropout.
"""

from __future__ import annotations

import gc
from time import perf_counter as now
from typing import Dict, List, Optional

import torch

from ..harness import compare, inputs
from ..harness.runner import Record, RunOutput
from ..harness.taps import tap_dropout
from ..harness.trace import profile_window
from ..harness.weights import make_weights
from ..reference import multi as ref
from ..reference.dropout import dropout_numbers
from ..reference.precision import strict_f32

LABELS, PAIRS = 2, 3  # seed streams


def dropout_off(model: torch.nn.Module) -> List:
    """Set every dropout rate of the model's modules to 0; returns what
    to restore."""
    saved = []
    for mod in model.modules():
        for attr in ("dropout", "dropout_rate"):
            value = getattr(mod, attr, None)
            if isinstance(value, float) and value > 0:
                saved.append((mod, attr, value))
                setattr(mod, attr, 0.0)
    return saved


def restore(saved: List) -> None:
    for mod, attr, value in saved:
        setattr(mod, attr, value)


def make_pool(card: Dict, traffic: Dict, seed: int, device,
              count: Optional[int] = None) -> List[Dict]:
    """The traffic's pool of distinct batches (its first ``count``)."""
    size = card.get("target_size", 224)
    kind = card["profile_encoder_args"]["kind"]
    n, classes = traffic["batch"], traffic["classes"]
    return [inputs.pairs(
        inputs.long_tailed_labels(n, classes, inputs.rng(seed, LABELS, i)),
        classes, size, kind, seed, PAIRS, i, device=device)
        for i in range(count or traffic["pool"])]


def live_keys(pool: List[Dict]) -> float:
    """Mean live (unpadded) keys a row of the pool's profiles."""
    masks = [b["padding_mask"] for b in pool if "padding_mask" in b]
    if not masks:
        return None
    return float(torch.cat(masks).logical_not().float().sum(1).mean())


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(cell, seed: int, seconds: float, trace: bool, device,
        t0: float, ranges=()) -> RunOutput:
    from multimodal_plankton_recognition_torch.config import ModelCard
    from multimodal_plankton_recognition_torch.models.build import (
        build_multi_model, step_buckets)
    from multimodal_plankton_recognition_torch.train.loop import \
        make_multi_steps
    from multimodal_plankton_recognition_torch.train.optim import \
        make_optimizer
    from multimodal_plankton_recognition_torch.train.state import \
        create_train_state

    phases = {"imports": now() - t0}
    traffic, card_d = cell.traffic, cell.config["card"]
    card = ModelCard.from_dict(card_d)
    batch = traffic["batch"]
    if card.bs != batch:
        raise ValueError(f"the card's bs {card.bs} is not the traffic's "
                         f"batch {batch}")
    # the program's rule for its step, the benchmark's for the reference
    buckets = card_buckets(card_d)
    if step_buckets(card) != buckets:
        raise ValueError(f"the program's step takes {step_buckets(card)} "
                         f"contrastive buckets, the card {buckets}")
    weights = make_weights(card_d, seed, device)
    model = build_multi_model(card).to(device)
    tx = make_optimizer(card.optim_args,
                        card.trainer_args.accumulate_grad_batches)
    state = create_train_state(model, weights, tx)
    train_step, _ = make_multi_steps(model, tx, step_buckets(card))
    phases["model"] = now() - t0
    pool = make_pool(card_d, traffic, seed, device)
    keys = live_keys(pool)
    phases["inputs"] = now() - t0
    n_check, pool_n = traffic["check_steps"], traffic["pool"]

    # 1. the check steps, without dropout
    saved = dropout_off(model)
    losses, grad1 = [], None
    wd = card.optim_args.weight_decay
    for i in range(n_check):
        state, loss = train_step(state, pool[i], seed)
        losses.append(loss)
        if grad1 is None:
            grad1 = first_gradient(state, weights, wd)
    change = {n: p.detach() - weights[n] for n, p in state.params.items()}
    restore(saved)
    losses = [float(x) for x in losses]
    phases["check_steps"] = now() - t0

    # 2. warm-up at the card's dropout, its first step tapped
    at, taps = n_check, {}
    with tap_dropout(taps):
        state, _ = train_step(state, pool[at % pool_n], seed)
    at += 1
    for _ in range(traffic["warm_steps"] - 1):
        state, _ = train_step(state, pool[at % pool_n], seed)
        at += 1
    sync(device)
    setup_s = phases["warm_steps"] = now() - t0

    # 3. the window
    window_losses, dispatch = [], []
    steps, start = 0, now()
    while True:
        t = now()
        state, loss = train_step(state, pool[at % pool_n], seed)
        dispatch.append(now() - t)
        window_losses.append(loss)
        steps += 1
        at += 1
        if now() - start >= seconds:
            break
    sync(device)
    wall = now() - start
    record = Record(kind="train", card=card_d, batch=batch,
                    buckets=buckets, units=steps, wall_s=wall,
                    dispatch_s=dispatch, profile_keys=keys)
    if trace:
        k = traffic["trace_steps"]

        def steps_fn():
            nonlocal state, at
            for _ in range(k):
                state, loss = train_step(state, pool[at % pool_n], seed)
                window_losses.append(loss)
                at += 1

        record.trace = profile_window(steps_fn, ranges,
                                      device.type == "cuda")
        record.trace_units = k
    failed = int((~torch.isfinite(torch.stack(window_losses))).sum())
    peak = torch.cuda.max_memory_allocated(device) \
        if device.type == "cuda" else 0

    # the reference, once the program's state is freed
    check = pool[:n_check]
    del state, model, train_step, tx, window_losses, pool
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    with strict_f32():
        reference = ref.train_steps(card_d, weights, check, buckets)
        reference["change"] = {n: reference["params"][n] - weights[n]
                               for n in reference["params"]}
        numbers = compare.train_numbers(losses, grad1, change, reference)
        numbers.update(dropout_numbers(taps, device))
    return RunOutput(
        end_to_end={"train_pairs_per_s": steps * batch / wall,
                    "setup_s": setup_s},
        attempted=steps, failed=failed, numbers=numbers,
        memory_peak_bytes=peak, record=record, phases=phases)


def first_gradient(state, weights: Dict[str, torch.Tensor],
                   weight_decay: float) -> Dict[str, torch.Tensor]:
    """The gradient the optimizer got in the first step, from its state:
    SGD's momentum buffer after one step is g + wd·w0 (without momentum,
    the masters' ``.grad``)."""
    out = {}
    for name, p in state.params.items():
        buf = state.opt.state.get(p, {}).get("momentum_buffer")
        if buf is None:
            out[name] = p.grad.detach().clone()
        else:
            out[name] = buf.detach() - weight_decay * weights[name]
    return out


def card_buckets(card: Dict) -> int:
    """The contrastive buckets of a one-card step by the card: one where
    it asks for global negatives. The reference's count; a run whose
    program step takes another is refused."""
    negatives = (card.get("coordination_args") or {}).get("negatives")
    return 1 if negatives == "global" else card["buckets"]


def control_numbers(cell, seed: int, device, prec=ref.F32,
                    rows: Optional[int] = None) -> Dict[str, float]:
    """The numbers with the reference put in the program's place: at
    ``prec`` (the control), or on the first ``rows`` pairs of each batch
    (the fault of half the batch left out)."""
    traffic, card = cell.traffic, cell.config["card"]
    buckets = card_buckets(card)
    weights = make_weights(card, seed, device)
    check = make_pool(card, traffic, seed, device, traffic["check_steps"])
    with strict_f32():
        base = ref.train_steps(card, weights, check, buckets)
        other = ref.train_steps(card, weights, check, buckets, prec, rows)
    for out in (base, other):
        out["change"] = {n: out["params"][n] - weights[n]
                         for n in out["params"]}
    return compare.train_numbers(other["losses"], other["grad1"],
                                 other["change"], base)
