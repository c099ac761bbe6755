"""Train and eval steps for contrastive pretraining and the epoch loop
(``make_multi_steps`` and ``Fitter`` of the JAX package's
``train/loop.py``).

One train step: load the f32 masters into the compute module, run
``MultiModel.loss`` in train mode with every dropout drawn from a CPU
generator seeded from (seed, step) (``fold_in(rng, state.step)`` in JAX),
backpropagate, upcast the gradients to f32 and update the masters; with
``every_k`` > 1 the gradients are averaged over k micro-steps first
(``optax.MultiSteps``). BatchNorm's running statistics update in the
train-mode forward, so once per micro-step, also while gradients
accumulate, as the JAX step returns ``batch_stats`` every micro-step; the
eval step normalizes with them and leaves them alone. A batch's ``label``
(class ids, for ArcFace) goes to the coordination head. Nothing in the
step reads a device value on the host, so steps queue on the card back to
back; ``Fitter`` reads the losses once per epoch.

Not ported yet (ROADMAP.md): ``augment_fn`` (the on-device random
transforms), ``make_classifier_steps``, ``train_multi``, checkpointing and
the CLI.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..models.dropout import dropout_rng
from .optim import Optimizer
from .state import TrainState

def _step_generator(seed: int, step: int) -> torch.Generator:
    """The CPU generator of one step, seeded from (seed, step) through
    numpy's ``SeedSequence`` (torch's CPU generator keeps 32 bits of a
    seed, so the pair is hashed, not packed)."""
    state = np.random.SeedSequence([seed, step]).generate_state(1)[0]
    return torch.Generator().manual_seed(int(state))


def make_multi_steps(model: nn.Module, tx: Optimizer, buckets: int = 1
                     ) -> Tuple[Callable, Callable]:
    """(train_step, eval_step) for ``model`` (a ``MultiModel`` at its
    compute dtype) and the optimizer ``tx``."""

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor],
                   seed: int) -> Tuple[TrainState, torch.Tensor]:
        """One micro-step; returns the updated state and the loss (a
        device scalar)."""
        state.load_into(model).train()
        model.zero_grad(set_to_none=True)
        with dropout_rng(_step_generator(seed, state.step)):
            loss = model.loss(buckets=buckets, **batch)
        loss.backward()
        named = dict(model.named_parameters())
        grads = [torch.zeros_like(m) if named[n].grad is None
                 else named[n].grad.float() for n, m in state.params.items()]
        k = tx.every_k
        if k > 1:
            n_acc = state.step % k
            if state.grad_acc is None:
                state.grad_acc = dict(zip(state.params,
                                          map(torch.zeros_like, grads)))
            acc = list(state.grad_acc.values())
            # Welford running mean, as optax.MultiSteps accumulates
            torch._foreach_add_(acc, torch._foreach_div(
                torch._foreach_sub(grads, acc), n_acc + 1))
            grads = acc if n_acc == k - 1 else None
        if grads is not None:
            for master, g in zip(state.params.values(), grads):
                master.grad = g.to(master.dtype)
            state.opt.step()
            if k > 1:
                state.grad_acc = None
        state.step += 1
        return state, loss.detach()

    @torch.no_grad()
    def eval_step(state: TrainState,
                  batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        state.load_into(model).eval()
        return {"loss": model.loss(buckets=buckets, **batch)}

    return train_step, eval_step


def _as_tensors(batch: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(v) for k, v in batch.items()}


class Fitter:
    """Epoch-driven training (the JAX package's ``Fitter``, a Lightning
    ``Trainer`` equivalent): per epoch, every train batch through
    ``train_step(state, batch, seed)``, the mean train loss read on the
    host once, validation every ``check_val_every_n_epoch`` epochs (its
    losses also read once), then ``history``, the writer, the
    ``on_epoch_end`` hook, the checkpointer (any object with ``save(epoch,
    state, metrics)`` and ``wait()``) and early stopping once
    ``min_epochs`` have run. ``put_fn`` places a batch (default: numpy to
    CPU tensors)."""

    def __init__(self, train_step: Callable, eval_step: Callable,
                 writer=None, checkpointer=None, early_stopping=None,
                 min_epochs: int = 1, max_epochs: int = 1,
                 check_val_every_n_epoch: int = 1, seed: int = 0,
                 hooks: Optional[Dict[str, Callable]] = None,
                 put_fn: Optional[Callable] = None) -> None:
        self.train_step = train_step
        self.eval_step = eval_step
        self.put_fn = put_fn or _as_tensors
        self.writer = writer
        self.checkpointer = checkpointer
        self.early_stopping = early_stopping
        self.min_epochs = min_epochs
        self.max_epochs = max_epochs
        self.check_val_every_n_epoch = check_val_every_n_epoch
        self.seed = seed
        self.hooks = hooks or {}
        self.history: list[Dict[str, float]] = []

    @staticmethod
    def _mean(losses) -> float:
        """One host read for a list of device scalars."""
        if not losses:
            return float("nan")
        return torch.stack(losses).float().mean().item()

    def _eval_epoch(self, state: TrainState, loader) -> Dict[str, float]:
        losses = [self.eval_step(state, self.put_fn(batch))["loss"]
                  for batch in loader]
        return {"valid_loss": self._mean(losses)}

    def fit(self, state: TrainState, train_loader,
            valid_loader=None) -> TrainState:
        for epoch in range(self.max_epochs):
            t0 = time.monotonic()
            train_losses = []
            n_samples = 0
            for batch in train_loader:
                batch = self.put_fn(batch)
                n_samples += int(next(iter(batch.values())).shape[0])
                state, loss = self.train_step(state, batch, self.seed)
                train_losses.append(loss)
            metrics: Dict[str, float] = {
                "train_loss": self._mean(train_losses)}
            if valid_loader is not None and \
                    (epoch + 1) % self.check_val_every_n_epoch == 0:
                metrics.update(self._eval_epoch(state, valid_loader))

            dt = time.monotonic() - t0
            metrics["samples_per_sec"] = n_samples / dt if dt > 0 else 0.0
            self.history.append(dict(metrics, epoch=epoch))
            if self.writer is not None:
                self.writer.log(
                    {k: v for k, v in metrics.items()
                     if k != "samples_per_sec"}, step=epoch)
            if "on_epoch_end" in self.hooks:
                self.hooks["on_epoch_end"](epoch, state, metrics)
            if self.checkpointer is not None:
                self.checkpointer.save(epoch, state, metrics)

            if self.early_stopping is not None and \
                    epoch + 1 >= self.min_epochs:
                monitor_val = metrics.get(self.early_stopping.monitor)
                if monitor_val is not None and \
                        self.early_stopping.update(monitor_val):
                    break
        if self.checkpointer is not None:
            self.checkpointer.wait()
        return state
