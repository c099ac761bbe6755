"""Train and eval steps for contrastive pretraining (``make_multi_steps``
of the JAX package's ``train/loop.py``).

One train step: load the f32 masters into the compute module, run
``MultiModel.loss`` in train mode with every dropout drawn from a CPU
generator seeded from (seed, step) (``fold_in(rng, state.step)`` in JAX),
backpropagate, upcast the gradients to f32 and update the masters; with
``every_k`` > 1 the gradients are averaged over k micro-steps first
(``optax.MultiSteps``). Nothing in the step reads a device value on the
host, so steps queue on the card back to back.

Not ported yet (ROADMAP.md): ``augment_fn`` (the on-device random
transforms), ``Fitter``, the drivers, checkpointing and the CLI.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

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
