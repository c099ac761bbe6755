"""Train state: step, f32 master weights, optimizer (``train/state.py`` of
the JAX package).

The JAX package keeps every parameter in f32 and casts it to the compute
dtype at use, so an SGD update smaller than a bf16 step still lands. The
port keeps its modules at the compute dtype (bf16 for the flagship, as the
serving path has them) and holds the f32 masters here: each step loads the
masters into the module, takes the module's gradients upcast to f32 (the
gradient JAX gives an f32 parameter used in bf16), and updates the masters.

BatchNorm's running statistics (the Flax ``batch_stats`` collection) are
buffers, not masters: they stay f32 in the module, which updates them in
its train-mode forward, and ``load_into`` never touches them.
``TrainState.batch_stats`` names the module's own buffers.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional

import torch
from torch import nn

from .optim import Optimizer


@dataclasses.dataclass
class TrainState:
    """``params``: f32 master weights by parameter name; ``opt``: the torch
    optimizer over them; ``grad_acc``: the running mean of the micro-step
    gradients while accumulating (``optax.MultiSteps``); ``batch_stats``:
    the module's BatchNorm running statistics by buffer name (the live
    buffers, not copies). Train steps update the state in place and return
    it."""

    step: int
    params: Dict[str, torch.Tensor]
    opt: torch.optim.Optimizer
    grad_acc: Optional[Dict[str, torch.Tensor]] = None
    batch_stats: Dict[str, torch.Tensor] = dataclasses.field(
        default_factory=dict)

    @torch.no_grad()
    def load_into(self, model: nn.Module) -> nn.Module:
        """Copy the masters into ``model``, cast to its parameters' dtype."""
        named = dict(model.named_parameters())
        torch._foreach_copy_([named[n] for n in self.params],
                             list(self.params.values()))
        return model


def create_train_state(model: nn.Module,
                       state_dict: Mapping[str, torch.Tensor],
                       tx: Optimizer) -> TrainState:
    """Masters from ``state_dict`` (e.g. ``convert.from_flax``, which gives
    the Flax tree's f32 leaves), upcast to f32 and placed on the module's
    device, then loaded into ``model``; the state dict's BatchNorm
    statistics are copied into the module's buffers. The state dict must
    name exactly the module's parameters and buffers."""
    named = dict(model.named_parameters())
    buffers = dict(model.named_buffers())
    expected = set(named) | set(buffers)
    if set(state_dict) != expected:
        raise KeyError(
            f"state dict and model disagree: missing "
            f"{sorted(expected - set(state_dict))}, unexpected "
            f"{sorted(set(state_dict) - expected)}")
    params = {n: state_dict[n].detach().to(p.device, torch.float32,
                                           copy=True)
              for n, p in named.items()}
    with torch.no_grad():
        for n, b in buffers.items():
            b.copy_(state_dict[n])
    state = TrainState(step=0, params=params,
                       opt=tx.init(list(params.values())), batch_stats=buffers)
    state.load_into(model)
    return state
