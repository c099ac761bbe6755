"""Train-mode dropout and where its random numbers come from.

The JAX package threads a ``dropout`` PRNG key through ``model.apply``; a
train step folds the step number into it. Here a train step opens
``dropout_rng(generator)`` around its forward with a CPU
``torch.Generator`` seeded from (seed, step), and every dropout site draws
from it:

* the attention and feed-forward kernels take an integer seed per call,
  drawn on the CPU (``kernel_seed``), so no layer makes the host wait for
  the card;
* elementwise dropout (``dropout``) draws its mask on the tensor's device
  from a generator of that device, seeded once per step from the CPU
  generator.

Outside a train step, train-mode dropout with a rate above 0 raises: there
is no hidden global stream.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Dict, Iterator, Optional

import torch


class DropoutRng:
    """The random numbers of one train step."""

    def __init__(self, generator: torch.Generator) -> None:
        if generator.device.type != "cpu":
            raise ValueError("the step's dropout generator must be a CPU "
                             "generator (a device draw would sync the host)")
        self.cpu = generator
        self._devices: Dict[torch.device, torch.Generator] = {}

    def seed(self) -> int:
        """A 31-bit seed for one kernel call."""
        return int(torch.randint(0, 2 ** 31 - 1, (1,), generator=self.cpu))

    def generator(self, device: torch.device) -> torch.Generator:
        """The generator for elementwise masks on ``device``."""
        if device.type == "cpu":
            return self.cpu
        gen = self._devices.get(device)
        if gen is None:
            gen = torch.Generator(device=device).manual_seed(self.seed())
            self._devices[device] = gen
        return gen


_CURRENT: contextvars.ContextVar[Optional[DropoutRng]] = \
    contextvars.ContextVar("plankton_dropout_rng", default=None)


@contextlib.contextmanager
def dropout_rng(generator: torch.Generator) -> Iterator[DropoutRng]:
    """Draw every train-mode dropout inside the block from ``generator``."""
    token = _CURRENT.set(DropoutRng(generator))
    try:
        yield _CURRENT.get()
    finally:
        _CURRENT.reset(token)


def _current() -> DropoutRng:
    rng = _CURRENT.get()
    if rng is None:
        raise RuntimeError(
            "train-mode dropout needs the step's generator: run the forward "
            "inside models.dropout.dropout_rng(generator) (train_step does), "
            "or call .eval()")
    return rng


def kernel_seed(rate: float, training: bool) -> tuple[float, int]:
    """(probability, seed) for one call of a kernel that drops inside
    (attention probabilities, the fused FFN's hidden): (0, 0) in eval mode
    or at rate 0."""
    if not training or rate == 0.0:
        return 0.0, 0
    return rate, _current().seed()


def keep_mask(shape, rate: float, device: torch.device,
              dtype: torch.dtype) -> torch.Tensor:
    """A keep mask of ``shape`` in ``dtype`` (1 kept, 0 dropped), kept with
    probability 1 - rate, drawn from the step's generator for ``device``
    (flax's ``random.bernoulli`` mask of ``dot_product_attention``)."""
    return torch.empty(shape, dtype=dtype, device=device).bernoulli_(
        1.0 - rate, generator=_current().generator(device))


def dropout(x: torch.Tensor, rate: float, training: bool) -> torch.Tensor:
    """``flax.linen.Dropout``: keep with probability 1 - rate and scale
    kept values by 1 / (1 - rate), in ``x``'s dtype."""
    if not training or rate == 0.0:
        return x
    keep = torch.empty_like(x).bernoulli_(
        1.0 - rate, generator=_current().generator(x.device))
    return x * keep / (1.0 - rate)
