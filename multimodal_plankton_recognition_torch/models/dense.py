"""``Dense``: the port's counterpart of a flax ``nn.Dense``, an
``nn.Linear`` that runs the W8A8 int8 path inside
``ops.quant.quantized_dense`` (JAX's interceptor swaps exactly the
``nn.Dense`` calls). The parameters, their names and the converted Flax
tree are those of ``nn.Linear``."""

from __future__ import annotations

import torch
from torch import nn

from ..ops.quant import dense_int8, quantizing


class Dense(nn.Linear):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if quantizing():
            return dense_int8(self, x)
        return super().forward(x)
