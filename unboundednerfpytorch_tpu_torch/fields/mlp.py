"""The view-dependent color MLP.

Counterpart of ``unboundednerfpytorch_tpu/fields/mlp.py``: Linear + ReLU
layers, ``depth`` Linear layers in all, the final bias zero-initialised,
weights and biases drawn from U(+-1/sqrt(fan_in)) as ``nn.Linear`` does.
``nn.Linear`` stores its weight as [out, in]; the converter in
:mod:`unboundednerfpytorch_tpu_torch.convert` transposes the JAX [in, out]
kernels.
"""

from __future__ import annotations

import math

import torch
from torch import nn


class MLP(nn.Module):
    def __init__(self, dim_in: int, dim_hidden: int, dim_out: int, depth: int,
                 zero_final_bias: bool = True, generator: torch.Generator | None = None,
                 device=None):
        super().__init__()
        dims = [dim_in] + [dim_hidden] * (depth - 1) + [dim_out]
        layers = []
        for i in range(depth):
            lin = nn.Linear(dims[i], dims[i + 1], device=device)
            bound = 1.0 / math.sqrt(dims[i])
            with torch.no_grad():
                lin.weight.copy_(
                    (torch.rand(lin.weight.shape, generator=generator) * 2 - 1) * bound)
                if zero_final_bias and i == depth - 1:
                    lin.bias.zero_()
                else:
                    lin.bias.copy_(
                        (torch.rand(lin.bias.shape, generator=generator) * 2 - 1) * bound)
            layers.append(lin)
        self.layers = nn.ModuleList(layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n = len(self.layers)
        for i, lin in enumerate(self.layers):
            x = lin(x)
            if i < n - 1:
                x = torch.relu(x)
        return x
