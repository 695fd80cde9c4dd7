"""Port of ``tpugraph/nn/initializers.py``: the reference's PyTorch init
distributions, drawn from an explicit ``torch.Generator``.

The same seed does not give ``tpugraph``'s numbers (``jax.random`` and
``torch.Generator`` differ); parity tests load the JAX parameters with
:func:`tpugraph_torch.nn.encoders.params_from_jax` instead.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch


def _uniform(shape: Tuple[int, ...], bound: float,
             generator: Optional[torch.Generator]) -> torch.Tensor:
    return torch.empty(shape, dtype=torch.float32).uniform_(
        -bound, bound, generator=generator)


def xavier_relu_uniform(shape: Tuple[int, int],
                        generator: Optional[torch.Generator] = None):
    """U(-b, b), b = sqrt(2) * sqrt(6 / (fan_in + fan_out)); ``shape`` is
    ``[fan_in, fan_out]``."""
    bound = math.sqrt(2.0) * math.sqrt(6.0 / (shape[0] + shape[1]))
    return _uniform(shape, bound, generator)


def torch_linear_kernel(shape: Tuple[int, int],
                        generator: Optional[torch.Generator] = None):
    """``nn.Linear`` default weight init, bound 1/sqrt(fan_in); ``shape``
    is torch's ``[fan_out, fan_in]``."""
    fan_in = shape[1]
    return _uniform(shape, 1.0 / math.sqrt(fan_in) if fan_in > 0 else 0.0,
                    generator)


def torch_linear_bias(fan_in: int, shape: Tuple[int],
                      generator: Optional[torch.Generator] = None):
    """``nn.Linear`` default bias init, bound 1/sqrt(fan_in)."""
    return _uniform(shape, 1.0 / math.sqrt(fan_in) if fan_in > 0 else 0.0,
                    generator)


def xavier_relu_normal(shape: Tuple[int, ...], fan_in: int, fan_out: int,
                       generator: Optional[torch.Generator] = None):
    """N(0, s^2), s = sqrt(2) * sqrt(2 / (fan_in + fan_out)): torch's
    ``xavier_normal_`` with the ReLU gain, as DGL's ``GATConv`` draws its
    weights and attention vectors."""
    std = math.sqrt(2.0) * math.sqrt(2.0 / (fan_in + fan_out))
    return torch.empty(shape, dtype=torch.float32).normal_(0.0, std,
                                                           generator=generator)
