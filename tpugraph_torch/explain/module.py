"""Port of the parts of ``tpugraph/explain/module.py`` the tile-space
explainer uses: ``ExplainConfig``, ``_act`` and ``_binary_ent``."""

from __future__ import annotations

from typing import NamedTuple

import torch


class ExplainConfig(NamedTuple):
    """Mask-optimization hyperparameters (the reference's defaults, as in
    ``tpugraph/explain/module.py:38``; the fields the tile-space path
    reads)."""

    num_epochs: int = 100
    lr: float = 0.1
    mask_act: str = "sigmoid"   # sigmoid | ReLU | none
    use_sigmoid: bool = True
    coeff_size: float = 0.005
    coeff_feat_size: float = 1.0
    coeff_ent: float = 1.0
    coeff_feat_ent: float = 0.1  # computed, not added — reference parity
    coeff_lap: float = 1.0
    mask_features: bool = True


def _act(x: torch.Tensor, mask_act: str) -> torch.Tensor:
    if mask_act == "sigmoid":
        return torch.sigmoid(x)
    if mask_act == "ReLU":
        return torch.relu(x)
    return x


def _binary_ent(p: torch.Tensor) -> torch.Tensor:
    return -p * torch.log(p + 1e-12) - (1 - p) * torch.log(1 - p + 1e-12)
