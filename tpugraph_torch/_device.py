"""Device selection for the port (no counterpart in ``tpugraph``, where JAX
picks its default backend).

Every public entry point takes ``device=None``, which means the CUDA
card.  There is no silent move to the CPU: without CUDA the call raises,
and a caller that wants the CPU (the tests) says ``device="cpu"``.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def default_device(device: DeviceLike = None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means CUDA, and raises
    ``RuntimeError`` when CUDA is not available."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "tpugraph_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run on the CPU explicitly"
        )
    return torch.device("cuda")
