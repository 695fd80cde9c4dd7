"""Port of ``tpugraph/parallel``: multi-device training on
``torch.distributed``.

* :mod:`~tpugraph_torch.parallel.mesh` — ``Mesh`` (a process group with
  named axes), ``make_mesh``, ``init_distributed``;
* :mod:`~tpugraph_torch.parallel.launch` — ``run_ranks``, which spawns a
  group (gloo on the CPU, NCCL with a card a rank);
* :mod:`~tpugraph_torch.parallel.collectives` — the differentiable
  collectives;
* :mod:`~tpugraph_torch.parallel.spmd` — edge-sharded and halo message
  passing, their plans and training steps, and the data-parallel graph
  step (imported on its own: it needs ``tpugraph_torch.nn``, which needs
  the collectives).

Tensor parallelism (``tpugraph/parallel/tp.py``) is not ported.
"""

from tpugraph_torch.parallel.launch import run_ranks  # noqa: F401
from tpugraph_torch.parallel.mesh import Mesh, init_distributed, make_mesh  # noqa: F401
