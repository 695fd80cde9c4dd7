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
  step;
* :mod:`~tpugraph_torch.parallel.tp` — tensor parallelism: the node
  encoder's weights split on their output dimension, and its training
  step.

``spmd`` and ``tp`` are imported on their own: they need
``tpugraph_torch.nn``, which needs the collectives.  The explainer's
query sharding is ``Explainer.explain_nodes_batch(mesh=)`` and
``explain_nodes_bcsr(mesh=)`` (:mod:`tpugraph_torch.explain.explainer`).
"""

from tpugraph_torch.parallel.launch import run_ranks  # noqa: F401
from tpugraph_torch.parallel.mesh import Mesh, init_distributed, make_mesh  # noqa: F401
