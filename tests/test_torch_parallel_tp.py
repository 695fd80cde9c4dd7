"""Tensor parallelism (``tpugraph_torch/parallel/tp.py``) on gloo ranks
against one device and against tpugraph's GSPMD step; mirrors
``tests/test_parallel.py:628`` (48 nodes, 16 features, hidden and
embedding 32, 3 layers, 3 classes, flax's initial weights):

* ``tp_shardings`` equals tpugraph's spec tree leaf by leaf at 2, 4 and
  8 ranks, through ``params_from_jax``'s names (a flax kernel's output
  dimension 1 is dimension 0 of the ``nn.Linear`` weight); the 3-class
  head stays whole;
* at 4 ranks: the forward within 1e-5 of tpugraph's; one SGD step moves
  every parameter as one device does within 1e-6 (a summed backward of
  the column join would move the earlier layers 4 times as far), also
  on a model with attention, the self term and batch norm; a
  global-norm clip that engages matches one device's within 1e-6; 5 Adam
  losses within tpugraph's 2e-4 relative of its TP step, the split
  weights still ``[in, out / 4]`` after them.

One group of 4 ranks runs every port case."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax
from jax.sharding import Mesh as JaxMesh, PartitionSpec as P

from tpugraph.core.graph import graph_from_dense as jax_graph_from_dense
from tpugraph.nn import GcnEncoderNode as JaxGcnEncoderNode
from tpugraph.nn.layers import SparseAdj as JaxSparseAdj
from tpugraph.parallel import tp as jax_tp
from tpugraph_torch.core.graph import graph_from_dense
from tpugraph_torch.nn import GcnEncoderNode, params_from_jax
from tpugraph_torch.parallel import tp
from tpugraph_torch.parallel.launch import call_each, run_ranks
from tpugraph_torch.parallel.mesh import Mesh
from tpugraph_torch.train.optim import OptimizerConfig, build_optimizer

torch.set_num_threads(1)

N, D, C, N_DEV = 48, 16, 3, 4
DIMS = dict(input_dim=D, hidden_dim=32, embedding_dim=32, label_dim=C, num_layers=3)
CFGS = {"sgd": OptimizerConfig(opt="sgd", lr=0.1),
        "clip": OptimizerConfig(opt="sgd", lr=0.1, clip=0.05),
        "adam": OptimizerConfig(opt="adam", lr=1e-2),
        "att_self_bn": OptimizerConfig(opt="sgd", lr=0.1)}
STEPS = {"sgd": 1, "clip": 2, "adam": 5, "att_self_bn": 1}
# every GraphConv branch of the TP forward: attention (its [in, in]
# weight split too), the self term and batch norm, on the port alone
OTHER = dict(att=True, add_self=True, bn=True)


@pytest.fixture(scope="module")
def problem():
    rng = np.random.default_rng(0)
    a = (rng.random((N, N)) < 0.12).astype(np.float32)
    a = np.triu(a, 1)
    a = a + a.T
    gj = jax_graph_from_dense(a)
    x = rng.standard_normal((gj.num_nodes_padded, D)).astype(np.float32)
    y = rng.integers(0, C, gj.num_nodes_padded).astype(np.int64)
    model_j = JaxGcnEncoderNode(**DIMS)
    sp = JaxSparseAdj(gj.senders, gj.receivers, gj.edge_weight)
    params = model_j.init(jax.random.PRNGKey(0), jnp.asarray(x), sp)
    model = GcnEncoderNode(**DIMS, device="cpu")
    model.load_state_dict(params_from_jax(params))
    return dict(a=a, gj=gj, g=graph_from_dense(a), x=x, y=y, model_j=model_j,
                sp=sp, params=params, model=model,
                mask=np.asarray(gj.node_mask, np.float32))


def _model(problem, kind):
    if kind == "att_self_bn":
        return GcnEncoderNode(**DIMS, **OTHER, generator=torch.Generator().manual_seed(1),
                              device="cpu")
    return problem["model"]


def _single(problem, kind):
    """One device: the same model, chain and loss as the TP step."""
    opt_cfg, steps = CFGS[kind], STEPS[kind]
    model = GcnEncoderNode(**DIMS, **(OTHER if kind == "att_self_bn" else {}),
                           device="cpu")
    model.load_state_dict(_model(problem, kind).state_dict())
    opt = build_optimizer(model.parameters(), opt_cfg)
    g = problem["g"]
    adj = tp.SparseAdj(g.senders.long(), g.receivers.long(), g.edge_weight)
    x, y, m = (torch.from_numpy(np.array(problem[k])) for k in ("x", "y", "mask"))
    losses, norms = [], []
    for _ in range(steps):
        opt.zero_grad()
        loss = tp.node_cross_entropy(model(x, adj)[0], y, node_mask=m)
        loss.backward()
        norms.append(float(torch.sqrt(sum(torch.sum(p.grad ** 2)
                                          for p in model.parameters()))))
        opt.step()
        losses.append(float(loss.detach()))
    return losses, norms, {k: v.detach() for k, v in model.named_parameters()}


@pytest.fixture(scope="module")
def runs(problem):
    calls = [(tp.tp_fit, (None, _model(problem, k), problem["g"], problem["x"],
                          problem["y"], problem["mask"], STEPS[k], CFGS[k]), {})
             for k in CFGS]
    return dict(zip(CFGS, run_ranks(call_each, N_DEV, "gloo", calls, timeout_s=300)))


@pytest.mark.parametrize("n", [2, 4, 8])
def test_shardings_match_tpugraph(problem, n):
    jmesh = JaxMesh(np.array(jax.devices()[:n]), ("model",))
    specs_j = jax_tp.tp_shardings(problem["params"], jmesh)
    names = params_from_jax(jax.tree_util.tree_map(lambda s: np.zeros(()), specs_j))
    flat = jax.tree_util.tree_leaves_with_path(specs_j["params"])
    specs = tp.tp_shardings(problem["model"], Mesh(("model",), (n,)))
    assert set(specs) == set(names) and len(flat) == len(specs)
    for path, sh in flat:
        keys = [k.key for k in path]
        name = next(k for k in names
                    if k.split(".")[-1] == ("weight" if keys[-1] == "kernel" else keys[-1])
                    and k.replace(".", "/").startswith(
                        "/".join(keys[:-1]).replace("conv_block_", "conv_block/")))
        want = None
        if sh.spec == P(None, "model"):
            want = 0 if keys[-1] == "kernel" else 1
        elif sh.spec == P("model"):
            want = 0
        assert specs[name] == want, (name, sh.spec)
    assert specs["pred_model.pred.weight"] is None and specs["pred_model.pred.bias"] is None
    assert specs["stack.conv_first.weight"] == 1


def test_forward_matches_tpugraph(problem, runs):
    want = np.asarray(problem["model_j"].apply(problem["params"],
                                               jnp.asarray(problem["x"]),
                                               problem["sp"])[0])
    np.testing.assert_allclose(runs["sgd"]["logits0"], want, atol=1e-5)


@pytest.mark.parametrize("kind", ["sgd", "clip", "att_self_bn"])
def test_step_matches_one_device(problem, runs, kind):
    """The TP update equals one device's, so no gradient is counted ``n``
    times; the clip engages (the global norm is above it)."""
    losses, norms, params = _single(problem, kind)
    got = runs[kind]
    np.testing.assert_allclose(got["losses"], losses, rtol=1e-6, atol=1e-7)
    if kind == "clip":
        assert min(norms) > CFGS[kind].clip
    moved = 0.0
    for name, p in params.items():
        np.testing.assert_allclose(got["params"][name].numpy(), p.numpy(),
                                   rtol=0, atol=1e-6, err_msg=name)
        moved = max(moved, float(torch.abs(p - _model(problem, kind).state_dict()[name]).max()))
    assert moved > 1e-3


def test_adam_matches_tpugraph(problem, runs):
    """5 Adam steps: the losses at tpugraph's 2e-4 relative of its TP
    step, and the split weights keep their ``[in, out / 4]`` blocks."""
    jmesh = JaxMesh(np.array(jax.devices()[:N_DEV]), ("model",))
    tx = optax.adam(1e-2)
    p = jax_tp.shard_params_tp(problem["params"], jmesh)
    o = tx.init(p)
    step = jax_tp.make_tp_node_train_step(problem["model_j"], tx, jmesh)
    gj = problem["gj"]
    want = []
    for _ in range(5):
        p, o, loss = step(p, o, gj.senders, gj.receivers, gj.edge_weight,
                          jnp.asarray(problem["x"]),
                          jnp.asarray(problem["y"].astype(np.int32)), gj.node_mask)
        want.append(float(loss))
    got = runs["adam"]
    np.testing.assert_allclose(got["losses"], want, rtol=2e-4)
    shapes = got["shard_shapes"]
    assert shapes["stack.conv_first.weight"] == (D, 32 // N_DEV)
    assert shapes["stack.conv_block.0.weight"] == (32, 32 // N_DEV)
    assert shapes["stack.conv_last.bias"] == (32 // N_DEV,)
    assert shapes["pred_model.pred.weight"] == (C, 96)
