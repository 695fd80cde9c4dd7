"""Port of ``tpugraph/nn/encoders.py``: ``ConvStack``, ``PredHead``,
``GcnEncoderNode``, the graph classifier ``GcnEncoderGraph`` and the
DiffPool ``SoftPoolingGcnEncoder``, plus :func:`params_from_jax`; and the
port's own :class:`GatEncoderNode` and :class:`DeeperGcnEncoderNode`, which
have no ``tpugraph`` counterpart.

Module and parameter names follow the flax tree, so a ``tpugraph``
parameter tree maps onto the ``state_dict`` by name:
``stack/conv_block_0/weight`` is ``stack.conv_block.0.weight`` and
``assign_stack_0/conv_first/weight`` is
``assign_stack.0.conv_first.weight``.  Flax ``Dense`` kernels are
``[in, out]`` and torch ``Linear`` weights ``[out, in]``;
``GraphConv.weight`` stays ``[in, out]``.  Parameters are drawn in the
order flax creates them.
"""

from __future__ import annotations

import re
from typing import Dict, Optional, Sequence

import numpy as np
import torch
from torch import nn

from tpugraph_torch._device import DeviceLike, default_device
from tpugraph_torch.nn.initializers import torch_linear_bias, torch_linear_kernel
from tpugraph_torch.nn.layers import (Adjacency, GATConv, GENConv, GraphConv, SparseAdj,
                                      apply_dropout, fresh_batch_norm)
from tpugraph_torch.ops.epilogue_kernels import row_epilogue
from tpugraph_torch.utils.profiling import trace_annotation, trace_backward


def _torch_dense(out_dim: int, in_dim: int,
                 generator: Optional[torch.Generator]) -> nn.Linear:
    """``nn.Linear`` with the reference's default init drawn from
    ``generator`` (``tpugraph/nn/encoders.py:43``)."""
    lin = nn.Linear(in_dim, out_dim)
    with torch.no_grad():
        lin.weight.copy_(torch_linear_kernel((out_dim, in_dim), generator))
        lin.bias.copy_(torch_linear_bias(in_dim, (out_dim,), generator))
    return lin


class PredHead(nn.Module):
    """Linear or MLP prediction head (``tpugraph/nn/encoders.py:52``)."""

    def __init__(self, input_dim: int, hidden_dims: Sequence[int],
                 label_dim: int, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.pred_hidden = nn.ModuleList()
        d = input_dim
        for h in hidden_dims:
            self.pred_hidden.append(_torch_dense(h, d, generator))
            d = h
        self.pred = _torch_dense(label_dim, d, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for lin in self.pred_hidden:
            x = torch.relu(lin(x))
        return self.pred(x)


class ConvStack(nn.Module):
    """conv_first -> (L-2) x conv_block -> conv_last with ReLU (and, with
    ``bn``, :func:`fresh_batch_norm`) between, L2-normalized embeddings,
    returning the per-layer concatenation
    (``tpugraph/nn/encoders.py:71``).  ``dropout`` reaches the
    ``conv_block`` layers only, as in ``tpugraph``.  On a 2-D float32
    CUDA ``x`` each layer's bias, normalisation, ReLU and batch norm run
    as one kernel forward and one backward
    (:func:`~tpugraph_torch.ops.epilogue_kernels.row_epilogue`); a 3-D
    ``x``, whose batch norm spans the batch, and every CPU tensor take the
    separate ops."""

    def __init__(self, input_dim: int, hidden_dim: int, embedding_dim: int,
                 num_layers: int, add_self: bool = False,
                 use_bias: bool = True, att: bool = False, bn: bool = False,
                 dropout: float = 0.0, concat: bool = True,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.bn = bn
        self.concat = concat

        def conv(in_dim, out_dim, block):
            return GraphConv(in_dim, out_dim, add_self=add_self,
                             normalize_embedding=True,
                             dropout=dropout if block else 0.0,
                             use_bias=use_bias, att=att, generator=generator)

        self.conv_first = conv(input_dim, hidden_dim, False)
        self.conv_block = nn.ModuleList(
            [conv(hidden_dim, hidden_dim, True) for _ in range(num_layers - 2)])
        self.conv_last = conv(hidden_dim, embedding_dim, False)

    def forward(self, x: torch.Tensor, adj: Adjacency,
                embedding_mask: Optional[torch.Tensor] = None,
                dropout_gen: Optional[torch.Generator] = None):
        x_all, att_all = [], []
        convs = [self.conv_first, *self.conv_block, self.conv_last]
        for i, conv in enumerate(convs):
            hidden = i < len(convs) - 1
            if x.dim() == 2 and x.dtype == torch.float32 and x.is_cuda:
                x, adj_att = self._fused(conv, x, adj, dropout_gen, hidden)
            else:
                x, adj_att = conv(x, adj, dropout_gen)
                if hidden:
                    x = torch.relu(x)
                    if self.bn:
                        x = fresh_batch_norm(x)
            x_all.append(x)
            att_all.append(adj_att)
        x_tensor = torch.cat(x_all, dim=-1) if self.concat else x
        if embedding_mask is not None:
            x_tensor = x_tensor * embedding_mask[..., None]
        return x_tensor, att_all

    def _fused(self, conv: GraphConv, x: torch.Tensor, adj: Adjacency,
               dropout_gen: Optional[torch.Generator], hidden: bool):
        """``conv`` and what follows it on a 2-D float32 CUDA ``x``, whose
        batch norm takes each node's statistics over its features: the
        layer's product, then its bias, normalisation and, on hidden
        layers, ReLU and batch norm in one kernel each way, the trace
        regions ``nn.epilogue`` and ``nn.epilogue.backward``."""
        y, adj_att = conv.transform(x, adj, dropout_gen)
        with trace_annotation("nn.epilogue"):
            x = trace_backward("nn.epilogue.backward", y, lambda ys: row_epilogue(
                ys, conv.bias, hidden, hidden and self.bn))
        return x, adj_att


class GcnEncoderNode(nn.Module):
    """Node classification encoder (``tpugraph/nn/encoders.py:227``):
    concatenated per-layer embeddings, per-node linear head.
    ``x [N, D]`` + an adjacency (``SparseAdj``, ``BCSRAdj``,
    ``StackedAdj`` or ``PacketAdj``) -> ``(ypred [N, C], att_list)``.

    Parameters are drawn from ``generator`` on the CPU, then the module
    moves to ``device`` (``None`` = CUDA).  In training mode ``dropout``
    draws its masks from the ``dropout_gen`` passed to ``forward``."""

    def __init__(self, input_dim: int, hidden_dim: int, embedding_dim: int,
                 label_dim: int, num_layers: int,
                 pred_hidden_dims: Sequence[int] = (), concat: bool = True,
                 bn: bool = False, dropout: float = 0.0,
                 add_self: bool = False, use_bias: bool = True,
                 att: bool = False,
                 generator: Optional[torch.Generator] = None,
                 device: DeviceLike = None):
        super().__init__()
        device = default_device(device)
        self.input_dim = input_dim
        self.hidden_dim = hidden_dim
        self.embedding_dim = embedding_dim
        self.label_dim = label_dim
        self.num_layers = num_layers
        self.bn = bn
        self.dropout = dropout
        self.add_self = add_self
        self.att = att
        self.stack = ConvStack(input_dim, hidden_dim, embedding_dim,
                               num_layers, add_self=add_self,
                               use_bias=use_bias, att=att, bn=bn,
                               dropout=dropout, concat=concat,
                               generator=generator)
        pred_input_dim = (hidden_dim * (num_layers - 1) + embedding_dim
                          if concat else embedding_dim)
        self.pred_model = PredHead(pred_input_dim, tuple(pred_hidden_dims),
                                   label_dim, generator=generator)
        self.to(device)

    def forward(self, x: torch.Tensor, adj: Adjacency,
                node_mask: Optional[torch.Tensor] = None,
                dropout_gen: Optional[torch.Generator] = None):
        embedding, att_all = self.stack(x, adj, node_mask, dropout_gen)
        return self.pred_model(embedding), att_all


class GatEncoderNode(nn.Module):
    """GAT node classifier at DGL's ogbn-arxiv example's structure
    (``examples/pytorch/ogb/ogbn-arxiv/gat.py``): ``num_layers``
    :class:`GATConv` of ``num_heads`` heads with linear residuals, the
    hidden ones ``head_dim`` wide a head, each followed by ``BatchNorm1d``
    over its ``H F`` features (statistics over the nodes, affine, running
    statistics for evaluation) and ReLU; the last has ``label_dim`` a head,
    averaged over the heads, plus a bias.  ``x [N, D]`` + a
    :class:`SparseAdj` with its CSR and a self-loop on every node ->
    ``(logits [N, C], [])``.  ``dropout`` drops entries of the hidden
    layers' outputs while training, with masks from ``dropout_gen`` (DGL's
    input, attention and edge dropout are not ported).
    Parameters are drawn from ``generator`` on the CPU, then the module
    moves to ``device`` (``None`` = CUDA).  ``self_loops`` tells the
    trainer to give it the self-looped adjacency with its CSR
    (:func:`~tpugraph_torch.train.loop.build_adjacency`)."""

    self_loops = True

    def __init__(self, input_dim: int, head_dim: int, label_dim: int,
                 num_layers: int = 3, num_heads: int = 3,
                 negative_slope: float = 0.2, dropout: float = 0.0,
                 generator: Optional[torch.Generator] = None,
                 device: DeviceLike = None):
        super().__init__()
        device = default_device(device)
        self.input_dim = input_dim
        self.head_dim = head_dim
        self.label_dim = label_dim
        self.num_layers = num_layers
        self.num_heads = num_heads
        self.dropout = dropout
        self.convs = nn.ModuleList()
        self.norms = nn.ModuleList()
        d = input_dim
        for i in range(num_layers):
            out = head_dim if i < num_layers - 1 else label_dim
            self.convs.append(GATConv(d, out, num_heads, negative_slope, generator))
            if i < num_layers - 1:
                self.norms.append(nn.BatchNorm1d(num_heads * out))
            d = num_heads * out
        self.bias = nn.Parameter(torch.zeros(label_dim))
        self.to(device)

    def forward(self, x: torch.Tensor, adj: SparseAdj,
                dropout_gen: Optional[torch.Generator] = None):
        h = x
        for i, conv in enumerate(self.convs):
            h = conv(h, adj)
            if i < self.num_layers - 1:
                h = torch.relu(self.norms[i](h))
                if self.training and self.dropout > 0.001:
                    h = apply_dropout(h, self.dropout, dropout_gen)
        logits = h.view(h.shape[0], self.num_heads, self.label_dim).mean(1) + self.bias
        return logits, []


class DeeperGcnEncoderNode(nn.Module):
    """DeeperGCN node classifier (arXiv:2006.07739) as the authors'
    ogbn-arxiv example builds it with ``--block res+ --gcn_aggr softmax_sg``
    (``deep_gcns_torch/examples/ogb/ogbn_arxiv/model.py``): an input
    ``nn.Linear`` to ``hidden_dim``, ``num_layers`` :class:`GENConv` of
    ``hidden_dim`` channels in pre-activation residual blocks and a linear
    head::

        h^0     = x W_in + b_in
        h^1     = GEN_0(h^0)
        h^{l+1} = GEN_l(ReLU(BN_{l-1}(h^l))) + h^l        l = 1 .. L-1
        logits  = ReLU(BN_{L-1}(h^L)) W_out + b_out

    ``BatchNorm1d`` normalises each channel over the nodes (affine, running
    statistics for evaluation).  ``t`` is the softmax's fixed temperature
    and ``eps`` the messages' offset.  ``dropout`` drops entries after each
    block's ReLU and before the head while training, with masks from
    ``dropout_gen``.  ``x [N, D]`` + a :class:`SparseAdj` with its CSR and a
    self-loop on every node -> ``(logits [N, C], [])``.  Parameters are
    drawn from ``generator`` on the CPU (the linears as ``nn.Linear`` draws
    them), then the module moves to ``device`` (``None`` = CUDA).
    ``self_loops`` tells the trainer to give it the self-looped adjacency
    with its CSR (:func:`~tpugraph_torch.train.loop.build_adjacency`)."""

    self_loops = True

    def __init__(self, input_dim: int, hidden_dim: int, label_dim: int,
                 num_layers: int = 28, t: float = 0.1, eps: float = 1e-7,
                 dropout: float = 0.0, generator: Optional[torch.Generator] = None,
                 device: DeviceLike = None):
        super().__init__()
        device = default_device(device)
        self.input_dim = input_dim
        self.hidden_dim = hidden_dim
        self.label_dim = label_dim
        self.num_layers = num_layers
        self.dropout = dropout
        self.node_features_encoder = _torch_dense(hidden_dim, input_dim, generator)
        self.gcns = nn.ModuleList(GENConv(hidden_dim, hidden_dim, t, eps, generator)
                                  for _ in range(num_layers))
        self.norms = nn.ModuleList(nn.BatchNorm1d(hidden_dim) for _ in range(num_layers))
        self.node_pred_linear = _torch_dense(label_dim, hidden_dim, generator)
        self.to(device)

    def _drop(self, h: torch.Tensor, dropout_gen: Optional[torch.Generator]) -> torch.Tensor:
        if self.training and self.dropout > 0.001:
            return apply_dropout(h, self.dropout, dropout_gen)
        return h

    def forward(self, x: torch.Tensor, adj: SparseAdj,
                dropout_gen: Optional[torch.Generator] = None):
        h = self.gcns[0](self.node_features_encoder(x), adj)
        for i in range(1, self.num_layers):
            h2 = self._drop(torch.relu(self.norms[i - 1](h)), dropout_gen)
            h = self.gcns[i](h2, adj) + h
        h = self._drop(torch.relu(self.norms[self.num_layers - 1](h)), dropout_gen)
        return self.node_pred_linear(h), []


def _masked_max_pool(x: torch.Tensor,
                     node_mask: Optional[torch.Tensor]) -> torch.Tensor:
    """Max over the node axis (-2), padded nodes at -1e9 under a
    ``node_mask`` (``tpugraph/nn/encoders.py:143``)."""
    if node_mask is not None:
        x = torch.where(node_mask[..., None] > 0, x, x.new_full((), -1e9))
    return torch.amax(x, dim=-2)


def _run_stack(stack: ConvStack, x: torch.Tensor, adj: Adjacency,
               dropout_gen: Optional[torch.Generator]):
    """``stack`` on ``x``.  A dense adjacency takes ``x [..., N, D]`` as is;
    a sparse one (COO or tiles) takes ``x [N, D]``, or ``x [Q, N, D]`` when
    it holds Q disjoint graphs of N nodes each (node ``q * N + i``), whose
    embeddings come back as ``[Q, N, F]``."""
    if isinstance(adj, torch.Tensor) or x.dim() == 2:
        return stack(x, adj, None, dropout_gen)
    q, n, d = x.shape
    emb, att = stack(x.reshape(q * n, d), adj, None, dropout_gen)
    return emb.reshape(q, n, -1), att


class GcnEncoderGraph(nn.Module):
    """Graph classification encoder (``tpugraph/nn/encoders.py:152``): the
    conv stack, the max-pool readout of its concatenated layer outputs
    (padded nodes masked out by ``node_mask``; pooling each layer's slice
    and concatenating, as ``tpugraph`` does, is the same channelwise max)
    and a linear head.  ``x [B, N, D]`` with a dense ``adj [B, N, N]`` ->
    ``ypred [B, C]``; ``x [N, D]`` with a sparse adjacency -> ``[C]``, and
    ``x [Q, N, D]`` with a sparse adjacency over Q disjoint graphs ->
    ``[Q, C]``.  Returns ``(ypred, att_list)``.  Parameters are drawn
    from ``generator`` on the CPU, then the module moves to ``device``
    (``None`` = CUDA).  ``tpugraph``'s ``pred_hidden_dims``, ``concat``,
    ``add_self`` and ``mask_pooling``, which no caller sets, keep their
    defaults here."""

    def __init__(self, input_dim: int, hidden_dim: int, embedding_dim: int,
                 label_dim: int, num_layers: int, bn: bool = False,
                 dropout: float = 0.0, use_bias: bool = True,
                 att: bool = False,
                 generator: Optional[torch.Generator] = None,
                 device: DeviceLike = None):
        super().__init__()
        device = default_device(device)
        self.bn = bn
        self.dropout = dropout
        self.att = att
        self.stack = ConvStack(input_dim, hidden_dim, embedding_dim,
                               num_layers, use_bias=use_bias, att=att, bn=bn,
                               dropout=dropout, generator=generator)
        self.pred_model = PredHead(hidden_dim * (num_layers - 1) + embedding_dim,
                                   (), label_dim, generator=generator)
        self.to(device)

    def forward(self, x: torch.Tensor, adj: Adjacency,
                node_mask: Optional[torch.Tensor] = None,
                dropout_gen: Optional[torch.Generator] = None):
        x_tensor, att_all = _run_stack(self.stack, x, adj, dropout_gen)
        return self.pred_model(_masked_max_pool(x_tensor, node_mask)), att_all


class SoftPoolingGcnEncoder(nn.Module):
    """DiffPool graph classification (``tpugraph/nn/encoders.py:283``), the
    fixed dataflow of ``tpugraph`` (``PARITY.md:14``): for each pooling
    stage ``Z = stack(x, A)``, ``S = softmax(assign_pred(assign_stack(x_a,
    A)))`` masked to the real nodes, then ``x <- S^T Z``, ``A <- S^T A S``,
    ``x_a <- x``; the readout max-pools every stage's ``Z`` into an MLP head
    (one hidden layer of 50).  Dense only: ``x [B, N, D]``, ``adj [B, N,
    N]``.  Returns ``(ypred [B, C], assign_tensors)``.  As in ``tpugraph``,
    the stage after the first builds its assign stack for
    ``embedding_dim`` inputs but feeds it the concatenated ``S^T Z``, so
    ``num_pooling > 1`` fails at the first forward in both packages.
    ``tpugraph``'s ``assign_num_layers``, ``pred_hidden_dims``, ``concat``,
    ``att``, ``linkpred`` and ``mask_pooling``, which no caller sets (the
    training loop takes ``linkpred``), keep their defaults here."""

    def __init__(self, max_num_nodes: int, input_dim: int, hidden_dim: int,
                 embedding_dim: int, label_dim: int, num_layers: int,
                 assign_hidden_dim: int, assign_ratio: float = 0.25,
                 num_pooling: int = 1, bn: bool = False, dropout: float = 0.0,
                 use_bias: bool = True, assign_input_dim: int = -1,
                 generator: Optional[torch.Generator] = None,
                 device: DeviceLike = None):
        super().__init__()
        device = default_device(device)
        self.num_pooling = num_pooling
        self.bn = bn
        self.dropout = dropout
        self.assign_hidden_dim = assign_hidden_dim
        assign_in = assign_input_dim if assign_input_dim > 0 else input_dim
        pred_in = hidden_dim * (num_layers - 1) + embedding_dim

        def embed_stack(in_dim):
            return ConvStack(in_dim, hidden_dim, embedding_dim, num_layers,
                             use_bias=use_bias, bn=bn, dropout=dropout,
                             generator=generator)

        self.stack = embed_stack(input_dim)
        self.assign_stack = nn.ModuleList()
        self.assign_pred = nn.ModuleList()
        self.after_pool_stack = nn.ModuleList()
        assign_dim = int(max_num_nodes * assign_ratio)
        for _ in range(num_pooling):
            self.assign_stack.append(ConvStack(
                assign_in, assign_hidden_dim, assign_dim, num_layers,
                use_bias=use_bias, bn=bn, generator=generator))
            self.assign_pred.append(PredHead(
                assign_hidden_dim * (num_layers - 1) + assign_dim, (),
                assign_dim, generator=generator))
            self.after_pool_stack.append(embed_stack(pred_in))
            assign_in = embedding_dim
            assign_dim = int(assign_dim * assign_ratio)
        self.pred_model = PredHead(pred_in * (num_pooling + 1), (50,),
                                   label_dim, generator=generator)
        self.to(device)

    def forward(self, x: torch.Tensor, adj: torch.Tensor,
                node_mask: Optional[torch.Tensor] = None,
                assign_x: Optional[torch.Tensor] = None,
                dropout_gen: Optional[torch.Generator] = None):
        x_a = assign_x if assign_x is not None else x
        embedding, _ = self.stack(x, adj, node_mask, dropout_gen)
        out_all = [_masked_max_pool(embedding, node_mask)]
        assign_tensors = []
        cur_mask = node_mask
        for i in range(self.num_pooling):
            assign_feat, _ = self.assign_stack[i](x_a, adj, cur_mask, dropout_gen)
            s = torch.softmax(self.assign_pred[i](assign_feat), dim=-1)
            if cur_mask is not None:
                s = s * cur_mask[..., None]
            assign_tensors.append(s)
            st = s.transpose(-1, -2)
            x = torch.matmul(st, embedding)
            adj = torch.matmul(torch.matmul(st, adj), s)
            x_a = x
            cur_mask = None  # pooled graphs are dense and unpadded
            embedding, _ = self.after_pool_stack[i](x, adj, None, dropout_gen)
            out_all.append(_masked_max_pool(embedding, None))
        return self.pred_model(torch.cat(out_all, dim=-1)), assign_tensors


def params_from_jax(tree) -> Dict[str, torch.Tensor]:
    """A ``state_dict`` from a ``tpugraph`` flax parameter tree (the output
    of ``model.init`` or a restored ``params.msgpack``), on the CPU.  Leaf
    names carry over, ``GraphConv``'s ``self_weight`` and ``att_weight``
    included."""
    tree = tree.get("params", tree)
    out: Dict[str, torch.Tensor] = {}

    def walk(node, path):
        if isinstance(node, dict) or hasattr(node, "items"):
            for k, v in node.items():
                walk(v, path + [k])
            return
        names = [re.sub(r"^(conv_block|pred_hidden|assign_stack|assign_pred|"
                        r"after_pool_stack)_(\d+)$", r"\1.\2", p)
                 for p in path]
        arr = np.array(node, dtype=np.float32)  # a writable copy
        if names[-1] == "kernel":  # flax Dense [in, out] -> Linear [out, in]
            names[-1] = "weight"
            arr = arr.T
        out[".".join(names)] = torch.from_numpy(np.ascontiguousarray(arr))

    walk(tree, [])
    return out
