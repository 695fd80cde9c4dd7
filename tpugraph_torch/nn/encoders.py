"""Port of ``tpugraph/nn/encoders.py``: ``ConvStack``, ``PredHead`` and
``GcnEncoderNode``, plus :func:`params_from_jax`.

Module and parameter names follow the flax tree, so a ``tpugraph``
parameter tree maps onto the ``state_dict`` by name:
``stack/conv_block_0/weight`` is ``stack.conv_block.0.weight``.  Flax
``Dense`` kernels are ``[in, out]`` and torch ``Linear`` weights
``[out, in]``; ``GraphConv.weight`` stays ``[in, out]``.
"""

from __future__ import annotations

import re
from typing import Dict, Optional, Sequence

import numpy as np
import torch
from torch import nn

from tpugraph_torch._device import DeviceLike, default_device
from tpugraph_torch.nn.initializers import torch_linear_bias, torch_linear_kernel
from tpugraph_torch.nn.layers import Adjacency, GraphConv, fresh_batch_norm


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
    ``conv_block`` layers only, as in ``tpugraph``."""

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
        for conv in [self.conv_first, *self.conv_block]:
            x, adj_att = conv(x, adj, dropout_gen)
            x = torch.relu(x)
            if self.bn:
                x = fresh_batch_norm(x)
            x_all.append(x)
            att_all.append(adj_att)
        x, adj_att = self.conv_last(x, adj, dropout_gen)
        x_all.append(x)
        att_all.append(adj_att)
        x_tensor = torch.cat(x_all, dim=-1) if self.concat else x
        if embedding_mask is not None:
            x_tensor = x_tensor * embedding_mask[..., None]
        return x_tensor, att_all


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
        names = [re.sub(r"^(conv_block|pred_hidden)_(\d+)$", r"\1.\2", p)
                 for p in path]
        arr = np.array(node, dtype=np.float32)  # a writable copy
        if names[-1] == "kernel":  # flax Dense [in, out] -> Linear [out, in]
            names[-1] = "weight"
            arr = arr.T
        out[".".join(names)] = torch.from_numpy(np.ascontiguousarray(arr))

    walk(tree, [])
    return out
