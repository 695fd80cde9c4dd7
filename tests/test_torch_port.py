"""Contract of the port as a package: its entry points default to CUDA
and raise without it, and no module of it imports jax or tpugraph."""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from tpugraph_torch import default_device
from tpugraph_torch.core import graph_from_edge_list
from tpugraph_torch.explain import Explainer
from tpugraph_torch.nn import GcnEncoderNode
from tpugraph_torch.train import TrainConfig, train_node_classifier

DIMS = dict(input_dim=4, hidden_dim=8, embedding_dim=8, label_dim=2,
            num_layers=3)


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_raise_without_cuda(no_cuda):
    with pytest.raises(RuntimeError, match="device='cpu'"):
        default_device()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        GcnEncoderNode(**DIMS)
    model = GcnEncoderNode(**DIMS, device="cpu")
    g = graph_from_edge_list(6, [(0, 1), (1, 2), (2, 3), (3, 4), (4, 5)])
    feat = np.ones((g.num_nodes_padded, 4), np.float32)
    labels = np.array([0, 1, 0, 1, 0, 1])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_node_classifier(model, g, feat, labels,
                              TrainConfig(num_epochs=1))
    out = train_node_classifier(model, g, feat, labels,
                                TrainConfig(num_epochs=2), device="cpu")
    assert np.all(np.isfinite(out["ypred"])) and len(out["history"]["loss"]) == 2
    adj = np.zeros((1, 6, 6), np.float32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Explainer(model, None, adj, feat[None, :6], labels[None],
                  out["ypred"][:, :6])
    assert default_device("cpu") == torch.device("cpu")


def test_unported_options_raise():
    with pytest.raises(NotImplementedError):
        GcnEncoderNode(**DIMS, att=True, device="cpu")
    with pytest.raises(NotImplementedError):
        GcnEncoderNode(**DIMS, bn=True, device="cpu")
    g = graph_from_edge_list(3, [(0, 1), (1, 2)])
    model = GcnEncoderNode(**DIMS, device="cpu")
    for cfg in (TrainConfig(opt="rmsprop"), TrainConfig(opt="sgd"),
                TrainConfig(opt_scheduler="step")):
        with pytest.raises(NotImplementedError):
            train_node_classifier(model, g, np.ones((8, 4), np.float32),
                                  np.zeros(3, int), cfg, device="cpu")


def test_package_imports_neither_jax_nor_tpugraph():
    """Import every module of the package in a fresh interpreter and check
    that neither jax nor tpugraph got loaded, nor a package the card
    machine lacks (networkx, sklearn, matplotlib, tensorboardX, msgpack)."""
    code = (
        "import pkgutil, sys, importlib, tpugraph_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(tpugraph_torch.__path__, "
        "'tpugraph_torch.')]\n"
        "[importlib.import_module(m) for m in mods]\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in ('jax', 'jaxlib', 'tpugraph', 'flax',\n"
        "    'networkx', 'sklearn', 'matplotlib', 'tensorboardX', 'msgpack'))\n"
        "assert len(mods) >= 20, mods\n"
        "assert not bad, bad\n"
        "print(len(mods))\n"
    )
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         cwd=Path(__file__).resolve().parents[1])
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.strip()) >= 20


def test_diffusion_entry_points_raise_without_cuda(no_cuda):
    """DiffusionOperator and diffuse default to CUDA like every entry
    point; device="cpu" runs them on the plain kernel versions."""
    import torch

    from tpugraph_torch.ops import DiffusionOperator, diffuse

    g = graph_from_edge_list(6, [(0, 1), (1, 2), (2, 3), (3, 4), (4, 5)])
    x = torch.ones((6, 4))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DiffusionOperator(g, block=8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        diffuse(g, x, 1, block=8)
    y = diffuse(g, x, 2, block=8, device="cpu")
    assert y.shape == (6, 4) and bool(torch.isfinite(y.float()).all())
