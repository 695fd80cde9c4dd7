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
    """Attention on a static-weight format (no score gradient) raises, and
    so do an optimizer or a schedule that tpugraph does not have either;
    attention and bn themselves build."""
    from tpugraph_torch.nn import PacketAdj

    model = GcnEncoderNode(**DIMS, att=True, bn=True, device="cpu")
    with pytest.raises(NotImplementedError, match="GAT"):
        model(torch.zeros((8, 4)), PacketAdj(None, None))
    g = graph_from_edge_list(3, [(0, 1), (1, 2)])
    model = GcnEncoderNode(**DIMS, device="cpu")
    for cfg, what in ((TrainConfig(opt="lamb"), "optimizer"),
                      (TrainConfig(opt_scheduler="poly"), "scheduler")):
        with pytest.raises(ValueError, match=what):
            train_node_classifier(model, g, np.ones((8, 4), np.float32),
                                  np.zeros(3, int), cfg, device="cpu")


def test_package_imports_neither_jax_nor_tpugraph():
    """Import every module of the package, ``tpugraph_torch.parallel`` and
    ``tpugraph_torch.native`` among them, in a fresh interpreter and check
    that neither jax nor tpugraph got loaded, nor a package the card
    machine lacks (optax, networkx, sklearn, matplotlib, tensorboardX,
    msgpack), nor scipy, which only the Kamada-Kawai layout imports, when
    it runs."""
    code = (
        "import pkgutil, sys, importlib, tpugraph_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(tpugraph_torch.__path__, "
        "'tpugraph_torch.')]\n"
        "[importlib.import_module(m) for m in mods]\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in ('jax', 'jaxlib', 'tpugraph', 'flax',\n"
        "    'optax', 'networkx', 'sklearn', 'matplotlib', 'tensorboardX', 'msgpack',\n"
        "    'scipy'))\n"
        "assert len(mods) >= 20, mods\n"
        "assert {'tpugraph_torch.parallel.' + m for m in ('mesh', 'launch', "
        "'collectives', 'spmd', 'tp')} <= set(mods), mods\n"
        "assert 'tpugraph_torch.native' in mods, mods\n"
        "assert not bad, bad\n"
        "from tpugraph_torch.viz.layout import kamada_kawai_layout\n"
        "from tpugraph_torch.data.shapes import SimpleGraph\n"
        "g = SimpleGraph(); g.add_edge(0, 1)\n"
        "kamada_kawai_layout(g)\n"
        "assert 'scipy' in sys.modules\n"
        "print(len(mods))\n"
    )
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         cwd=Path(__file__).resolve().parents[1])
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.strip()) >= 20


# tpugraph's Pallas modules and their CUDA counterparts
KERNEL_MODULES = {"ops/pallas_spmm.py": "ops/bcsr_kernels.py",
                  "ops/pallas_resident.py": "ops/resident_kernels.py",
                  "ops/pallas_packets.py": "ops/packets_kernels.py"}


def test_every_tpugraph_module_has_a_counterpart():
    """Each module file of tpugraph has one of the same path in the port
    (the Pallas ones their kernel modules), and so do its two helpers
    graph_from_networkx and make_bcsr_matvec."""
    from tpugraph_torch.core import graph_from_networkx  # noqa: F401
    from tpugraph_torch.ops import make_bcsr_matvec  # noqa: F401

    root = Path(__file__).resolve().parents[1]
    jax_mods = {str(p.relative_to(root / "tpugraph"))
                for p in (root / "tpugraph").rglob("*.py")}
    assert len(jax_mods) > 30
    missing = [m for m in sorted(jax_mods)
               if not (root / "tpugraph_torch" / KERNEL_MODULES.get(m, m)).is_file()]
    assert not missing, missing


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


# ---------------------------------------------------------- the format rule

RULE_ARGS = dict(n_live=2_097_152, t_probe=21_001, density=0.0015,
                 low_locality=True, on_card=True)


def _rule_pick(cfg, rates, n_live, t_probe):
    """The total-time rule of tpugraph/train/loop.py:137-176 at ``rates``."""
    pairs = 3 * cfg.num_epochs
    tiles = (rates["res_pack_s_per_tile"] * (cfg.bcsr_block / 256) ** 2 * t_probe
             + pairs * n_live / rates["res_edges_per_s"])
    pkt = (rates["pkt_pack_s_per_edge"] * n_live
           + pairs * n_live / rates["pkt_edges_per_s"])
    return "packets" if pkt < tiles else "tiles"


@pytest.mark.parametrize("rates", [
    "",  # the card's own rates
    "res_edges_per_s=1e11,res_pack_s_per_tile=1e-9",  # resident cheap
    "pkt_pack_s_per_edge=1e-3",                       # packets' pack dear
    "pkt_edges_per_s=1e6, res_edges_per_s=2e6",       # spaces, two keys
])
@pytest.mark.parametrize("epochs,block", [(100, 256), (100_000, 128)])
def test_format_rule_picks_by_total_time(monkeypatch, capsys, rates, epochs,
                                         block):
    """At given rates (TPUGRAPH_RATES) and a given density the rule picks
    what the total-time formula gives, and prints its decision."""
    from tpugraph_torch.train.loop import _format_rates, resolve_bcsr_format

    monkeypatch.setenv("TPUGRAPH_RATES", rates)
    r = _format_rates()
    for part in filter(None, rates.split(",")):
        k, v = part.split("=")
        assert r[k.strip()] == float(v)
    cfg = TrainConfig(num_epochs=epochs, bcsr_block=block, use_bcsr=True)
    got = resolve_bcsr_format(cfg, **RULE_ARGS)
    assert got == _rule_pick(cfg, r, RULE_ARGS["n_live"], RULE_ARGS["t_probe"])
    assert f"bcsr_format auto -> {got}" in capsys.readouterr().out
    # above 3e-3, off the card or not low-locality: tiles, without a word
    for other in (dict(density=0.004), dict(on_card=False),
                  dict(low_locality=False)):
        assert resolve_bcsr_format(cfg, **dict(RULE_ARGS, **other)) == "tiles"
    assert capsys.readouterr().out == ""


def test_format_rule_precedence_and_bad_rates(monkeypatch):
    from tpugraph_torch.train.loop import resolve_bcsr_format

    cheap_res = "res_edges_per_s=1e12,res_pack_s_per_tile=1e-12"
    monkeypatch.setenv("TPUGRAPH_RATES", cheap_res)
    cfg = TrainConfig(bcsr_block=256)
    assert resolve_bcsr_format(cfg, **RULE_ARGS) == "tiles"
    # an explicit format wins over the rule; attention and resident "on"
    # win over an explicit format
    pinned = TrainConfig(bcsr_block=256, bcsr_format="packets")
    assert resolve_bcsr_format(pinned, **RULE_ARGS) == "packets"
    assert resolve_bcsr_format(pinned, **RULE_ARGS, att=True) == "tiles"
    assert resolve_bcsr_format(
        TrainConfig(bcsr_format="packets", bcsr_resident="on"),
        **RULE_ARGS) == "tiles"
    monkeypatch.setenv("TPUGRAPH_RATES", "res_edge_per_s=1e9")
    with pytest.raises(ValueError, match="unknown key 'res_edge_per_s'"):
        resolve_bcsr_format(cfg, **RULE_ARGS)
    monkeypatch.delenv("TPUGRAPH_RATES")
    g = graph_from_edge_list(6, [(0, 1), (1, 2), (2, 3), (3, 4), (4, 5)])
    from tpugraph_torch.train.loop import build_adjacency

    with pytest.raises(ValueError, match="unknown bcsr_format 'dense'"):
        build_adjacency(g, TrainConfig(use_bcsr=True, bcsr_format="dense"),
                        torch.device("cpu"))


# what "auto" (both settings) picks at seed 0 on the card and on the CPU,
# at the CLI's block of 128: tile occupancies 0.0090, 0.0041, 0.0067,
# 0.0031 and 0.0021, all low-locality; only syn5's is under 3e-3
AUTO_ON_CARD = {"syn1": "resident", "syn2": "resident", "syn3": "resident",
                "syn4": "resident", "syn5": "packets"}


@pytest.mark.parametrize("dataset", sorted(AUTO_ON_CARD))
def test_auto_format_of_each_dataset(dataset):
    """On the card ``auto`` turns the resident format on for syn1–syn4 and
    picks packets for syn5; attention forces tiles with a transpose plan;
    on the CPU ``auto`` stays tiles, and the CPU's packing is tiles."""
    from tpugraph_torch.data import GENERATORS
    from tpugraph_torch.nn import BCSRAdj
    from tpugraph_torch.train.loop import build_adjacency, choose_format

    G, _, _ = GENERATORS[dataset](seed=0)
    g = graph_from_edge_list(G.number_of_nodes(), G.edges())
    arrays = (g.senders.numpy(), g.receivers.numpy(), g.edge_weight.numpy(),
              g.num_nodes_padded)
    cfg = TrainConfig(use_bcsr=True)
    assert choose_format(*arrays, cfg, on_card=True) == AUTO_ON_CARD[dataset]
    assert choose_format(*arrays, cfg, on_card=True, att=True) == "tiles_att"
    assert choose_format(*arrays, cfg, on_card=False) == "tiles"
    pinned = TrainConfig(use_bcsr=True, bcsr_format="tiles",
                         bcsr_resident="off")
    assert choose_format(*arrays, pinned, on_card=True) == "tiles"
    # a block the tensor cores cannot take keeps tiles on the card
    assert choose_format(*arrays, TrainConfig(use_bcsr=True, bcsr_block=64),
                         on_card=True) in ("tiles", "packets")
    adj, _ = build_adjacency(g, cfg, torch.device("cpu"))
    assert isinstance(adj, BCSRAdj) and adj.m_t is not None
