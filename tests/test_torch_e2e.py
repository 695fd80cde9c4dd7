"""The port's main path end to end on the CPU: syn1 train -> checkpoint
-> tile-space explain -> motif AUC."""

import numpy as np
import torch

from tpugraph_torch.core import graph_from_edge_list
from tpugraph_torch.data import gen_syn1, preprocess_input_graph
from tpugraph_torch.explain import Explainer, explanation_auc
from tpugraph_torch.nn import GcnEncoderNode
from tpugraph_torch.train import (
    TrainConfig,
    gen_prefix,
    load_checkpoint,
    save_checkpoint,
    train_node_classifier,
)

torch.set_num_threads(1)

DIMS = dict(input_dim=10, hidden_dim=20, embedding_dim=20, label_dim=4,
            num_layers=3)


def test_syn1_train_checkpoint_explain_on_cpu(tmp_path):
    """The main path end to end on the CPU: train 800 epochs, write and
    read the checkpoint, explain 5 house nodes; motif AUC > 0.9."""
    G, labels, name = gen_syn1(seed=0)
    g = graph_from_edge_list(G.number_of_nodes(), G.edges())
    feat = np.stack([G.feat[u] for u in G.nodes()])
    model = GcnEncoderNode(**DIMS, generator=torch.Generator().manual_seed(0),
                           device="cpu")
    out = train_node_classifier(model, g, feat, labels,
                                TrainConfig(num_epochs=800), device="cpu")
    assert out["result_test"]["acc"] >= 0.85, out["result_test"]
    data = preprocess_input_graph(G, labels)
    n = data["adj"].shape[1]
    prefix = gen_prefix("syn1")
    save_checkpoint(str(tmp_path), prefix, out["params"],
                    cg_dict={"adj": data["adj"], "feat": data["feat"],
                             "label": data["labels"],
                             "pred": out["ypred"][:, :n],
                             "train_idx": out["train_idx"]},
                    meta={"num_classes": 4})
    ck = load_checkpoint(str(tmp_path), prefix)
    cg = ck["cg"]
    assert sorted(cg) == ["adj", "feat", "label", "pred"]
    np.testing.assert_array_equal(ck["train_idx"], out["train_idx"])
    ex = Explainer(GcnEncoderNode(**DIMS, device="cpu"), ck["params"],
                   cg["adj"], cg["feat"], cg["label"], cg["pred"],
                   logdir=str(tmp_path / "log"), device="cpu")
    results = ex.explain_nodes_bcsr(list(range(400, 700, 60)))
    auc, _, _ = explanation_auc([r["masked_adj"] for r in results],
                                [r["node_idx_new"] for r in results], "syn1")
    assert auc > 0.9, auc
    ma = results[0]["masked_adj"]
    assert ma.shape[0] == ma.shape[1] == len(results[0]["neighbors"])
    np.testing.assert_allclose(ma, ma.T, atol=1e-5)
    ex._save_npy(ma, results[0]["node_idx"])
    assert (tmp_path / "log" / "masked_adj_node_idx_400graph_idx_0.npy").is_file()
