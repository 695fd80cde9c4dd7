"""The frozen generators: one seed gives one graph, and every seed the
same sizes (so seeds change the inputs, not the work)."""

import numpy as np
import pytest

from gnnbench.data import chunglu


@pytest.mark.parametrize("seed", [1, 2**31 + 9])
def test_chunglu_exact_counts(seed):
    g = chunglu.generate(seed, num_nodes=2000, num_edges=9000, feat_dim=8, num_classes=5)
    keys = g["lo"] * 2000 + g["hi"]
    assert len(keys) == 9000 and len(np.unique(keys)) == 9000
    assert np.all(g["lo"] < g["hi"]) and g["hi"].max() < 2000
    assert g["feat"].shape == (2000, 8) and g["feat"].dtype == np.float32
    assert g["labels"].min() >= 0 and g["labels"].max() < 5
    deg = np.bincount(np.concatenate([g["lo"], g["hi"]]), minlength=2000)
    assert deg[:20].mean() > 5 * deg[-1000:].mean()  # a power law: hubs at low ids


def test_chunglu_same_seed_same_graph():
    kw = dict(num_nodes=500, num_edges=2000, feat_dim=4, num_classes=3)
    a, b, c = chunglu.generate(5, **kw), chunglu.generate(5, **kw), chunglu.generate(6, **kw)
    assert np.array_equal(a["lo"], b["lo"]) and np.array_equal(a["feat"], b["feat"])
    assert not np.array_equal(a["lo"], c["lo"])
