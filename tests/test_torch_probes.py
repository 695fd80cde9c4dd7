"""D3's launch probes (``bench_palcall_diag.py``): the plain versions
against a numpy reference, and the wrappers, which run on the card only,
refuse CPU tensors and bad shapes."""

import numpy as np
import pytest
import torch

from tpugraph_torch.ops import probe_kernels as pk

torch.set_num_threads(1)


def _bf16(a):
    """numpy float32 values rounded to bf16 (nearest even), as float32."""
    b = a.astype(np.float32).view(np.uint32).astype(np.uint64)
    b = (b + 0x7FFF + ((b >> 16) & 1)) & 0xFFFF0000
    return b.astype(np.uint32).view(np.float32)


def test_probe_tiny_plain_matches_numpy():
    x = np.random.default_rng(0).standard_normal((8, pk.D)).astype(np.float32)
    got = pk.probe_tiny_plain(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, x * np.float32(0.999))


@pytest.mark.parametrize("n", [8, 40])
def test_probe_resident_plain_matches_numpy(n):
    rng = np.random.default_rng(n)
    tok = rng.standard_normal((8, pk.D)).astype(np.float32)
    x = rng.standard_normal((n, pk.D)).astype(np.float32)
    got = pk.probe_resident_plain(torch.from_numpy(tok),
                                  torch.from_numpy(x).to(torch.bfloat16)).numpy()
    ref = np.zeros((n, pk.D), np.float32)
    ref[:8] = tok + _bf16(x[:8])
    np.testing.assert_array_equal(got, ref)


def test_probe_wrappers_raise_off_the_card():
    x8 = torch.ones(8, pk.D)
    for grid in pk.GRIDS:
        with pytest.raises(ValueError, match="CUDA device only"):
            pk.probe_tiny(x8, grid)
    with pytest.raises(ValueError, match="CUDA device only"):
        pk.probe_resident(x8, torch.ones(16, pk.D, dtype=torch.bfloat16))
    meta = torch.device("meta")
    with pytest.raises(ValueError, match="CUDA device only"):
        pk.probe_tiny(torch.ones(8, pk.D, device=meta), 3)
