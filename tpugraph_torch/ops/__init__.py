"""Sparse layouts, the COO message-passing ops and the hand-written
kernels (port of ``tpugraph/ops``)."""

from tpugraph_torch.ops.bcsr import (  # noqa: F401
    BCSR,
    BCSRTranspose,
    bcsr_from_coo,
    bcsr_pad_rows,
    bcsr_pad_tiles,
    bcsr_sym_partner,
    bcsr_to_dense,
    bcsr_transpose_host,
    bcsr_transpose_plan,
    choose_k_pack,
    choose_k_pack_counts,
    coo_tile_counts,
    rcm_reorder,
    transpose_tiles,
    transposed_bcsr,
)
from tpugraph_torch.ops.bcsr_kernels import (  # noqa: F401
    bcsr_matvec,
    bcsr_matvec_dw,
    bcsr_matvec_dw_pair,
    make_bcsr_matvec,
    sddmm_bcsr,
    sddmm_dw,
    spmm_bcsr,
    spmm_bcsr_packed,
)
from tpugraph_torch.ops.coo_kernels import (  # noqa: F401
    CsrMatvec,
    EdgeCSR,
    csr_matvec,
    edge_csr,
    spmm_csr,
)
from tpugraph_torch.ops.dense import dense_sddmm, dense_spmm  # noqa: F401
from tpugraph_torch.ops.diffusion import DiffusionOperator, diffuse  # noqa: F401
from tpugraph_torch.ops.message import (  # noqa: F401
    sddmm,
    segment_softmax,
    spmm,
    sym_normalize_weights,
)
from tpugraph_torch.ops.packets import (  # noqa: F401
    EdgePackets,
    pack_edges,
    pack_edges_transpose,
)
from tpugraph_torch.ops.packets_kernels import packets_matvec, spmm_packets  # noqa: F401
from tpugraph_torch.ops.resident_kernels import (  # noqa: F401
    BCSRPair,
    BCSRStacked,
    pack_pair,
    pack_stacked_int4,
    spmm_pair_resident,
    spmm_power_resident,
    spmm_stacked_resident,
    stack_bcsr,
    stacked_matvec,
)

from tpugraph_torch.ops import (  # noqa: E402
    bcsr_kernels,
    coo_kernels,
    epilogue_kernels,
    gen_kernels,
    packets_kernels,
    probe_kernels,
    resident_kernels,
)

_KERNEL_MODULES = (bcsr_kernels, resident_kernels, packets_kernels, probe_kernels,
                   coo_kernels, epilogue_kernels, gen_kernels)


def launch_counts() -> dict:
    """Kernel launches so far, by kernel name, over all kernel modules."""
    return {k: v for mod in _KERNEL_MODULES for k, v in mod.LAUNCHES.items()}


def reset_launch_counts() -> None:
    for mod in _KERNEL_MODULES:
        mod.LAUNCHES.update(dict.fromkeys(mod.LAUNCHES, 0))
