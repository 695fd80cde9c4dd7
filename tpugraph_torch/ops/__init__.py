"""BCSR layout and the block-sparse kernels (port of ``tpugraph/ops``)."""

from tpugraph_torch.ops.bcsr import (  # noqa: F401
    BCSR,
    BCSRTranspose,
    bcsr_from_coo,
    bcsr_sym_partner,
    bcsr_transpose_host,
    bcsr_transpose_plan,
    transpose_tiles,
)
from tpugraph_torch.ops.bcsr_kernels import (  # noqa: F401
    LAUNCHES,
    bcsr_matvec,
    bcsr_matvec_dw_pair,
    reset_launch_counts,
    sddmm_bcsr,
    spmm_bcsr,
)
