"""Port of ``tpugraph/utils``: the TensorBoard event writer and the
profiling helpers."""

from tpugraph_torch.utils.profiling import (benchmark, profile_trace,  # noqa: F401
                                            trace_annotation)
from tpugraph_torch.utils.tb_writer import SummaryWriter  # noqa: F401
