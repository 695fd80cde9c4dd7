"""GNNExplainer on the COO edge list and in tile space, and the motif AUC
(port of ``tpugraph/explain``)."""

from tpugraph_torch.explain.explainer import Explainer  # noqa: F401
from tpugraph_torch.explain.groundtruth import (  # noqa: F401
    explanation_auc,
    make_pred_real,
)
from tpugraph_torch.explain.module import (  # noqa: F401
    ExplainConfig,
    MaskState,
    run_mask_optimization,
)
