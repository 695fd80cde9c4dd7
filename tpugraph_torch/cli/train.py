"""Training entry point (port of ``tpugraph/cli/train.py``).

Usage:
  python -m tpugraph_torch.cli.train --dataset=syn1 [--epochs N] [--bcsr]
  python -m tpugraph_torch.cli.train --dataset=syn1 --platform cpu
  python -m tpugraph_torch.cli.train --dataset=syn1 --opt sgd \
      --opt-scheduler step --opt-decay-step 250 [--resume]
  python -m tpugraph_torch.cli.train --bmname=SYNBENCH --datadir D \
      [--method base|att|soft-assign [--linkpred]]

``--opt adam|sgd|rmsprop|adagrad`` and ``--opt-scheduler none|step|cos``
(``--opt-decay-step``, ``--opt-decay-rate``, ``--opt-restart``) pick the
node trainer's optimizer chain; graph classification keeps Adam at 0.001,
as ``tpugraph``'s does.  ``--resume`` continues a node checkpoint for
``--epochs`` more, the schedule from its saved update count.
Prints the metrics every 25 epochs and a JSON summary at the end.  No
TensorBoard events or accuracy-curve PNG are written yet (ROADMAP
section 1 item 10), and the summary has no key for them.
"""

from __future__ import annotations

import json
from typing import Dict

from tpugraph_torch.cli.config import parse_train_args
from tpugraph_torch.cli.tasks import run_task


def main(argv=None) -> Dict:
    """Run the trainer on ``argv`` (``sys.argv`` when ``None``); returns the
    summary it prints."""
    cfg = parse_train_args(argv)

    def log_fn(epoch, scalars):
        msg = "; ".join(f"{k}: {v:.4f}" for k, v in scalars.items())
        print(f"epoch {epoch}: {msg}", flush=True)

    out = run_task(cfg, log_fn=log_fn)
    summary = {
        "dataset": cfg.name,
        "method": cfg.method,
        "ckpt_path": out.get("ckpt_path"),
        "elapsed_s": round(out.get("elapsed", 0.0), 2),
    }
    for key in ("result_train", "result_test", "best_val", "test_result"):
        if out.get(key) is not None:
            summary[key] = {k: v for k, v in out[key].items() if k != "conf_mat"}
    if "result_train" in out:
        print("train conf_mat:\n", out["result_train"]["conf_mat"])
        print("test conf_mat:\n", out["result_test"]["conf_mat"])
    print(json.dumps(summary, indent=2, default=float))
    return summary


if __name__ == "__main__":
    main()
