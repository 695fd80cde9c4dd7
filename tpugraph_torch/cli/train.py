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
  python -m tpugraph_torch.cli.train --dataset=syn1 --halo 4 [--halo-overlap on] \
      [--bcsr] [--method att] [--platform cpu]
  python -m tpugraph_torch.cli.train --bmname=SYNBENCH --datadir D --dp 2 [--platform cpu]

``--halo N`` (node tasks) and ``--dp N`` (``--bmname``) run the trainer
in ``N`` spawned ranks: NCCL with one CUDA card a rank (fewer cards than
ranks raises before anything runs), or gloo CPU processes with
``--platform cpu``.  Rank 0 prints, writes the events, the curve and the
checkpoint, and its summary is returned.
  python -m tpugraph_torch.cli.train --pkl=graphs.pkl --datadir D
  python -m tpugraph_torch.cli.train --dataset=ppi_essential|enron|enron_multigraph --datadir D

Prints the metrics every 25 epochs and a JSON summary at the end.  As
``tpugraph``'s does, it writes the metrics as TensorBoard scalars
(``loss/avg_loss``, ``acc/<name>``) to
``<logdir>/<prefix>/events.out.tfevents.*`` and the training accuracy
curve to ``<logdir>/results/<prefix>.png`` (the summary's
``train_curve``).
"""

from __future__ import annotations

import json
import os
import sys
from typing import Dict

import torch.distributed as dist

from tpugraph_torch.cli.config import (check_ported, cli_device, parse_train_args,
                                       rank_backend, rank_count)
from tpugraph_torch.cli.tasks import is_writer, run_task
from tpugraph_torch.train.checkpoint import gen_prefix
from tpugraph_torch.utils.tb_writer import SummaryWriter
from tpugraph_torch.viz.graphs import plot_accuracy_curve


def main(argv=None) -> Dict:
    """Run the trainer on ``argv`` (``sys.argv`` when ``None``); returns the
    summary it prints (rank 0's, on several ranks; the other ranks return
    an empty dict)."""
    argv = list(sys.argv[1:] if argv is None else argv)
    cfg = parse_train_args(argv)
    check_ported(cfg)
    cli_device(cfg)  # an unusable --platform raises before anything is written
    n = rank_count(cfg)
    if n > 1 and not dist.is_initialized():
        from tpugraph_torch.parallel.launch import run_ranks

        return run_ranks(main, n, rank_backend(cfg), argv)
    if not is_writer():
        run_task(cfg)
        return {}
    prefix = gen_prefix(cfg.name, cfg.method, cfg.hidden_dim, cfg.output_dim,
                        cfg.bias, cfg.name_suffix)
    writer = SummaryWriter(os.path.join(cfg.logdir, prefix))

    def log_fn(epoch, scalars):
        msg = "; ".join(f"{k}: {v:.4f}" for k, v in scalars.items())
        print(f"epoch {epoch}: {msg}", flush=True)
        for k, v in scalars.items():
            writer.add_scalar("loss/avg_loss" if k == "loss" else f"acc/{k}", v,
                              step=epoch)

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
    hist = out.get("history") or {}
    if hist.get("train_acc"):
        summary["train_curve"] = plot_accuracy_curve(
            hist["train_acc"], hist.get("test_acc") or hist.get("val_acc"),
            name=prefix, outdir=os.path.join(cfg.logdir, "results"))
    writer.close()
    print(json.dumps(summary, indent=2, default=float))
    return summary


if __name__ == "__main__":
    main()
