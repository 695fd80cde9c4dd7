"""Test accuracy and explanation AUC of the node suite on the CPU, through
both packages' CLIs at seed 0: the reference figures that
``chip_smoke.py``'s ``syn`` phase holds the card's runs to.

    python3 syn_cpu_figures.py [--jax] [--rows syn2,syn3] [--spread] [--write]

The rows are ``chip_smoke.py``'s ``SYN_ROWS`` and syn1 (its ``coo``
phase).  Each trains 1000 epochs (``cli.train``) and then explains nodes
400:700:5 with 100 mask epochs each (``cli.explain``), at the published
widths (10 -> 20 -> 20, 3 layers).  The port (``tpugraph_torch``) runs in
this process with ``--platform cpu``; with ``--jax`` the JAX package
(``tpugraph``) runs each row too, as ``python -m tpugraph.cli.*
--platform cpu`` subprocesses.  Prints one JSON object of
``{row: {"port": {"acc", "auc"}, "jax": {...}}}``; ``--write`` also
writes the port's figures of these rows, rounded to 4 digits, into
``syn_cpu_figures.json``, which the smoke reads.  The port runs on one
CPU thread, so the figures repeat: the thread count sets the order of the
CPU's float sums in the backward pass, and 1000 epochs of training
amplify a difference in the last bit into other weights (syn5's AUC reads
0.4809 on 1 thread and 0.5021 on 2).  ``--spread`` also trains each row
on 1, 2, 4 and 8 threads and records its test acc on each
(``acc_threads``), the spread the smoke prints beside the card's figure.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import subprocess
import sys
import tempfile

import torch

from chip_smoke import SYN_CPU_FILE, SYN_ROWS

# the flags of cli.train (and cli.explain) of each row
ROWS = {"syn1": [], **{key: flags for key, flags, _, _ in SYN_ROWS}}
THREADS = 1  # the port's CPU threads: the figures depend on them
SPREAD_THREADS = (1, 2, 4, 8)


def port_row(flags, work, spread=False):
    from tpugraph_torch.cli import explain as cli_explain
    from tpugraph_torch.cli import train as cli_train

    dirs = ["--platform", "cpu", "--ckptdir", os.path.join(work, "ckpt"),
            "--logdir", os.path.join(work, "log")]
    with contextlib.redirect_stdout(io.StringIO()):
        s = cli_train.main(dirs + flags)
        e = cli_explain.main(dirs + flags)
    out = {"acc": s["result_test"]["acc"], "auc": e["auc"]}
    if spread:
        accs = {}
        for t in SPREAD_THREADS:
            torch.set_num_threads(t)
            with contextlib.redirect_stdout(io.StringIO()):
                accs[str(t)] = cli_train.main(dirs + flags + [
                    "--ckptdir", os.path.join(work, f"ckpt{t}")])["result_test"]["acc"]
        torch.set_num_threads(THREADS)
        out["acc_threads"] = accs
    return out


def _json_tail(text):
    """The JSON object a CLI prints last."""
    start = text.rindex("\n{") + 1 if "\n{" in text else text.index("{")
    return json.loads(text[start:])


def jax_row(flags, work):
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    dirs = ["--platform", "cpu", "--ckptdir", os.path.join(work, "ckpt"),
            "--logdir", os.path.join(work, "log")]
    out = {}
    for mod, key in (("tpugraph.cli.train", "acc"), ("tpugraph.cli.explain", "auc")):
        res = subprocess.run([sys.executable, "-m", mod] + dirs + flags,
                             capture_output=True, text=True, env=env,
                             timeout=3600, check=True)
        summary = _json_tail(res.stdout)
        out[key] = (summary["result_test"]["acc"] if key == "acc"
                    else summary["auc"])
    return out


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--jax", action="store_true",
                   help="also run each row through the JAX package")
    p.add_argument("--rows", default=",".join(ROWS))
    p.add_argument("--spread", action="store_true",
                   help="also record each row's test acc on 1, 2, 4 and 8 threads")
    p.add_argument("--write", action="store_true",
                   help=f"write the port's figures to {SYN_CPU_FILE}")
    args = p.parse_args()
    torch.set_num_threads(THREADS)
    report = {}
    for row in args.rows.split(","):
        with tempfile.TemporaryDirectory() as work:
            report[row] = {"port": port_row(ROWS[row], os.path.join(work, "port"),
                                            args.spread)}
            if args.jax:
                report[row]["jax"] = jax_row(ROWS[row],
                                             os.path.join(work, "jax"))
        print(row, json.dumps(report[row]), file=sys.stderr, flush=True)
    print(json.dumps(report))
    if args.write:
        path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            SYN_CPU_FILE)
        figures = {}
        if os.path.exists(path):
            with open(path) as f:
                figures = json.load(f)
        figures.update({row: {k: ({t: round(a, 4) for t, a in v.items()}
                                  if isinstance(v, dict) else round(v, 4))
                              for k, v in fig["port"].items()}
                        for row, fig in report.items()})
        with open(path, "w") as f:
            json.dump(figures, f, indent=1)
            f.write("\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
