"""Closed loop of full-batch DeeperGCN training jobs through the program's
``train_node_classifier``, back to back: ``train_node.py``'s loop, window
and check on the program's ``DeeperGcnEncoderNode``.

A job is what a user runs: a new ``Graph`` from the seed's edge arrays,
then ``train_node_classifier`` from the seed's initial weights for the
configuration's epochs (the self-looped adjacency and its CSR, every epoch
and the closing evaluation).  Set-up drives the same model object through
the first three optimizer steps with the same call (one step, then two
more resumed from its optimizer state and its batch-norm statistics),
which also builds every kernel and warms every shape the jobs use.  The
check holds those steps and every timed job whole against one job of the
plain reference (``gnnbench/reference/deepergcn.py``, its card form) from
the same weights on the same inputs.
"""

from __future__ import annotations

import copy
import dataclasses
import math
import time
from typing import Dict, List, Tuple

import numpy as np
import torch

from gnnbench import deepergcn_counts, trace
from gnnbench.compare import train_readings
from gnnbench.drivers import common, train_node
from gnnbench.drivers.train_node import (CHECK_STEPS, program_outputs,  # noqa: F401
                                         release, window)
from gnnbench.reference import deepergcn as ref


def build_model(config: Dict, device):
    """The program's ``DeeperGcnEncoderNode`` at the configuration's widths."""
    from tpugraph_torch.nn import DeeperGcnEncoderNode

    m = config["model"]
    return DeeperGcnEncoderNode(m["input_dim"], m["hidden_dim"], m["label_dim"],
                                num_layers=m["num_layers"], t=m["t"], eps=m["eps"],
                                dropout=m["dropout"], device=device)


def init_shapes(config: Dict) -> List[Tuple[str, Tuple[int, ...], float]]:
    """Every drawn parameter's name (the ``state_dict``'s), shape and
    uniform bound, as ``nn.Linear`` draws them (``1 / sqrt(fan_in)``, its
    weight and its bias): the input linear ``[H, D_in]``, each GENConv's
    ``weight [H, H]`` (in, out) and ``bias``, and the head ``[C, H]``."""
    d = deepergcn_counts.dims(config)
    bi, bh = 1.0 / math.sqrt(d.d_in), 1.0 / math.sqrt(d.hidden)
    out = [("node_features_encoder.weight", (d.hidden, d.d_in), bi),
           ("node_features_encoder.bias", (d.hidden,), bi)]
    for i in range(d.layers):
        out += [(f"gcns.{i}.weight", (d.hidden, d.hidden), bh),
                (f"gcns.{i}.bias", (d.hidden,), bh)]
    out += [("node_pred_linear.weight", (d.classes, d.hidden), bh),
            ("node_pred_linear.bias", (d.classes,), bh)]
    return out


def init_params(config: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The initial ``state_dict`` from ``seed``: one uniform draw on the
    device for the linears, cut and scaled; batch norm at gamma 1, beta 0
    and fresh statistics."""
    shapes = init_shapes(config)
    sizes = [math.prod(s) for _, s, _ in shapes]
    gen = torch.Generator(device=device).manual_seed(int(seed))
    u = torch.rand(sum(sizes), generator=gen, device=device) * 2.0 - 1.0
    out, at = {}, 0
    for (name, shape, bound), k in zip(shapes, sizes):
        out[name] = (u[at:at + k] * bound).reshape(shape).contiguous()
        at += k
    d = deepergcn_counts.dims(config)
    for i in range(d.layers):
        out[f"norms.{i}.weight"] = torch.ones(d.hidden, device=device)
        out[f"norms.{i}.bias"] = torch.zeros(d.hidden, device=device)
        out[f"norms.{i}.running_mean"] = torch.zeros(d.hidden, device=device)
        out[f"norms.{i}.running_var"] = torch.ones(d.hidden, device=device)
        out[f"norms.{i}.num_batches_tracked"] = torch.zeros((), dtype=torch.int64,
                                                            device=device)
    return out


def setup(run) -> Dict:
    from tpugraph_torch.core.graph import graph_from_edges
    from tpugraph_torch.train.loop import train_node_classifier

    cfg, seed, dev = run.config, run.seed, run.device
    t0 = time.perf_counter()
    data = common.make_graph(cfg, seed)
    t1 = time.perf_counter()
    model = build_model(cfg, dev)
    init = init_params(cfg, seed, dev)
    tcfg = train_node._train_config(cfg, run.workload)
    st = {"data": data, "model": model, "init": init, "tcfg": tcfg, "jobs": []}

    def job(num_epochs: int, params, opt_state=None):
        with trace.span("graph_from_edges"):
            g = graph_from_edges(data["senders"], data["receivers"], data["num_nodes"])
        with trace.span("train_node_classifier"):
            return train_node_classifier(
                model, g, data["feat"], data["labels"],
                dataclasses.replace(tcfg, num_epochs=num_epochs), seed=seed,
                init_params=params, init_opt_state=opt_state, device=dev)

    names = [k for k, _ in model.named_parameters()]
    r1 = job(1, init)
    adam = r1["opt_state"]["adam"]["state"]
    # Adam's first moment after one step is 0.1 g (no state: no step taken)
    st["first_grad"] = {k: (adam[i]["exp_avg"] / 0.1).cpu().numpy() if i in adam
                        else np.zeros(tuple(init[k].shape), np.float32)
                        for i, k in enumerate(names)}
    opt1 = copy.deepcopy(r1["opt_state"])
    params1 = {k: v.detach().clone() for k, v in r1["params"].items()}
    losses = list(r1["history"]["loss"])
    st["attended_edges"] = int(r1["adj"].senders.shape[0])
    del r1
    r2 = job(CHECK_STEPS - 1, params1, opt1)
    losses += list(r2["history"]["loss"])
    st["first_losses"] = losses
    st["change"] = {k: (v.detach() - init[k]).cpu().numpy()
                    for k, v in r2["params"].items()}
    st["ypred"] = r2["ypred"][0, : data["num_nodes"]]
    st["format"] = type(r2["adj"]).__name__
    del r2
    run.log(f"format: {st['format']} with its CSR, {st['attended_edges']} attended edges")
    run.log(f"set-up: inputs {t1 - t0:.3f} s, model and first steps "
            f"{time.perf_counter() - t1:.3f} s")
    st["run_job"] = lambda: job(tcfg.num_epochs, init)
    return st


def traced(st, run) -> Dict:
    """One whole job under the profiler, in place of the window; the
    per-layer readers' context (``gnnbench/deepergcn_readers.py``)."""
    job, tr = trace.capture(lambda: train_node._timed_job(st))
    return {"attempted": 1, "failed": 0, "trace": tr, "jobs": [job],
            "traced_epochs": job["epochs"],
            "deepergcn_dims": deepergcn_counts.dims(run.config),
            "num_nodes": st["data"]["num_nodes"], "attended_edges": st["attended_edges"]}


def reference_outputs(st, run, precision: str = "f32", loss_rows=None,
                      freeze_after=None) -> Dict:
    """One job of the reference from the same weights on the same inputs,
    in the shape of :func:`program_outputs` (``precision``, ``loss_rows``
    and ``freeze_after`` put the control or a planted fault in the
    reference: ``gnnbench/calibrate.py``)."""
    cfg, dev, data = run.config, run.device, st["data"]
    t, m = cfg["train"], cfg["model"]
    n = data["num_nodes"]
    train_idx, _ = ref.split_nodes(n, t["train_ratio"], run.seed)
    s, r = ref.with_self_loops(torch.from_numpy(data["senders"].astype(np.int64)).to(dev),
                               torch.from_numpy(data["receivers"].astype(np.int64)).to(dev),
                               n)
    rows = None if loss_rows is None else torch.from_numpy(loss_rows(train_idx)).to(dev)
    out = ref.train_job(
        st["init"], torch.from_numpy(data["feat"]).to(dev), ref.structure(s, r, n),
        torch.from_numpy(data["labels"]).to(dev), torch.from_numpy(train_idx).to(dev),
        num_layers=m["num_layers"], t=m["t"], eps=m["eps"], lr=t["lr"],
        weight_decay=t["weight_decay"], clip=t["clip"], epochs=t["epochs"],
        snapshot=CHECK_STEPS, precision=precision, loss_rows=rows,
        freeze_after=freeze_after)
    init = train_node._host(st["init"])
    return {"first_losses": [out["losses"][:CHECK_STEPS]],
            "grad": train_node._host(out["first_grad"]),
            "change": {k: v - init[k] for k, v in train_node._host(out["snapshot_params"]).items()},
            "ypred": out["snapshot_logits"].cpu().numpy(),
            "jobs": [{"losses": out["losses"], "ypred": out["logits"].cpu().numpy(),
                      "change": {k: v - init[k]
                                 for k, v in train_node._host(out["params"]).items()}}]}


def check(st, run) -> Dict[str, float]:
    return train_readings(program_outputs(st), reference_outputs(st, run))
