"""Closed loop of full-batch training jobs through the program's
``train_node_classifier``, back to back.

A job is what a user runs: a new ``Graph`` from the seed's edge arrays,
then ``train_node_classifier`` from the seed's initial weights for the
configuration's epochs (packing, every epoch and the closing evaluation).
A job started before the window's end runs to its end and counts.

Set-up drives the same model object through the first three optimizer
steps with the same call (one step, then two more resumed from its
optimizer state), which also builds every kernel and warms every shape
the jobs use.  The check holds those steps (the first gradient as the
optimizer got it, the change, the logits) and every timed job whole (each
epoch's loss, the closing parameters and logits) against one job of the
plain reference from the same weights on the same inputs.
"""

from __future__ import annotations

import copy
import dataclasses
import time
from typing import Dict

import numpy as np
import torch

from gnnbench import compare, trace
from gnnbench.drivers import common
from gnnbench.reference import gcn as ref

CHECK_STEPS = 3


def _train_config(config: Dict, workload: Dict):
    from tpugraph_torch.train.loop import TrainConfig

    t = config["train"]
    fmt = workload["format"]
    return TrainConfig(
        num_epochs=t["epochs"], lr=t["lr"], clip=t["clip"] or 0.0,
        weight_decay=t["weight_decay"], train_ratio=t["train_ratio"],
        use_bcsr=fmt["use_bcsr"], bcsr_format=fmt.get("bcsr_format", "auto"),
        # the configuration computes in float32: B7's compute dtype with it
        # (the library's default on the card is bfloat16; no CLI flag sets it)
        packet_compute_dtype=torch.float32)


def _host(params: Dict) -> Dict[str, np.ndarray]:
    return {k: v if isinstance(v, np.ndarray) else v.detach().cpu().numpy()
            for k, v in params.items()}


def setup(run) -> Dict:
    from tpugraph_torch.core.graph import graph_from_edges
    from tpugraph_torch.train.loop import train_node_classifier

    cfg, seed, dev = run.config, run.seed, run.device
    t0 = time.perf_counter()
    data = common.make_graph(cfg, seed)
    t1 = time.perf_counter()
    model = common.build_model(cfg, dev)
    init = common.init_params(cfg, seed, dev)
    tcfg = _train_config(cfg, run.workload)
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
    del r1
    r2 = job(CHECK_STEPS - 1, params1, opt1)
    losses += list(r2["history"]["loss"])
    st["first_losses"] = losses
    st["change"] = {k: (v.detach() - init[k]).cpu().numpy()
                    for k, v in r2["params"].items()}
    st["ypred"] = r2["ypred"][0, : data["num_nodes"]]
    st["format"] = type(r2["adj"]).__name__
    del r2
    run.log(f"format: {st['format']} (use_bcsr={tcfg.use_bcsr}, "
            f"bcsr_format={tcfg.bcsr_format})")
    run.log(f"set-up: inputs {t1 - t0:.3f} s, model and first steps "
            f"{time.perf_counter() - t1:.3f} s")
    st["run_job"] = lambda: job(tcfg.num_epochs, init)
    return st


def _timed_job(st) -> Dict:
    t0 = time.perf_counter()
    res = st["run_job"]()
    wall = time.perf_counter() - t0
    out = {"wall_s": wall, "epochs": st["tcfg"].num_epochs, "pack_s": res["pack_s"],
           "losses": res["history"]["loss"],
           "params": {k: v.detach().clone() for k, v in res["params"].items()},
           "ypred": res["ypred"][0, : st["data"]["num_nodes"]]}
    st["jobs"].append(out)
    return out


def window(st, seconds: float, run) -> Dict:
    """Jobs back to back until ``seconds`` have passed (at least one)."""
    jobs = []
    t_start = time.perf_counter()
    while not jobs or time.perf_counter() - t_start < seconds:
        jobs.append(_timed_job(st))
    wall = time.perf_counter() - t_start
    epochs = sum(j["epochs"] for j in jobs)
    run.log(f"jobs: {len(jobs)}, epochs: {epochs}, wall: {wall:.3f} s")
    return {"attempted": len(jobs), "failed": 0,
            "measured": {run.workload["rate_metric"]: epochs / wall}}


def traced(st, run) -> Dict:
    """One whole job under the profiler, in place of the window; the
    per-layer readers' context (``jobs``: that job, whose wall the
    profiler stretches a little)."""
    job, tr = trace.capture(lambda: _timed_job(st))
    data = st["data"]
    return {"attempted": 1, "failed": 0, "trace": tr, "jobs": [job],
            "traced_epochs": job["epochs"], "model": common.model_dims(run.config),
            "num_nodes": data["num_nodes"], "nnz": len(data["senders"])}


def release(st) -> None:
    """Frees the program's state; its outputs stay, on the host."""
    st.pop("run_job", None)
    st.pop("model", None)
    for j in st["jobs"]:
        j["params"] = _host(j["params"])


def program_outputs(st) -> Dict:
    """What the program produced, in :func:`gnnbench.compare.train_readings`'
    shape: the first steps (set-up's, then each timed job's first losses)
    and every timed job whole."""
    init = _host(st["init"])
    return {"first_losses": [st["first_losses"]]
            + [j["losses"][:CHECK_STEPS] for j in st["jobs"]],
            "grad": st["first_grad"], "change": st["change"], "ypred": st["ypred"],
            "jobs": [{"losses": j["losses"], "ypred": j["ypred"],
                      "change": {k: v - init[k] for k, v in _host(j["params"]).items()}}
                     for j in st["jobs"]]}


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
    s = torch.from_numpy(data["senders"].astype(np.int64)).to(dev)
    r = torch.from_numpy(data["receivers"].astype(np.int64)).to(dev)
    product = ref.csr_product(s, r, torch.ones(s.shape[0], device=dev), n)
    rows = None if loss_rows is None else torch.from_numpy(loss_rows(train_idx)).to(dev)
    out = ref.train_job(
        st["init"], torch.from_numpy(data["feat"]).to(dev), product,
        torch.from_numpy(data["labels"]).to(dev), torch.from_numpy(train_idx).to(dev),
        num_layers=m["num_layers"], bn=m["bn"], lr=t["lr"],
        weight_decay=t["weight_decay"], clip=t["clip"], epochs=t["epochs"],
        snapshot=CHECK_STEPS, precision=precision, loss_rows=rows,
        freeze_after=freeze_after)
    init = _host(st["init"])
    return {"first_losses": [out["losses"][:CHECK_STEPS]],
            "grad": _host(out["first_grad"]),
            "change": {k: v - init[k] for k, v in _host(out["snapshot_params"]).items()},
            "ypred": out["snapshot_logits"].cpu().numpy(),
            "jobs": [{"losses": out["losses"], "ypred": out["logits"].cpu().numpy(),
                      "change": {k: v - init[k] for k, v in _host(out["params"]).items()}}]}


def check(st, run) -> Dict[str, float]:
    return compare.train_readings(program_outputs(st), reference_outputs(st, run))
