"""What the drivers share: the configuration's graph and model, and the
initial weights drawn from the seed on the device."""

from __future__ import annotations

import importlib
import math
from typing import Dict, List, Tuple

import numpy as np
import torch


def make_graph(config: Dict, seed: int) -> Dict[str, np.ndarray]:
    """The configuration's graph, from the generator its ``graph.generator``
    names (``gnnbench/data/<generator>.py``), and its directed edges in
    both directions (``senders``, ``receivers``, int32)."""
    spec = dict(config["graph"])
    gen = importlib.import_module(f"gnnbench.data.{spec.pop('generator')}")
    data = gen.generate(seed, **spec)
    data["senders"] = np.concatenate([data["lo"], data["hi"]]).astype(np.int32)
    data["receivers"] = np.concatenate([data["hi"], data["lo"]]).astype(np.int32)
    return data


def model_dims(config: Dict) -> Dict:
    """Layer widths of the configuration's ``GcnEncoderNode``."""
    m = config["model"]
    layers = m["num_layers"]
    ins = [m["input_dim"]] + [m["hidden_dim"]] * (layers - 1)
    outs = [m["hidden_dim"]] * (layers - 1) + [m["embedding_dim"]]
    return {"layer_inputs": ins, "layer_outputs": outs,
            "head_input": sum(outs), "classes": m["label_dim"]}


def build_model(config: Dict, device):
    """The program's ``GcnEncoderNode`` at the configuration's widths."""
    from tpugraph_torch.nn import GcnEncoderNode

    m = config["model"]
    return GcnEncoderNode(m["input_dim"], m["hidden_dim"], m["embedding_dim"],
                          m["label_dim"], m["num_layers"], bn=m["bn"],
                          dropout=m["dropout"], device=device)


def init_shapes(config: Dict) -> List[Tuple[str, Tuple[int, ...], float]]:
    """Every parameter's name (the ``state_dict``'s), shape and uniform
    bound: the convolutions' weights ``[in, out]`` Xavier-uniform with the
    ReLU gain, their biases 0, and the head ``nn.Linear``'s default."""
    d = model_dims(config)
    layers = config["model"]["num_layers"]
    names = (["stack.conv_first"]
             + [f"stack.conv_block.{i}" for i in range(layers - 2)]
             + ["stack.conv_last"])
    out = []
    for name, a, b in zip(names, d["layer_inputs"], d["layer_outputs"]):
        out.append((f"{name}.weight", (a, b), math.sqrt(2.0) * math.sqrt(6.0 / (a + b))))
        out.append((f"{name}.bias", (b,), 0.0))
    f, c = d["head_input"], d["classes"]
    out.append(("pred_model.pred.weight", (c, f), 1.0 / math.sqrt(f)))
    out.append(("pred_model.pred.bias", (c,), 1.0 / math.sqrt(f)))
    return out


def init_params(config: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The initial ``state_dict`` from ``seed``: one uniform draw on the
    device for every parameter, cut and scaled."""
    shapes = init_shapes(config)
    sizes = [math.prod(s) for _, s, _ in shapes]
    gen = torch.Generator(device=device).manual_seed(int(seed))
    u = torch.rand(sum(sizes), generator=gen, device=device) * 2.0 - 1.0
    out, at = {}, 0
    for (name, shape, bound), k in zip(shapes, sizes):
        out[name] = (u[at:at + k] * bound).reshape(shape).contiguous()
        at += k
    return out
