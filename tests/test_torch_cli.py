"""The port's CLI end to end on the CPU, as subprocesses of
``python -m tpugraph_torch.cli.{train,explain} --platform cpu`` and in
process; its events, figures and summaries against ``tpugraph``'s CLI on
the same checkpoint; the item 9 tasks on their fixtures; ``--halo N`` and
``--dp N`` on gloo ranks against tpugraph's same calls; and ``--mesh``
raising by name."""

import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from tpugraph_torch.cli import explain as cli_explain
from tpugraph_torch.cli import train as cli_train
from tpugraph_torch.cli.config import (Config, cli_device, parse_explain_args,
                                       parse_train_args)
from tpugraph_torch.cli.tasks import train_config
from tpugraph_torch.utils.tb_writer import read_scalars
from tpugraph_torch.viz.writers import check_pdf, check_png

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = {**os.environ, "OMP_NUM_THREADS": "1",
       "PYTHONPATH": REPO + os.pathsep + os.environ.get("PYTHONPATH", "")}
# run a module as ``python -m`` does, then report the JAX-side modules it loaded
NO_JAX = ("import runpy, sys; sys.argv = sys.argv[1:]; "
          "runpy.run_module(sys.argv[0], run_name='__main__', alter_sys=True); "
          "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
          "('jax', 'jaxlib', 'flax', 'tpugraph')); "
          "print('LOADED', bad, file=sys.stderr); sys.exit(3 if bad else 0)")


def run_cli(module, args, cwd, check_no_jax=False):
    head = ([sys.executable, "-c", NO_JAX, module] if check_no_jax
            else [sys.executable, "-m", module])
    return subprocess.run(head + ["--platform", "cpu"] + args,
                          capture_output=True, text=True, timeout=240,
                          cwd=cwd, env=ENV)


def summary_of(out):
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout[out.stdout.index("{"):])


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    return str(tmp_path_factory.mktemp("cliwork"))


def test_train_then_explain_cli(workdir):
    """Train 400 epochs on COO, explain node 305 on COO and in tile space
    (10 mask epochs), then the stats run over nodes 400:700:5 with 20; the
    JAX package is never loaded."""
    s = summary_of(run_cli("tpugraph_torch.cli.train",
                           ["--dataset", "syn1", "--epochs", "400"], workdir,
                           check_no_jax=True))
    assert s["result_test"]["acc"] > 0.7, s
    assert set(s) == {"dataset", "method", "ckpt_path", "elapsed_s",
                      "result_train", "result_test", "train_curve"}
    assert s["train_curve"] == os.path.join("log", "results", "syn1_base_h20_o20.png")
    check_png(os.path.join(workdir, s["train_curve"]))
    (events,) = os.listdir(os.path.join(workdir, "log", "syn1_base_h20_o20"))
    scalars = read_scalars(os.path.join(workdir, "log", "syn1_base_h20_o20", events))
    assert sorted(scalars) == ["acc/test_acc", "acc/train_acc", "loss/avg_loss"]
    assert [step for step, _ in scalars["loss/avg_loss"]] == list(range(25, 401, 25))
    ck = os.path.join(workdir, "ckpt", "syn1_base_h20_o20")
    assert sorted(os.listdir(ck)) == ["cg.npz", "meta.json", "opt_state.pt",
                                      "params.pt", "train_idx.npy"]
    with open(os.path.join(ck, "meta.json")) as f:
        meta = json.load(f)
    assert meta["task"] == "node" and meta["num_classes"] == 4
    assert meta["result_test"]["acc"] == pytest.approx(s["result_test"]["acc"])

    logdir = os.path.join(workdir, "log", "syn1_base_h20_o20_explain")
    npy = os.path.join(logdir, "masked_adj_node_idx_305graph_idx_0.npy")
    shapes = []
    for extra in ([], ["--bcsr"]):
        if os.path.exists(npy):
            os.remove(npy)
        s = summary_of(run_cli("tpugraph_torch.cli.explain",
                               ["--dataset", "syn1", "--explain-node", "305",
                                "--epochs", "10"] + extra, workdir,
                               check_no_jax=True))
        assert s["explain_node"] == 305
        assert s["viz"] == os.path.join(logdir, "node_305_0.pdf").replace(
            workdir + os.sep, "")
        check_pdf(os.path.join(workdir, s["viz"]))
        assert s["mask_shape"][0] == s["mask_shape"][1] > 1
        assert os.path.isfile(npy)
        shapes.append(s["mask_shape"])
    assert shapes[0] == shapes[1]  # the same 3-hop neighborhood on both paths

    s = summary_of(run_cli("tpugraph_torch.cli.explain",
                           ["--dataset", "syn1", "--epochs", "20"], workdir))
    assert s["num_nodes_explained"] == 60 and 0.0 < s["auc"] <= 1.0
    with open(os.path.join(logdir, "pr", "auc_syn1_exp.txt")) as f:
        assert f.read() == f"dataset: syn1, model: exp, auc: {s['auc']}\n"
    # the 60 stats nodes' masks beside node 305's
    assert len([f for f in os.listdir(logdir) if f.endswith(".npy")]) == 61
    check_png(os.path.join(logdir, "pr", "pr_syn1_exp.png"))
    for name in ("mask_adj_0.png", "mask_feat_mask_0.png"):
        check_png(os.path.join(logdir, name))
    assert len([f for f in os.listdir(logdir) if f.startswith("graph_syn1_exp_")]) == 4
    (events,) = [f for f in os.listdir(logdir) if f.startswith("events.out")]
    tags = read_scalars(os.path.join(logdir, events))
    assert sorted(tags) == sorted(f"optimization/{t}_loss" for t in
                                  ("pred", "size", "lap", "ent", "feat_size",
                                   "feat_ent", "total", "density"))
    assert all(len(v) == 20 for v in tags.values())


def test_cli_without_platform_needs_cuda(monkeypatch, tmp_path):
    """Without --platform and without a card, both entry points raise the
    port's "pass device='cpu'" error before they train or load."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for main in (cli_train.main, cli_explain.main):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            main(["--dataset", "syn1", "--epochs", "1",
                  "--ckptdir", str(tmp_path)])
    assert not os.listdir(tmp_path)


@pytest.mark.parametrize("main,flags", [
    (cli_train.main, ["--bmname", "TOY"]),
    (cli_explain.main, ["--bmname", "TOY", "--graph-mode"]),
], ids=["train --bmname", "explain --graph-mode"])
def test_graph_cli_without_platform_needs_cuda(monkeypatch, tmp_path, main, flags):
    """The graph task and graph-mode explainer also default to the card and
    raise without one, before they read or write anything."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(flags + ["--datadir", str(tmp_path / "none"),
                      "--ckptdir", str(tmp_path)])
    assert not os.listdir(tmp_path)


def test_platform_flag():
    assert cli_device(Config(platform="cpu")) == torch.device("cpu")
    with pytest.raises(ValueError, match="--platform 'tpu'"):
        cli_device(Config(platform="tpu"))


def test_bcsr_flags_reach_train_config():
    tc = train_config(parse_train_args(
        ["--dataset", "syn1", "--bcsr", "--bcsr-format", "packets",
         "--bcsr-block", "256", "--epochs", "7"]))
    assert (tc.use_bcsr, tc.bcsr_format, tc.bcsr_block, tc.num_epochs) == (
        True, "packets", 256, 7)
    assert not train_config(parse_train_args([])).use_bcsr


def test_missing_checkpoint_message(tmp_path):
    with pytest.raises(FileNotFoundError, match="train a model"):
        cli_explain.main(["--dataset", "syn1", "--platform", "cpu",
                          "--ckptdir", str(tmp_path)])


MULTI_DEVICE_TRAIN = {
    "halo4": ["--dataset", "syn1", "--halo", "4"],
    "halo2_bcsr_att": ["--dataset", "syn1", "--halo", "2", "--halo-overlap", "on",
                       "--bcsr", "--bcsr-block", "64", "--method", "att"],
    "dp2": ["--bmname", "TOY", "--dp", "2", "--batch-size", "8"],
}


@pytest.fixture(scope="module")
def toy_dir(tmp_path_factory):
    from test_tasks import write_tu_dataset

    root = str(tmp_path_factory.mktemp("toy"))
    write_tu_dataset(root, "TOY")
    return root


def _ckpt_files(root):
    """A checkpoint directory's files, tpugraph's flax files by the port's
    names (``params.msgpack`` -> ``params.pt``)."""
    return sorted(f.replace(".msgpack", ".pt") for f in os.listdir(root))


@pytest.mark.parametrize("name", list(MULTI_DEVICE_TRAIN))
def test_multi_device_train_flag_runs(tmp_path, toy_dir, capsys, name):
    """``--halo N`` and ``--dp N`` with ``--platform cpu`` train on N gloo
    ranks (5 epochs) and give tpugraph's same call's summary keys,
    checkpoint files and event tags (tpugraph on its virtual CPU
    devices)."""
    from tpugraph.cli import train as jax_cli_train

    argv = MULTI_DEVICE_TRAIN[name] + ["--epochs", "5", "--datadir", toy_dir,
                                       "--platform", "cpu"]
    dirs = lambda tag: ["--ckptdir", str(tmp_path / tag / "ck"),
                        "--logdir", str(tmp_path / tag / "log")]
    port = cli_train.main(argv + dirs("port"))
    want = _jax_summary(jax_cli_train.main, argv + dirs("jax"), capsys)
    assert set(port) == set(want)
    assert port["ckpt_path"] == str(tmp_path / "port" / "ck" / os.path.basename(
        want["ckpt_path"]))
    assert _ckpt_files(port["ckpt_path"]) == _ckpt_files(want["ckpt_path"])
    check_png(port["train_curve"])
    sub = os.path.basename(want["ckpt_path"])
    tags = [sorted(read_scalars(os.path.join(tmp_path, t, "log", sub, f)))
            for t in ("port", "jax")
            for f in os.listdir(os.path.join(tmp_path, t, "log", sub))]
    assert tags[0] == tags[1]


def test_resume_with_halo_raises_before_training(tmp_path):
    """``--resume --halo 2`` raises before it reads anything (tpugraph raises
    only once a checkpoint has loaded)."""
    with pytest.raises(NotImplementedError, match="--resume is not supported with --halo"):
        cli_train.main(["--platform", "cpu", "--ckptdir", str(tmp_path / "none"),
                        "--logdir", str(tmp_path / "log"), "--resume", "--halo", "2"])
    assert not os.listdir(tmp_path)


PORTED_TRAIN = [
    ["--opt", "sgd"],
    ["--opt", "rmsprop", "--opt-scheduler", "cos", "--opt-restart", "3"],
    ["--opt", "adagrad", "--opt-scheduler", "step", "--opt-decay-step", "2"],
    ["--method", "att"],
    ["--bn"],
    ["--dropout", "0.1"],
    ["--dataset", "syn2"],
    ["--dataset", "syn5"],
    ["--dataset", "syn3", "--bcsr"],
    ["--dataset", "syn4", "--method", "att", "--bn", "--bcsr"],
]


@pytest.mark.parametrize("args", PORTED_TRAIN, ids=" ".join)
def test_ported_train_flag_runs(tmp_path, args):
    """Flags whose modules this port has: 5 training epochs on the CPU, then
    the stats explain of the checkpoint (2 mask epochs), and with
    ``--bcsr`` one node in tile space; the explainer rebuilds the model
    from the checkpoint's meta, so ``--bn`` is not repeated."""
    dirs = ["--platform", "cpu", "--ckptdir", str(tmp_path / "ckpt"),
            "--logdir", str(tmp_path / "log")]
    s = cli_train.main(dirs + args + ["--epochs", "5"])
    dataset = args[args.index("--dataset") + 1] if "--dataset" in args else "syn1"
    method = "att" if "att" in args else "base"
    assert s["dataset"] == dataset and s["method"] == method
    with open(os.path.join(s["ckpt_path"], "meta.json")) as f:
        meta = json.load(f)
    assert meta["bn"] == ("--bn" in args) and meta["model_type"] == method
    params = torch.load(os.path.join(s["ckpt_path"], "params.pt"))
    assert any(k.endswith("att_weight") for k in params) == (method == "att")
    keep = ["--dataset", dataset, "--method", method]
    e = cli_explain.main(dirs + keep + ["--epochs", "2"])
    assert e["num_nodes_explained"] == 60 and 0.0 <= e["auc"] <= 1.0
    if "--bcsr" in args:
        e = cli_explain.main(dirs + keep + ["--epochs", "2", "--bcsr",
                                            "--explain-node", "305"])
        assert e["mask_shape"][0] == e["mask_shape"][1] > 1


@pytest.fixture(scope="module")
def toy_graph_dirs(tmp_path_factory):
    """The TU-format TOY dataset of ``tests/test_tasks.py`` and the flags
    that point the CLI at it, with a checkpoint trained for 5 epochs."""
    from test_tasks import write_tu_dataset

    root = str(tmp_path_factory.mktemp("toy"))
    write_tu_dataset(root, "TOY")
    dirs = ["--platform", "cpu", "--datadir", root, "--bmname", "TOY",
            "--max-nodes", "0", "--ckptdir", os.path.join(root, "ckpt"),
            "--logdir", os.path.join(root, "log")]
    cli_train.main(dirs + ["--epochs", "5", "--batch-size", "8"])
    return dirs


# The graph flags this port runs (they raised before graph classification
# was ported): train on TOY, or explain the TOY checkpoint in graph mode,
# which ignores --explainer-model as tpugraph's CLI does.
PORTED_GRAPH = [
    ["--bmname"],
    ["--graph-mode"],
    ["--graph-idx", "1"],
    ["--graph-idx", "1", "--explainer-model", "grad"],
    ["--multigraph-class", "0"],
]


@pytest.mark.parametrize("args", PORTED_GRAPH, ids=" ".join)
def test_ported_graph_flag_runs(toy_graph_dirs, args):
    if args == ["--bmname"]:  # the fixture's flags already name TOY
        s = cli_train.main(toy_graph_dirs + ["--epochs", "3", "--batch-size", "8",
                                             "--name-suffix", "again"])
        assert s["dataset"] == "TOY" and 0.0 <= s["test_result"]["acc"] <= 1.0
        with open(os.path.join(s["ckpt_path"], "meta.json")) as f:
            assert json.load(f)["task"] == "graph"
        return
    s = cli_explain.main(toy_graph_dirs + args + ["--epochs", "2"])
    assert s["mode"] == "graph"
    if "--graph-idx" in args:
        assert s["graph_idx"] == 1 and s["mask_shape"] == [9, 9]
    else:
        assert len(s["graph_indices"]) > 1


def test_explain_flags_reach_explain_config():
    cfg = parse_explain_args(["--epochs", "7", "--lr", "0.5", "--mask-bias",
                              "--marginalize", "--seed-ensemble", "3",
                              "--mask-act", "ReLU"])
    assert (cfg.explainer_epochs, cfg.explainer_lr, cfg.mask_bias,
            cfg.marginalize, cfg.seed_ensemble, cfg.mask_act) == (
        7, 0.5, True, True, 3, "ReLU")


def test_opt_flags_reach_train_config():
    tc = train_config(parse_train_args(
        ["--opt", "rmsprop", "--opt-scheduler", "cos", "--opt-restart", "7",
         "--opt-decay-step", "3", "--opt-decay-rate", "0.25"]))
    assert (tc.opt, tc.opt_scheduler, tc.opt_restart, tc.opt_decay_step,
            tc.opt_decay_rate) == ("rmsprop", "cos", 7, 3, 0.25)


def test_resume_continues_the_schedule(tmp_path):
    """--resume: 6 epochs, then 4 resumed from params.pt and opt_state.pt,
    equal 10 straight, with the step decay at the resume point."""
    flags = ["--platform", "cpu", "--dataset", "syn1", "--opt", "sgd",
             "--lr", "0.01", "--opt-scheduler", "step", "--opt-decay-step",
             "6", "--opt-decay-rate", "0.5"]
    a, b = (["--ckptdir", str(tmp_path / d)] for d in "ab")
    flags += ["--logdir", str(tmp_path / "log")]
    cli_train.main(flags + a + ["--epochs", "6"])
    s = cli_train.main(flags + a + ["--epochs", "4", "--resume"])
    t = cli_train.main(flags + b + ["--epochs", "10"])
    load = lambda d, f: torch.load(os.path.join(d, f), weights_only=True)
    pa, pb = load(s["ckpt_path"], "params.pt"), load(t["ckpt_path"], "params.pt")
    assert set(pa) == set(pb)
    for k in pa:
        torch.testing.assert_close(pa[k], pb[k], rtol=1e-6, atol=1e-7)
    assert load(s["ckpt_path"], "opt_state.pt")["count"] == 10
    assert s["result_test"] == pytest.approx(t["result_test"])
    with pytest.raises(FileNotFoundError, match="train a model"):
        cli_train.main(flags + ["--ckptdir", str(tmp_path / "c"), "--resume"])


@pytest.fixture(scope="module")
def syn1_ckpts(tmp_path_factory):
    """syn1 trained 60 epochs on the CPU, base and --method att, and the
    flags that point the explainer at them."""
    root = str(tmp_path_factory.mktemp("syn1ck"))
    dirs = ["--platform", "cpu", "--ckptdir", os.path.join(root, "ckpt"),
            "--logdir", os.path.join(root, "log")]
    for method in ("base", "att"):
        cli_train.main(dirs + ["--method", method, "--epochs", "60"])
    return root, dirs


PORTED_EXPLAIN = [
    ["--explainer-model", "grad"],
    ["--explainer-model", "att", "--method", "att"],
    ["--explainer-model", "grad", "--explain-node", "305"],
    ["--explainer-model", "att", "--method", "att", "--explain-node", "305"],
    ["--multinode-class", "0", "--epochs", "5", "--align-steps", "50"],
]


@pytest.mark.parametrize("args", PORTED_EXPLAIN, ids=" ".join)
def test_ported_explain_flag_runs(syn1_ckpts, args):
    """The baselines' stats run (AUC over nodes 400:700:5, the AUC file) and
    one node (its .npy), and --multinode-class (5 nodes of the class, the
    first two aligned, aligned_adj.npy)."""
    root, dirs = syn1_ckpts
    method = "att" if "--method" in args else "base"
    logdir = os.path.join(root, "log", f"syn1_{method}_h20_o20_explain")
    s = cli_explain.main(dirs + args)
    assert s["mode"] == "node"
    if "--multinode-class" in args:
        assert s["num_nodes_explained"] == 5 and s["aligned"] is True
        assert os.path.isfile(os.path.join(logdir, "aligned_adj.npy"))
        return
    model = args[1]
    if "--explain-node" in args:
        assert s["explain_node"] == 305 and s["mask_shape"][0] > 1
        m = np.load(os.path.join(logdir, "masked_adj_node_idx_305graph_idx_0.npy"))
        assert list(m.shape) == s["mask_shape"] and np.all(np.isfinite(m))
        return
    assert s["num_nodes_explained"] == 60 and 0.0 <= s["auc"] <= 1.0
    with open(os.path.join(logdir, "pr", f"auc_syn1_{model}.txt")) as f:
        assert f.read() == f"dataset: syn1, model: {model}, auc: {s['auc']}\n"


MESH_EXPLAIN = {"node": ["--explain-node", "305"],
                "node_bcsr": ["--explain-node", "305", "--bcsr"],
                "stats": []}


@pytest.mark.parametrize("name", list(MESH_EXPLAIN))
def test_mesh_explain_matches_one_device(syn1_ckpts, name):
    """``--mesh 2`` on gloo ranks (10 mask epochs): the summary gains
    ``mesh_devices``, rank 0 writes the files of the ``--mesh 1`` run and
    no other (one events file), and every ``.npy`` is the single-device
    one within 1e-6 (tests/test_cli.py:112)."""
    root, dirs = syn1_ckpts
    files, summaries = {}, {}
    for n in (1, 2):
        s = cli_explain.main(dirs + MESH_EXPLAIN[name] + [
            "--epochs", "10", "--mesh", str(n), "--explainer-suffix", f"{name}{n}"])
        logdir = os.path.join(root, "log", f"syn1_base_h20_o20_explain_{name}{n}")
        files[n] = {f: os.path.join(logdir, f) for f in sorted(os.listdir(logdir))}
        summaries[n] = s
    assert summaries[2].pop("mesh_devices") == 2 and "mesh_devices" not in summaries[1]
    assert [f for f in files[2] if not f.startswith("events.out")] == [
        f for f in files[1] if not f.startswith("events.out")]
    assert len(files[2]) == len(files[1])
    npys = [f for f in files[1] if f.endswith(".npy")]
    assert len(npys) == (60 if name == "stats" else 1)
    for f in npys:
        a, b = np.load(files[1][f]), np.load(files[2][f])
        assert a.ndim == 2 and a.shape[0] == a.shape[1] > 1
        np.testing.assert_allclose(b, a, rtol=0, atol=1e-6, err_msg=f)
    if name == "stats":
        assert summaries[2]["auc"] == pytest.approx(summaries[1]["auc"], abs=1e-12)
    else:
        assert summaries[2]["mask_shape"] == summaries[1]["mask_shape"]


# The item 9 tasks through cli.train on the fixtures of
# tests/test_torch_tasks.py (they raised before these tasks were ported).
ITEM9 = [
    ["--pkl", "toy.pkl", "--batch-size", "6", "--eval-every", "2"],
    ["--dataset", "enron"],
    ["--dataset", "enron_multigraph"],
    ["--dataset", "ppi_essential"],
]


@pytest.mark.parametrize("args", ITEM9, ids=" ".join)
def test_item9_flag_runs(tmp_path, args):
    """6 epochs on the CPU: the summary, the checkpoint (not for --pkl, as
    in tpugraph), the TensorBoard scalars and the accuracy curve."""
    from test_torch_tasks import write_enron, write_graph_pickle, write_ppi

    write_graph_pickle(tmp_path / "toy.pkl")
    write_enron(str(tmp_path))
    write_ppi(str(tmp_path))
    s = cli_train.main(["--platform", "cpu", "--datadir", str(tmp_path),
                        "--ckptdir", str(tmp_path / "ckpt"), "--logdir",
                        str(tmp_path / "log"), "--epochs", "6"] + args)
    name = args[1] if args[0] == "--dataset" else "syn1"
    prefix = f"{name}_base_h20_o20"
    assert s["dataset"] == name and "train_curve" in s
    check_png(s["train_curve"])
    if args[0] == "--pkl":
        assert s["ckpt_path"] is None and "test_result" in s
    else:
        assert os.path.isfile(os.path.join(s["ckpt_path"], "cg.npz"))
        assert 0.0 <= s["result_test"]["acc"] <= 1.0
    (events,) = os.listdir(tmp_path / "log" / prefix)
    tags = read_scalars(str(tmp_path / "log" / prefix / events))
    assert "loss/avg_loss" in tags and all(t.startswith(("acc/", "loss/")) for t in tags)


@pytest.mark.parametrize("extra", [["--explain-node", "305"], []],
                         ids=["explain-node", "stats"])
def test_log_mask_every_runs(syn1_ckpts, extra):
    """--log-mask-every: heatmaps at epochs 0, 2 and 4 of 5 for one node
    (every 2), at epoch 0 of 3 for each of the 60 stats nodes (every 3),
    counted in the summary's mask_heatmaps."""
    root, dirs = syn1_ckpts
    logdir = os.path.join(root, "log", "syn1_base_h20_o20_explain")
    if extra:
        s = cli_explain.main(dirs + extra + ["--epochs", "5", "--log-mask-every", "2"])
        assert s["mask_heatmaps"] == 3
        for ep in (0, 2, 4):
            check_png(os.path.join(logdir, f"mask_masked_adj_{ep}.png"))
        check_pdf(s["viz"])
    else:
        s = cli_explain.main(dirs + ["--epochs", "3", "--log-mask-every", "3"])
        assert s["mask_heatmaps"] == 60
        check_png(os.path.join(logdir, "mask_masked_adj_node455_0.png"))
        # masked_w is 2-D and not a scalar: the events hold the 1-D terms
        (events,) = [f for f in os.listdir(logdir) if f.startswith("events.out")]
        assert not any("masked_w" in t for t in read_scalars(os.path.join(logdir, events)))


def _jax_summary(main, argv, capsys):
    main(argv)
    text = capsys.readouterr().out
    return json.loads(text[text.rindex("\n{\n") + 1:])


def test_events_and_figures_match_tpugraph(tmp_path, monkeypatch, capsys):
    """tpugraph's CLI and the port's on the same syn1 flags, the port from
    tpugraph's initial weights: the same summary keys, files and scalar
    tags, the training scalars within 1e-5; then both explainers' stats
    run, one node and --multinode-class on tpugraph's checkpoint, the port
    from tpugraph's mask init: the same files and summary keys, the
    optimization scalars within 1e-4."""
    import jax
    import jax.numpy as jnp

    from test_torch_tasks import jax_node_init
    from tpugraph.cli import explain as jax_cli_explain
    from tpugraph.cli import train as jax_cli_train
    from tpugraph.explain.module import ExplainConfig as JaxExplainConfig
    from tpugraph.explain.module import init_masks
    from tpugraph_torch.cli import tasks
    from tpugraph_torch.core.khop import khop_subgraph
    from tpugraph_torch.explain.explainer import Explainer

    ck = ["--ckptdir", str(tmp_path / "ckpt"), "--platform", "cpu", "--dataset", "syn1"]
    train = ["--epochs", "50"]
    jax_train = _jax_summary(jax_cli_train.main,
                             ck + ["--logdir", str(tmp_path / "jax")] + train, capsys)
    monkeypatch.setattr(tasks, "train_node_classifier",
                        jax_node_init(tasks.train_node_classifier))
    port_train = cli_train.main(ck[:1] + [str(tmp_path / "ckpt_port")] + ck[2:]
                                + ["--logdir", str(tmp_path / "port")] + train)
    assert set(port_train) == set(jax_train)

    def files(root):  # the event file's name carries the wall-clock second
        return sorted(re.sub(r"tfevents\.\d+\.", "tfevents.T.",
                             os.path.relpath(os.path.join(d, f), root))
                      for d, _, fs in os.walk(root) for f in fs)

    def events(root, sub):
        (f,) = [f for f in os.listdir(os.path.join(root, sub)) if f.startswith("events")]
        return read_scalars(os.path.join(root, sub, f))

    assert files(tmp_path / "port") == files(tmp_path / "jax")
    ej, et = events(tmp_path / "jax", "syn1_base_h20_o20"), events(
        tmp_path / "port", "syn1_base_h20_o20")
    assert sorted(ej) == sorted(et)
    for tag in ej:
        assert [a for a, _ in et[tag]] == [a for a, _ in ej[tag]]
        np.testing.assert_allclose([b for _, b in et[tag]], [b for _, b in ej[tag]],
                                   atol=1e-5, err_msg=tag)

    real = Explainer.explain_nodes_batch

    def jax_init(self, node_indices, graph_idx=0, mesh=None, init_state=None):
        if init_state is None:
            g = self._graph(graph_idx)
            keys = jax.random.split(jax.random.PRNGKey(self.seed), len(node_indices))
            cfg_j = JaxExplainConfig(mask_bias=self.cfg.mask_bias)
            states = [init_masks(k, g.num_edges_padded, self.feat.shape[-1],
                                 jnp.int32(khop_subgraph(g, int(i), self.n_hops).num_nodes),
                                 cfg_j) for k, i in zip(keys, node_indices)]
            init_state = (np.stack([np.asarray(st.edge_logits) for st in states]),
                          np.stack([np.asarray(st.feat_logits) for st in states]), None)
        return real(self, node_indices, graph_idx, mesh, init_state)

    monkeypatch.setattr(Explainer, "explain_nodes_batch", jax_init)
    explain = ck + ["--epochs", "6"]
    jax_ex = _jax_summary(jax_cli_explain.main,
                          explain + ["--logdir", str(tmp_path / "jax_ex")], capsys)
    port_ex = cli_explain.main(explain + ["--logdir", str(tmp_path / "port_ex")])
    assert set(port_ex) == set(jax_ex)
    assert port_ex["auc"] == pytest.approx(jax_ex["auc"], abs=1e-3)
    assert files(tmp_path / "port_ex") == files(tmp_path / "jax_ex")
    sub = "syn1_base_h20_o20_explain"
    ej, et = events(tmp_path / "jax_ex", sub), events(tmp_path / "port_ex", sub)
    assert sorted(ej) == sorted(et)
    for tag in ej:
        np.testing.assert_allclose([b for _, b in et[tag]], [b for _, b in ej[tag]],
                                   atol=1e-4, err_msg=tag)
    for extra in (["--explain-node", "305"], ["--multinode-class", "0", "--align-steps", "20"]):
        want = _jax_summary(jax_cli_explain.main, explain + [
            "--logdir", str(tmp_path / "jax_ex")] + extra, capsys)
        got = cli_explain.main(explain + ["--logdir", str(tmp_path / "port_ex")] + extra)
        assert set(got) == set(want)
        assert files(tmp_path / "port_ex") == files(tmp_path / "jax_ex")
    assert any(f.startswith(f"{sub}/align_ref_node_") for f in files(tmp_path / "port_ex"))
