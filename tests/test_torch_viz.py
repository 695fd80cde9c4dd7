"""The port's figure records against ``tpugraph``'s matplotlib figures on
the CPU: networkx's layouts (1e-6), sklearn's precision-recall points and
AP (1e-12, ties included), matplotlib's colormaps (1/255), the palette
and colour class of each node, the artists ``tpugraph`` draws for
``log_graph``, ``plot_pr_curve``, ``plot_accuracy_curve`` and
``save_matrix_image`` (captured by patching ``Figure.savefig``), every
output path, and the PNG/PDF writers."""

import os

import matplotlib

matplotlib.use("agg")
import matplotlib.collections  # noqa: E402
import matplotlib.colors  # noqa: E402
import matplotlib.figure  # noqa: E402
import matplotlib.image  # noqa: E402
import networkx as nx  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402
from sklearn.metrics import average_precision_score, precision_recall_curve  # noqa: E402

from tpugraph.viz import graphs as jax_viz  # noqa: E402
from tpugraph_torch.data import gen_syn1  # noqa: E402
from tpugraph_torch.data.shapes import SimpleGraph  # noqa: E402
from tpugraph_torch.viz import graphs as viz  # noqa: E402
from tpugraph_torch.viz import layout, writers  # noqa: E402

torch.set_num_threads(1)

LAYOUT_TOL = 1e-6
PR_TOL = 1e-12
CMAP_TOL = 1 / 255


def to_nx(G: SimpleGraph) -> nx.Graph:
    """The same graph in networkx, nodes and neighbours in the same order,
    weights and attributes carried."""
    H = nx.Graph()
    for u in G.nodes():
        H.add_node(u)
        H.nodes[u].update(G.attrs.get(u, {}))
        if u in G.feat:
            H.nodes[u]["feat"] = G.feat[u]
    for u in G.nodes():
        for v in G.neighbors(u):
            w = G._adj[u][v]
            H.add_edge(u, v, **({} if w is None else {"weight": w}))
    return H


def random_graph(n, p, seed, weights=False):
    Gx = nx.gnp_random_graph(n, p, seed=seed)
    rng = np.random.default_rng(seed)
    G = SimpleGraph()
    G.add_nodes_from(Gx.nodes())
    for u, v in Gx.edges():
        G.add_edge(u, v, float(rng.random()) if weights else None)
    return G


@pytest.fixture(scope="module")
def syn1_subgraphs():
    """Denoised explanation subgraphs of syn1: seeded symmetric masks on
    the 3-hop neighbourhoods of six nodes, thresholded as the CLI does
    (top 12 and top 20 edges), with labels and the query marked."""
    from tpugraph_torch.core.graph import graph_from_edge_list
    from tpugraph_torch.core.khop import extract_dense_subgraph
    from tpugraph_torch.data import preprocess_input_graph

    G, labels, _ = gen_syn1(seed=0)
    data = preprocess_input_graph(G, labels)
    rng = np.random.default_rng(0)
    out = []
    for node, k in ((300, 12), (305, 20), (401, 12), (455, 20), (560, 12), (10, 20)):
        new_idx, sub_adj, _, sub_label, _ = extract_dense_subgraph(
            data["adj"][0], data["feat"][0], data["labels"][0], node, 3)
        m = np.triu(rng.random(sub_adj.shape) * (sub_adj > 0), 1)
        out.append(viz.denoise_graph(m + m.T, new_idx, label=sub_label,
                                     threshold_num=k))
    return out


def test_kamada_kawai_matches_networkx(syn1_subgraphs):
    graphs = list(syn1_subgraphs) + [random_graph(n, 0.25, s) for s, n in
                                     enumerate((2, 3, 7, 15, 24))]
    graphs.append(random_graph(12, 0.1, 9))  # disconnected: 1e6 distances
    for G in graphs:
        want = nx.kamada_kawai_layout(to_nx(G), weight=None)
        got = layout.kamada_kawai_layout(G)
        assert list(got) == list(want)
        for u in want:
            assert np.abs(got[u] - want[u]).max() <= LAYOUT_TOL


def test_spring_layout_matches_networkx(syn1_subgraphs):
    for G in list(syn1_subgraphs) + [random_graph(n, 0.2, s)
                                     for s, n in enumerate((2, 9, 30, 60))]:
        want = nx.spring_layout(to_nx(G), seed=0)
        got = layout.spring_layout(G, seed=0)
        for u in want:
            assert np.abs(got[u] - want[u]).max() <= LAYOUT_TOL


@pytest.mark.parametrize("name", ["BuPu", "Greys", "Set1", "tab10", "tab20"])
def test_colormaps_match_matplotlib(name):
    cmap = matplotlib.colormaps[name]
    table = viz.colormap_table(name)
    assert len(table) == cmap.N
    np.testing.assert_allclose(table, cmap(np.arange(cmap.N)), atol=CMAP_TOL)
    rng = np.random.default_rng(1)
    v = np.concatenate([rng.uniform(-0.5, 1.5, 300), [0.0, 1.0, 0.5]])
    for vmin, vmax in ((0.0, 1.0), (-0.3, 0.7), (0.2, 0.2)):
        want = cmap(matplotlib.colors.Normalize(vmin=vmin, vmax=vmax)(v), alpha=0.8)
        got = viz.apply_colormap(name, v, vmin, vmax, alpha=0.8)
        np.testing.assert_allclose(got, want, atol=CMAP_TOL)


def test_pr_curve_and_ap_match_sklearn():
    rng = np.random.default_rng(2)
    for n, ties in ((200, False), (300, True), (7, True)):
        real = (rng.random(n) < 0.3).astype(int)
        real[0] = 1
        pred = rng.random(n)
        if ties:
            pred = np.round(pred * 8) / 8
        p, r, t = viz.precision_recall_curve(real, pred)
        wp, wr, wt = precision_recall_curve(real, pred)
        for a, b in ((p, wp), (r, wr), (t, wt)):
            assert a.shape == b.shape
            np.testing.assert_allclose(a, b, rtol=0, atol=PR_TOL)
        assert abs(viz.average_precision(real, pred)
                   - average_precision_score(real, pred)) <= PR_TOL


def test_palette_and_color_class_match():
    G = random_graph(12, 0.3, 4)
    G.attrs = {u: ({"label": u % 3} if u % 4 else {}) for u in G.nodes()}
    G.attrs[2]["self"] = 1
    for dim in (4, 9, 12):
        G.feat = {u: np.eye(dim, dtype=np.float32)[u % dim] for u in G.nodes()}
        G.feat[5] = np.zeros(dim, np.float32)
        H = to_nx(G)
        for nodecolor in ("label", "feat", "none"):
            assert viz._node_palette(G, nodecolor) == jax_viz._node_palette(H, nodecolor)
            for ident in (True, False):
                for u in G.nodes():
                    assert (viz._node_color_class(viz._node_data(G, u), nodecolor, ident)
                            == jax_viz._node_color_class(H.nodes[u], nodecolor, ident))


@pytest.fixture
def captured(monkeypatch):
    """Every figure ``tpugraph`` saves, kept before it is written."""
    figs = []
    real = matplotlib.figure.Figure.savefig

    def keep(self, *a, **kw):
        figs.append(self)
        return real(self, *a, **kw)

    monkeypatch.setattr(matplotlib.figure.Figure, "savefig", keep)
    return figs


def test_log_graph_record_matches_tpugraph_artists(syn1_subgraphs, captured, tmp_path):
    for i, G in enumerate(syn1_subgraphs[:4]):
        edge_vmax = None if i % 2 else 1.5
        path = jax_viz.log_graph(to_nx(G), f"g/{i}", outdir=str(tmp_path),
                                 edge_vmax=edge_vmax)
        assert path.endswith(f"g_{i}_0.pdf")
        fig = captured[-1]
        ax = fig.axes[0]
        (pc,) = [c for c in ax.collections if isinstance(c, matplotlib.collections.PathCollection)]
        (lc,) = [c for c in ax.collections if isinstance(c, matplotlib.collections.LineCollection)]
        rec = viz.graph_record(G, edge_vmax=edge_vmax)
        (rax,) = rec["axes"]
        np.testing.assert_allclose(rax["points"]["xy"], pc.get_offsets(), atol=LAYOUT_TOL)
        np.testing.assert_allclose(rax["points"]["colors"], pc.get_facecolors(),
                                   atol=CMAP_TOL)
        np.testing.assert_allclose(rax["segments"]["xy"], np.asarray(lc.get_segments()),
                                   atol=LAYOUT_TOL)
        np.testing.assert_allclose(rax["segments"]["colors"], lc.get_colors(),
                                   atol=CMAP_TOL)
        assert rax["axis_off"] and not ax.axison
        assert rec["figsize"] == tuple(fig.get_size_inches()) and rec["dpi"] == fig.dpi


def test_pr_curve_record_matches_tpugraph_artists(captured, tmp_path):
    rng = np.random.default_rng(3)
    real = (rng.random(120) < 0.3).astype(int)
    pred = np.round(rng.random(120) * 10) / 10
    jax_viz.plot_pr_curve(real, pred, "pr/x", outdir=str(tmp_path))
    ax = captured[-1].axes[0]
    (line,) = ax.get_lines()
    rec = viz.pr_curve_record(real, pred)
    (rax,) = rec["axes"]
    np.testing.assert_allclose(rax["lines"][0]["x"], line.get_xdata(), atol=PR_TOL)
    np.testing.assert_allclose(rax["lines"][0]["y"], line.get_ydata(), atol=PR_TOL)
    assert rax["title"] == ax.get_title()
    assert (rax["xlabel"], rax["ylabel"]) == (ax.get_xlabel(), ax.get_ylabel())
    assert rax["xlim"] == ax.get_xlim() and rax["ylim"] == ax.get_ylim()
    assert rec["dpi"] == captured[-1].dpi


def test_accuracy_curve_record_matches_tpugraph_artists(captured, tmp_path):
    rng = np.random.default_rng(4)
    train, evals = list(rng.random(100)), list(rng.random(4))
    jax_viz.plot_accuracy_curve(train, evals, name="c", outdir=str(tmp_path))
    ax = captured[-1].axes[0]
    lines = ax.get_lines()
    rec = viz.accuracy_curve_record(train, evals)
    (rax,) = rec["axes"]
    assert len(lines) == len(rax["lines"]) == 2
    for got, want in zip(rax["lines"], lines):
        np.testing.assert_allclose(got["x"], want.get_xdata(), atol=1e-12)
        np.testing.assert_allclose(got["y"], want.get_ydata(), atol=1e-12)
        assert got["label"] == want.get_label()
        np.testing.assert_allclose(got["color"], matplotlib.colors.to_rgba(want.get_color()))
    assert lines[1].get_marker() == rax["lines"][1]["marker"]
    assert lines[1].get_markersize() == rax["lines"][1]["markersize"]
    assert rec["dpi"] == captured[-1].dpi


@pytest.mark.parametrize("shape", [(6, 6), (9,)])
def test_matrix_record_matches_tpugraph_artists(captured, tmp_path, shape):
    mat = np.random.default_rng(5).random(shape).astype(np.float32)
    jax_viz.save_matrix_image(mat, "m/x", outdir=str(tmp_path))
    (im,) = captured[-1].axes[0].get_images()
    rec = viz.matrix_record(mat)
    img = rec["axes"][0]["images"][0]
    np.testing.assert_array_equal(img["data"], im.get_array())
    assert img["cmap"] == im.get_cmap().name
    assert (img["vmin"], img["vmax"]) == pytest.approx(im.get_clim())
    np.testing.assert_allclose(img["rgba"], im.to_rgba(im.get_array()), atol=CMAP_TOL)
    assert tuple(captured[-1].get_size_inches()) == rec["figsize"]


def test_every_output_path_matches(tmp_path):
    """tests/test_viz.py's renders, mirrored: the same paths under the two
    outdirs, and ``""`` for a graph without edges."""
    rng = np.random.default_rng(0)
    G = SimpleGraph()
    Gk = nx.karate_club_graph()
    G.add_nodes_from(Gk.nodes())
    for u, v in Gk.edges():
        G.add_edge(u, v, float(rng.random()))
    G.attrs = {u: {"label": u % 3} for u in G.nodes()}
    H = to_nx(G)
    mat = rng.random((6, 6))
    assign = rng.random((G.number_of_nodes(), 5)).astype(np.float32)
    real = (rng.random(50) < 0.3).astype(int)
    pred = rng.random(50)
    calls = [
        ("log_graph", lambda m, d, g: m.log_graph(g, "test/graph", outdir=d, epoch=3)),
        ("save_matrix_image", lambda m, d, g: m.save_matrix_image(mat, "test/mat", outdir=d)),
        ("log_assignment", lambda m, d, g: m.log_assignment(assign, g, outdir=d)),
        ("plot_cmap", lambda m, d, g: m.plot_cmap(outdir=d)),
        ("plot_pr_curve", lambda m, d, g: m.plot_pr_curve(real, pred, "pr/a", outdir=d)),
        ("plot_accuracy_curve",
         lambda m, d, g: m.plot_accuracy_curve(list(pred), list(pred[:5]), name="tc",
                                               outdir=d)),
    ]
    for name, call in calls:
        a = call(jax_viz, str(tmp_path / "jax"), H)
        b = call(viz, str(tmp_path / "port"), G)
        assert os.path.relpath(a, tmp_path / "jax") == os.path.relpath(b, tmp_path / "port"), name
        assert os.path.isfile(b)
    empty = SimpleGraph()
    empty.add_nodes_from([0, 1])
    assert viz.log_graph(empty, "e", outdir=str(tmp_path)) == "" == jax_viz.log_graph(
        to_nx(empty), "e", outdir=str(tmp_path))


def test_png_decodes_to_the_record(tmp_path):
    """A colormap strip: the decoded PNG has the figure's pixel size, and
    the centre of its first cell is the colormap's first colour."""
    path = viz.plot_cmap("tab20", 20, outdir=str(tmp_path))
    assert writers.check_png(path) == (800, 200)
    img = matplotlib.image.imread(path)
    assert img.shape == (200, 800, 3)
    x = int(800 * (0.125 + 0.775 / 40))
    np.testing.assert_allclose(img[100, x], viz.colormap_table("tab20")[0, :3],
                               atol=1 / 255 + 1e-6)
    path = viz.save_matrix_image(np.arange(4.0).reshape(2, 2), "m", outdir=str(tmp_path))
    assert matplotlib.image.imread(path).shape == (1200, 1600, 3)


def test_pdf_has_a_circle_per_node_and_a_line_per_edge(syn1_subgraphs, tmp_path):
    G = syn1_subgraphs[1]
    path = viz.log_graph(G, "node_305", outdir=str(tmp_path))
    assert writers.check_pdf(path) >= 5
    data = open(path, "rb").read()
    assert data.startswith(b"%PDF-1.4") and b"\nxref\n" in data
    assert data.rstrip().endswith(b"%%EOF")
    assert data.count(b" rg ") == G.number_of_nodes()  # one filled circle each
    assert data.count(b" c ") + data.count(b" c\n") >= 4 * G.number_of_nodes()
    assert data.count(b" S\n") + data.endswith(b" S") == G.number_of_edges()
    assert b"/BaseFont /Helvetica" in data and b"/ExtGState" in data


def test_writer_text_and_images():
    cv = writers.Canvas(40, 20)
    cv.text("Hi", 2, 12, 8)
    assert (cv.rgb < 0.5).any()
    assert writers.glyph("~").any() and not writers.glyph(" ").any()
    assert not writers.glyph("é").any()  # outside printable ASCII: a space
    png = writers.encode_png(np.zeros((3, 4, 3), np.uint8))
    assert png.startswith(b"\x89PNG")
