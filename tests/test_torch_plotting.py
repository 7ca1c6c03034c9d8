"""The port's plotting (``analysis.plotting``) against the JAX package's,
on the CPU: ``plot_cka_map``'s sub-maps and pickles, the PNGs it draws,
the diagonals, and the files of ``plot_all_diagonals`` and
``plot_distribution``.  Each package reads the other's pickles (numpy
arrays)."""
import os
import pickle

import numpy as np
import torch

from diffvit_tpu.analysis import plotting as jplot

from diffvit_tpu_torch.analysis import plotting

from test_torch_calibrate import one_torch_thread  # noqa: F401

DEPTH = 2  # a 4 * 2 + 2 = 10-tap heatmap


def _heatmap(base, name):
    cka = np.random.default_rng(0).uniform(0, 1, (4 * DEPTH + 2,) * 2)
    os.makedirs(os.path.join(base, name))
    with open(os.path.join(base, name, name + "_heatmap.pkl"), "wb") as f:
        pickle.dump(cka, f)
    return cka


def _pickled(path):
    with open(path, "rb") as f:
        return pickle.load(f)


def test_cka_map_and_diagonals_match_jax(tmp_path):
    base = str(tmp_path)
    cka = _heatmap(base, "run")
    want = jplot.plot_cka_map("run", "jax_plots", base, depth=DEPTH)
    got = plotting.plot_cka_map("run", "port_plots", base, depth=DEPTH)
    assert set(got) == set(want) == {"full", "qkv", "proj", "mlp_fc1",
                                     "mlp_fc2"}
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    np.testing.assert_array_equal(got["proj"], cka[[2, 6]][:, [2, 6]])
    names = sorted(os.listdir(os.path.join(base, "jax_plots")))
    assert sorted(os.listdir(os.path.join(base, "port_plots"))) == names
    assert len(names) == 9  # four pickles, five PNGs
    for n in names:
        port = os.path.join(base, "port_plots", n)
        assert os.path.getsize(port) > 0
        if n.endswith(".pkl"):
            np.testing.assert_array_equal(
                _pickled(port), _pickled(os.path.join(base, "jax_plots", n)))
    for kind in ("qkv", "mlp_fc2"):
        assert plotting.sublayer_indices(kind, 12) == \
            jplot.sublayer_indices(kind, 12)

    pkl = os.path.join(base, "run", "run_heatmap.pkl")
    diag = plotting.load_and_plot_diagonal(pkl)
    np.testing.assert_array_equal(diag, jplot.load_and_plot_diagonal(
        pkl, save=False))
    np.testing.assert_array_equal(diag, np.diagonal(cka))
    assert os.path.exists(pkl.replace(".pkl", "_diagonal.png"))
    sub = os.path.join(base, "jax_plots", "cka_qkv.pkl")
    np.testing.assert_array_equal(
        plotting.load_and_plot_diagonal(sub, save=False),
        np.diagonal(want["qkv"]))


def test_diagonal_and_distribution_files(tmp_path):
    base = str(tmp_path)
    _heatmap(base, "a")
    pkl = os.path.join(base, "a", "a_heatmap.pkl")
    plotting.plot_all_diagonals([pkl, pkl], ["x", "y"],
                                os.path.join(base, "both"))
    assert os.path.getsize(os.path.join(base, "both.png")) > 0
    acts = [np.random.default_rng(1).standard_normal((2, 5, 8)),
            torch.ones(3, 4)]
    for mod, out in ((jplot, "jax_figs"), (plotting, "port_figs")):
        mod.plot_distribution(
            [a.numpy() if isinstance(a, torch.Tensor) else a for a in acts]
            if mod is jplot else acts, "blk", True,
            out_dir=os.path.join(base, out))
    assert sorted(os.listdir(os.path.join(base, "port_figs"))) == \
        sorted(os.listdir(os.path.join(base, "jax_figs"))) == \
        ["blk_0_quant.svg", "blk_1_quant.svg"]
