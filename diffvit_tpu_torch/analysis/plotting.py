"""CKA heatmap, diagonal and activation-distribution plots (the port's
counterpart of ``diffvit_tpu/analysis/plotting.py``; the reference's
``plot.py`` and ``models/plot_distrib.py``).

matplotlib is imported inside the drawing functions, with the ``Agg``
backend, so that importing this module needs none; a drawing function
raises ``ImportError`` where matplotlib is missing.  The pickles hold numpy
arrays, so each package reads the other's.
"""
from __future__ import annotations

import os
import pickle
from math import ceil, sqrt

import numpy as np


def _pyplot():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _load(pickle_file):
    with open(pickle_file, "rb") as f:
        return np.asarray(pickle.load(f))


def plot_ckalist_resume(cka_list, save_name):
    """A grid of CKA heatmaps (``plot.py:9-56``) in ``save_name.png``."""
    plt = _pyplot()
    n = len(cka_list)
    y = ceil(sqrt(n))
    x = y if (y - 1) * y < n or n == y * y else y - 1
    fig = plt.figure(figsize=(y * 4, x * 4), frameon=False)
    sc = None
    for i, cka in enumerate(cka_list):
        ax = fig.add_subplot(x, y, i + 1)
        ll = cka.shape[0]
        sc = ax.imshow(np.asarray(cka), cmap="magma", vmin=0.0, vmax=1.0)
        step = max(1, int(ll / 5))
        ax.set_xticks(list(range(0, ll, step)))
        ax.set_yticks([])
        ax.axes.invert_yaxis()
    fig.add_axes([0.92, 0.35, 0.015, 0.35])
    plt.colorbar(sc, cax=fig.axes[-1])
    plt.savefig(f"{save_name}.png", dpi=300)
    plt.close(fig)


def sublayer_indices(kind, depth=12):
    """The bit-config-style sub-layer rows of a 4 * depth + 2 heatmap:
    qkv / proj / fc1 / fc2 are 4i+1 / 4i+2 / 4i+3 / 4i+4
    (``plot.py:89-92``)."""
    off = {"qkv": 1, "proj": 2, "mlp_fc1": 3, "mlp_fc2": 4}[kind]
    return [i * 4 + off for i in range(depth)]


def plot_cka_map(cka_file_name, plot_name, base_dir, depth=12):
    """Slice a (4 * depth + 2)-tap heatmap into its qkv / proj / fc1 / fc2
    sub-maps, pickle each and draw the grids (``plot.py:71-138``).
    Returns {"full": heatmap, kind: sub-map}."""
    cka = _load(os.path.join(base_dir, cka_file_name,
                             cka_file_name + "_heatmap.pkl"))
    plot_dir = os.path.join(base_dir, plot_name)
    os.makedirs(plot_dir, exist_ok=True)
    outputs = {"full": cka}
    for kind in ("qkv", "proj", "mlp_fc1", "mlp_fc2"):
        idx = sublayer_indices(kind, depth)
        sub = cka[idx][:, idx]
        with open(os.path.join(plot_dir, f"cka_{kind}.pkl"), "wb") as f:
            pickle.dump(sub, f)
        plot_ckalist_resume([sub], os.path.join(plot_dir, f"cka_{kind}"))
        outputs[kind] = sub
    plot_ckalist_resume([cka], os.path.join(plot_dir, "full"))
    return outputs


def load_and_plot_diagonal(pickle_file, save=True):
    """The diagonal of a pickled heatmap (``plot.py:144-166``), drawn
    beside it as ``*_diagonal.png`` when ``save``."""
    diag = np.diagonal(_load(pickle_file))
    if save:
        plt = _pyplot()
        fig = plt.figure(figsize=(6, 4))
        plt.plot(diag, marker="o")
        plt.ylim(0, 1.05)
        plt.xlabel("layer")
        plt.ylabel("CKA")
        plt.savefig(pickle_file.replace(".pkl", "_diagonal.png"), dpi=300)
        plt.close(fig)
    return diag


def plot_all_diagonals(pickle_files, labels, save_name):
    """Several heatmaps' diagonals in one plot (``plot.py:178-217``)."""
    plt = _pyplot()
    fig = plt.figure(figsize=(7, 5))
    for pf, label in zip(pickle_files, labels):
        plt.plot(np.diagonal(_load(pf)), marker="o", label=label)
    plt.ylim(0, 1.05)
    plt.xlabel("layer")
    plt.ylabel("CKA")
    plt.legend()
    plt.savefig(f"{save_name}.png", dpi=300)
    plt.close(fig)


def plot_distribution(activations, name, quant, out_dir="figs"):
    """Per-channel max and min of each activation, one ``.svg`` each
    (``models/plot_distrib.py:72-89``).  ``activations``: arrays or
    tensors (on any device)."""
    plt = _pyplot()
    os.makedirs(out_dir, exist_ok=True)
    tag = "quant" if quant else "fp"
    for i, act in enumerate(activations):
        a = act.detach().cpu().numpy() if hasattr(act, "detach") \
            else np.asarray(act)
        a = a.reshape(-1, a.shape[-1])
        fig = plt.figure(figsize=(8, 3))
        plt.plot(a.max(axis=0), label="max")
        plt.plot(a.min(axis=0), label="min")
        plt.legend()
        plt.title(f"{name}_{i}_{tag}")
        plt.savefig(os.path.join(out_dir, f"{name}_{i}_{tag}.svg"))
        plt.close(fig)
