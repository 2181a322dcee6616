"""Plots of the analysis tier (the part of
``exploring_meta_tpu/utils/plotter.py`` that the analysis tier calls).

matplotlib is imported inside each function, so the package imports and
the analysis runs where it is not installed; a plot is then skipped with
one printed line, and the JSON artifacts beside it carry the numbers.
"""

from __future__ import annotations

import numpy as np


def plot_sim_across_layers_average(mean_per_layer: dict,
                                   std_per_layer: dict, title: str = "",
                                   save_path: str | None = None) -> None:
    """Per-layer representation-similarity means with stdev errorbars
    (reference ``rc_rl.py:374-391``)."""
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        print(f"plot_sim_across_layers_average: matplotlib is not "
              f"installed; no figure written to {save_path}")
        return
    # keys arrive as str(layer): sort numerically ("10" after "2")
    layers = sorted(mean_per_layer, key=lambda k: int(k), reverse=True)
    means = [mean_per_layer[l] for l in layers]
    errs = [std_per_layer.get(l, 0.0) for l in layers]
    fig, ax = plt.subplots()
    x = np.arange(len(layers))
    ax.plot(x, means, linestyle="-", marker="o", alpha=0.7)
    ax.errorbar(x, means, yerr=errs, fmt="o")
    ax.set_title(title)
    ax.set_xlabel("Layers")
    ax.set_ylabel("CCA Similarity")
    ax.set_xticks(x)
    ax.set_xticklabels([f"L{l}" if str(l) != "-1" else "Head"
                        for l in layers])
    if save_path:
        fig.savefig(save_path, dpi=120, bbox_inches="tight")
    plt.close(fig)
