"""The port's plotter (``exploring_meta_tpu_torch/utils/plotter.py``) vs
the JAX package's, on the CPU.

Each function returns what JAX's returns on the same inputs (the
Student-t bands to 1e-12) and writes the same figure files where
matplotlib is installed; with matplotlib hidden it prints one line, writes
no figure and returns the same numbers.
"""

import json
import os
import sys

import numpy as np
import pytest

from exploring_meta_tpu.utils import plotter as jplot
from exploring_meta_tpu_torch.utils import plotter as tplot

BAND_TOL = 1e-12


def _run_dirs(root, curves, name="metrics.json", key="valid_acc"):
    dirs = []
    for i, c in enumerate(curves):
        d = root / f"run{i}"
        d.mkdir()
        body = ({key: list(c)} if name == "metrics.json"
                else {str(k): v for k, v in c.items()})
        (d / name).write_text(json.dumps(body))
        dirs.append(str(d))
    return dirs


def _hide_matplotlib(monkeypatch):
    """matplotlib (and pyplot) unimportable, as on the card's machine."""
    for mod in ("matplotlib", "matplotlib.pyplot"):
        monkeypatch.setitem(sys.modules, mod, None)


def _assert_band(got, want):
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=BAND_TOL,
                                   err_msg=k)


@pytest.mark.parametrize("n_runs", [1, 2, 3])
def test_runs_with_confidence_matches_jax(tmp_path, n_runs):
    rng = np.random.default_rng(n_runs)
    # ragged curves: both cut to the shortest run
    curves = [rng.uniform(size=5 + i) for i in range(n_runs)]
    dirs = _run_dirs(tmp_path, curves)
    got = tplot.plot_runs_with_confidence(
        dirs, metric="valid_acc", save_path=str(tmp_path / "port.png"))
    want = jplot.plot_runs_with_confidence(
        dirs, metric="valid_acc", save_path=str(tmp_path / "jax.png"))
    _assert_band(got, want)
    assert len(got["mean"]) == 5
    assert (tmp_path / "port.png").stat().st_size > 0


@pytest.mark.parametrize("n_runs", [1, 3])
def test_checkpoint_sweeps_match_jax(tmp_path, n_runs):
    rng = np.random.default_rng(10 + n_runs)
    # run 0 lacks checkpoint 30: only the shared checkpoints enter the band
    sweeps = [{k: float(rng.uniform()) for k in (0, 10, 20, 30)
               if not (i == 0 and k == 30 and n_runs > 1)}
              for i in range(n_runs)]
    dirs = _run_dirs(tmp_path, sweeps, name="ckpnt_results.json")
    for cap in (None, 25):
        got = tplot.plot_checkpoint_sweeps(
            dirs, save_path=str(tmp_path / "port.png"), max_checkpoint=cap)
        want = jplot.plot_checkpoint_sweeps(
            dirs, save_path=str(tmp_path / "jax.png"), max_checkpoint=cap)
        assert got["checkpoints"] == want["checkpoints"]
        _assert_band({k: got[k] for k in ("mean", "halfwidth")},
                     {k: want[k] for k in ("mean", "halfwidth")})
    assert (tmp_path / "port.png").exists()


@pytest.mark.parametrize("std", [False, True])
def test_plot_dict_writes_jax_file_name(tmp_path, std):
    plot = {"title": "valid acc", "x_legend": "it", "y_legend": "acc",
            "y_axis": [0.1, 0.3, 0.2]}
    if std:
        plot["std"] = [0.01, 0.02, 0.03]
    (tmp_path / "port").mkdir()
    (tmp_path / "jax").mkdir()
    assert tplot.plot_dict(plot, save=True, path=str(tmp_path / "port")) \
        is jplot.plot_dict(plot, save=True, path=str(tmp_path / "jax"))
    assert os.listdir(tmp_path / "port") == os.listdir(tmp_path / "jax") \
        == ["valid_acc.png"]


@pytest.mark.parametrize("ys", [{"a": [1, 2, 3], "b": [3, 2, 1]},
                                [[1, 2], [2, 1]]], ids=["dict", "list"])
def test_plot_dict_explicit_writes_jax_file_name(tmp_path, ys):
    plot = {"title": "two series", "y_axis": ys}
    (tmp_path / "port").mkdir()
    (tmp_path / "jax").mkdir()
    assert tplot.plot_dict_explicit(plot, save=True,
                                    path=str(tmp_path / "port")) \
        is jplot.plot_dict_explicit(plot, save=True,
                                    path=str(tmp_path / "jax"))
    assert os.listdir(tmp_path / "port") == os.listdir(tmp_path / "jax")


def test_plot_list_writes_its_figure(tmp_path):
    assert tplot.plot_list([3, 1, 2], title="t",
                           save_path=str(tmp_path / "l.png")) \
        is jplot.plot_list([3, 1, 2], title="t",
                           save_path=str(tmp_path / "j.png"))
    assert (tmp_path / "l.png").stat().st_size > 0


def test_without_matplotlib_one_line_no_figure_same_numbers(
        tmp_path, monkeypatch, capsys):
    rng = np.random.default_rng(0)
    dirs = _run_dirs(tmp_path, [rng.uniform(size=4) for _ in range(3)])
    want = jplot.plot_runs_with_confidence(dirs, metric="valid_acc")
    _hide_matplotlib(monkeypatch)
    capsys.readouterr()
    got = tplot.plot_runs_with_confidence(
        dirs, metric="valid_acc", save_path=str(tmp_path / "band.png"))
    _assert_band(got, want)
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == 1 and "matplotlib is not installed" in out[0]
    assert not (tmp_path / "band.png").exists()

    (tmp_path / "c").mkdir()
    cdirs = _run_dirs(tmp_path / "c", [{0: 0.2, 5: 0.4}, {0: 0.3, 5: 0.5}],
                      name="ckpnt_results.json")
    got = tplot.plot_checkpoint_sweeps(cdirs,
                                       save_path=str(tmp_path / "c.png"))
    assert got["checkpoints"] == [0, 5]
    assert len(capsys.readouterr().out.strip().splitlines()) == 1
    assert not (tmp_path / "c.png").exists()
    for call in (lambda: tplot.plot_dict({"title": "x", "y_axis": [1, 2]},
                                         save=True, path=str(tmp_path)),
                 lambda: tplot.plot_dict_explicit(
                     {"title": "y", "y_axis": [[1, 2]]}, save=True,
                     path=str(tmp_path)),
                 lambda: tplot.plot_list([1, 2], save_path=str(
                     tmp_path / "z.png")),
                 lambda: tplot.plot_sim_across_layers_average(
                     {"1": 0.5}, {"1": 0.1},
                     save_path=str(tmp_path / "s.png"))):
        assert call() is None
        assert len(capsys.readouterr().out.strip().splitlines()) == 1
    assert not list(tmp_path.glob("*.png"))
