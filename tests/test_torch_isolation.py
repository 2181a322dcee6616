"""The PyTorch port stands alone: importing every one of its modules
loads neither JAX nor any module of the JAX package."""

import os
import pkgutil
import subprocess
import sys
import tomllib

REPO = os.path.join(os.path.dirname(os.path.abspath(__file__)), os.pardir)

_PROBE = r"""
import importlib, pkgutil, sys
import exploring_meta_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.")
             or m == "exploring_meta_tpu" or m.startswith("exploring_meta_tpu."))
print(len(names))
print(",".join(bad))
print(",".join(sorted(m for m in sys.modules if m.split(".")[0] == "matplotlib")))
print(",".join(sorted(m for m in sys.modules
                      if m.split(".")[0] in ("PIL", "wandb"))))
print(",".join(sorted(m for m in sys.modules if m.split(".")[0] == "scipy")))
print(",".join(sorted(m for m in sys.modules if m.split(".")[0]
                      in ("gymnasium", "gym", "mujoco", "metaworld"))))
import os
scripts = os.path.abspath("scripts") + os.sep
print(",".join(sorted(m for m, mod in list(sys.modules.items())
                      if (getattr(mod, "__file__", None) or "").startswith(
                          scripts))))
"""


def test_port_imports_neither_jax_nor_the_jax_package():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    n, bad = (out.stdout.split("\n") + [""])[:2]
    assert int(n) >= 35
    assert bad == "", bad


def test_no_port_module_imports_matplotlib_when_imported():
    """matplotlib (absent from the card's machine) is imported inside the
    plot functions only; the probe above imports every module, the
    analysis tier included."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.split("\n")
    assert lines[2] == "", lines[2]


def test_no_port_module_imports_pillow_or_wandb_when_imported():
    """Pillow (``tasks/pack.py``) and wandb (``utils/experiment.py``) are
    imported inside the functions that use them: the card's machine may
    lack Pillow, and wandb is installed nowhere."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.split("\n")
    assert lines[3] == "", lines[3]


def test_no_port_module_imports_scipy_when_imported():
    """scipy (the sweep band's Student-t, ``utils/plotter.py``) is imported
    inside the functions that use it, as matplotlib is: the seed-sweep
    modules (``parallel/multiseed.py``, ``sweep.py``) import neither."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.split("\n")
    assert lines[4] == "", lines[4]


def test_no_port_module_imports_the_host_physics_packages():
    """gymnasium, mujoco and metaworld (absent from the card's machine) are
    imported when a host env is built (``envs/host.py``,
    ``envs/metaworld_adapter.py``), never when a module is imported."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.split("\n")
    assert lines[5] == "", lines[5]


def test_port_imports_nothing_of_scripts():
    """``scripts/`` is not packaged: the port keeps its own copies of the
    reference reproductions (``parity/``) and imports no module there."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.split("\n")
    assert lines[6] == "", lines[6]


def test_port_module_list_is_complete():
    import exploring_meta_tpu_torch as pkg
    names = {m.name for m in pkgutil.walk_packages(pkg.__path__,
                                                   pkg.__name__ + ".")}
    for mod in ("serve", "cuda.cnn4_cuda", "cuda.build", "models.cnn4",
                "models.layers", "models.init", "adapt.maml", "ops.losses",
                "tasks.datasets", "tasks.sampler", "utils.experiment",
                "utils.bridge", "utils.tree", "device",
                # slice 2: MAML-TRPO on Particles2D
                "cuda.gae_cuda", "envs.particles2d", "envs.factory",
                "models.distributions", "models.policies", "ops.value",
                "ops.gae", "ops.cg", "rl.rollout", "rl.adapt_rl",
                "rl.trpo_meta", "rl.evaluate", "utils.config",
                "trainers.rl", "cli",
                # slice 5: the sweeps' redesign
                "cuda.compare_sweeps",
                # slice 6: vision meta-training
                "adapt.vision", "trainers.vision",
                # slice 7: policy serving and the Adam outer paths
                "rl.replay_meta",
                # slice 8: fused meta-iterations as CUDA-graph replays
                "trainers.fused", "rl.train_scan", "utils.graphs",
                # slice 9: the analysis tier
                "analysis", "analysis.cl", "analysis.rc",
                "analysis.eval_vision", "analysis.eval_rl", "ops.cca",
                "ops.cka", "ops.cl_metrics", "utils.plotter",
                # slice 10: the non-meta baselines
                "trainers.baselines",
                # slice 11: the run utilities and the offline tools
                "utils.compile_cache", "utils.dcp_ckpt", "utils.profiling",
                "utils.import_torch", "tasks.pack",
                # slice 12: seed sweeps
                "parallel", "parallel.multiseed", "sweep",
                # slice 13: host envs
                "native", "native.binding", "envs.host",
                "envs.metaworld_adapter", "rl.host_batched",
                # slice 14: scale-out and the last policies
                "ops.stats", "parallel.mesh", "parallel.launch",
                # slice 15: accuracy parity and the last entry points
                "parity", "parity.check", "parity.reference_vision",
                "parity.reference_rl", "serve_load", "render",
                # slice 17: bf16 CNN4 kernels on the tensor cores
                "cuda.compare_cnn4"):
        assert f"exploring_meta_tpu_torch.{mod}" in names


def test_packaging_ships_the_port_and_its_cuda_source():
    with open(os.path.join(REPO, "pyproject.toml"), "rb") as f:
        tool = tomllib.load(f)["tool"]["setuptools"]
    assert "exploring_meta_tpu_torch*" in tool["packages"]["find"]["include"]
    assert "csrc/*.cu" in tool["package-data"]["exploring_meta_tpu_torch"]
    assert "native/*.cpp" in tool["package-data"]["exploring_meta_tpu_torch"]
    for source in ("csrc/cnn4_block.cu", "csrc/gae.cu", "native/vecenv.cpp"):
        assert os.path.exists(os.path.join(
            REPO, "exploring_meta_tpu_torch", source))


def test_spawned_ranks_import_neither_jax_nor_the_jax_package():
    """A ``--mesh`` rank is a spawned process that imports the launch
    entry and the worker it runs (``tests/torch_mesh_workers.py``, which
    imports the port only); its ``sys.modules`` holds nothing of JAX."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    probe = (
        "import sys; sys.path[:0] = ['tests']\n"
        "from exploring_meta_tpu_torch.parallel.launch import launch\n"
        "import torch_mesh_workers as W\n"
        "if __name__ == '__main__':\n"
        "    out = launch(W.whoami, 2, device='cpu')\n"
        "    print(repr([o['result']['jax'] for o in out]))\n")
    out = subprocess.run([sys.executable, "-c", probe], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[[], []]"
