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
"""


def test_port_imports_neither_jax_nor_the_jax_package():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    n, bad = (out.stdout.split("\n") + [""])[:2]
    assert int(n) >= 33
    assert bad == "", bad


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
                "trainers.rl", "cli"):
        assert f"exploring_meta_tpu_torch.{mod}" in names


def test_packaging_ships_the_port_and_its_cuda_source():
    with open(os.path.join(REPO, "pyproject.toml"), "rb") as f:
        tool = tomllib.load(f)["tool"]["setuptools"]
    assert "exploring_meta_tpu_torch*" in tool["packages"]["find"]["include"]
    assert "csrc/*.cu" in tool["package-data"]["exploring_meta_tpu_torch"]
    for source in ("cnn4_block.cu", "gae.cu"):
        assert os.path.exists(os.path.join(
            REPO, "exploring_meta_tpu_torch", "csrc", source))
