"""Nothing the benchmark runs loads JAX or the package the port was made
from, compared by whole top-level module names; the plain references load
nothing of the port either."""

import ast
import glob
import os
import subprocess
import sys

from conftest import ROOT

from portbench import harness

REFERENCE = os.path.join(ROOT, "portbench", "reference")


def _modules_after(code: str) -> set:
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys\n"
         "print(sorted({m.split('.')[0] for m in sys.modules}))"],
        cwd=ROOT, capture_output=True, text=True, check=True)
    return set(eval(out.stdout.strip().splitlines()[-1]))


def test_harness_and_drivers_load_no_jax():
    code = ("import portbench.run, portbench.harness, portbench.readings,"
            " portbench.faults\n"
            "import importlib, glob, os\n"
            "for f in glob.glob('portbench/drivers/*.py'):\n"
            "    importlib.import_module('portbench.drivers.' + "
            "os.path.basename(f)[:-3])\n"
            "from portbench import registry\n"
            "for f in glob.glob('portbench/metrics/[!_]*.py'):\n"
            "    registry.metric(os.path.basename(f)[:-3])\n"
            "import exploring_meta_tpu_torch.serve, "
            "exploring_meta_tpu_torch.adapt.maml, "
            "exploring_meta_tpu_torch.rl.train_scan")
    loaded = _modules_after(code)
    assert not loaded & set(harness.FORBIDDEN), loaded & set(
        harness.FORBIDDEN)
    assert "exploring_meta_tpu_torch" in loaded


def test_references_load_nothing_of_the_port():
    loaded = _modules_after("import portbench.reference.cnn4, "
                            "portbench.reference.particles")
    assert not loaded & {"jax", "jaxlib", "flax", "exploring_meta_tpu",
                         "exploring_meta_tpu_torch"}


def test_reference_sources_import_only_torch_and_themselves():
    for path in glob.glob(os.path.join(REFERENCE, "*.py")):
        tree = ast.parse(open(path).read())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                top = name.split(".")[0]
                assert top in ("__future__", "torch", "math", "typing",
                               "contextlib", "portbench"), (path, name)
                if top == "portbench":
                    assert name.startswith("portbench.reference"), name


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "exploring_meta_tpu_torch_fake", sys)
    assert "exploring_meta_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "exploring_meta_tpu.fake", sys)
    assert "exploring_meta_tpu" in harness.forbidden_modules()


def test_run_without_a_card_exits_nonzero_and_prints_no_result():
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "omniglot-5w5s-serve-b64", "--seed", "3000000000", "--seconds",
         "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0
    assert out.stdout.strip() == ""
