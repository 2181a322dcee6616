"""The run utilities of the PyTorch port against the JAX package's, on the
CPU: checkpoints that cross packages, asynchronous and DCP checkpoints,
wandb, profiling and the compile cache.

- A port checkpoint holds its Adam state under optax's keys
  (``__opt__/0/{count,mu,nu}``) and loads through JAX's own
  ``load_checkpoint``; a JAX checkpoint loads in the port. From either
  loaded state one more Adam step in each package agrees within 1e-5 of
  lr once the known gap is taken out: ``optax.adam`` takes its bias
  corrections ``1 - b**t`` in float32, torch in double (ROADMAP Queue 3,
  standing finding on Adam). That scales optax's update by a factor
  ``1 + g(t)``, which the test reads from optax's own ``bias_correction``:
  g = -6.6e-6 at the first step, and from -3.6e-6 to -1.0e-5 at t = 2..12.
  An update of several lr (Adam's first steps) so differs by more than
  1e-5 lr; the rest, the params' own rounding, stays under 3e-6 lr.
- No port checkpoint holds JAX's ``__rng__`` (a threefry key, which JAX
  reads any ``__rng__`` as); a resume across packages restores params and
  optimizer and says that the random stream restarts from the seed.
- ``--compile_cache``: JAX's cases that carry over
  (``tests/test_compile_cache.py``), and every trainer and baseline takes
  ``--compile_cache off`` from argv (ROADMAP Queue 3, fault 1).
"""

import json
import os
import re
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from exploring_meta_tpu.models.policies import DiagNormalPolicy as JPolicy
from exploring_meta_tpu.utils import experiment as jexp
from exploring_meta_tpu.utils import profiling as jprof
from exploring_meta_tpu_torch import cli
from exploring_meta_tpu_torch.adapt.maml import adam
from exploring_meta_tpu_torch.cuda import build
from exploring_meta_tpu_torch.models.policies import DiagNormalPolicy
from exploring_meta_tpu_torch.trainers import baselines as tb
from exploring_meta_tpu_torch.trainers import rl as trl
from exploring_meta_tpu_torch.trainers import vision as tv
from exploring_meta_tpu_torch.utils import experiment as texp
from exploring_meta_tpu_torch.utils import profiling as tprof
from exploring_meta_tpu_torch.utils.bridge import params_from_jax
from exploring_meta_tpu_torch.utils.compile_cache import enable_compile_cache
from exploring_meta_tpu_torch.utils.dcp_ckpt import DCPCheckpointer
from exploring_meta_tpu_torch.utils.tree import tree_items, tree_leaves

LR = 0.01
REPO = os.path.join(os.path.dirname(os.path.abspath(__file__)), os.pardir)


@pytest.fixture(autouse=True)
def _restore_build_dir(monkeypatch):
    """Every test leaves the kernels' build directory where it was."""
    monkeypatch.setattr(build, "BUILD_DIR", build.BUILD_DIR)


def _stepped(seed=0, steps=2):
    """Port params of a DiagNormalPolicy(2, 2) and its Adam after
    ``steps`` steps on random gradients, and a generator."""
    gen = torch.Generator().manual_seed(seed)
    params = DiagNormalPolicy(2, 2).init(gen, device="cpu")
    for p in tree_leaves(params):
        p.requires_grad_()
    opt = adam(params, LR)
    for _ in range(steps):
        for p in tree_leaves(params):
            p.grad = torch.randn(p.shape, generator=gen)
        opt.step()
    return params, opt, gen


def _grads(seed, params):
    rng = np.random.default_rng(seed)
    return {k: rng.normal(size=tuple(v.shape)).astype(np.float32)
            for k, v in tree_items(params)}


def _jax_tree(flat, template):
    return jexp.unflatten_into(template, flat)


def _jax_step(params, state, grads):
    """One optax.adam step -> the new JAX params."""
    updates, _ = optax.adam(LR).update(grads, state, params)
    return optax.apply_updates(params, updates)


def _bias_correction_gap(count: int) -> float:
    """``g`` of the step after ``count`` Adam steps: optax's update over
    torch's, minus 1. Adam's step is ``lr * m / (1 - b1**t) / sqrt(v / (1 -
    b2**t))``; optax takes ``1 - b**t`` in float32 (``t`` int32, read here
    from optax's own ``bias_correction``), torch in double."""
    t = count + 1
    inv1, inv2 = (float(optax.tree.bias_correction(
        jnp.ones((), jnp.float32), b, jnp.asarray(t, jnp.int32)))
        for b in (0.9, 0.999))
    return inv1 / inv2 ** 0.5 * (1 - 0.999 ** t) ** -0.5 * (1 - 0.9 ** t) - 1


def _hold_adam_step(tnext, jbefore, jnext, count: int) -> None:
    """The port's params after its step within 1e-5 lr of JAX's, once
    JAX's update ``u`` is taken back by its bias-correction gap: ``|port -
    (jax - g u)| <= 1e-5 lr``."""
    g = _bias_correction_gap(count)
    before, after = jexp.flatten_params(jbefore), jexp.flatten_params(jnext)
    for k, p in tree_items(tnext):
        j, u = np.asarray(after[k]), np.asarray(after[k] - before[k])
        np.testing.assert_allclose(p.detach().numpy(), j - g * u, rtol=0,
                                   atol=1e-5 * LR, err_msg=k)


def _port_step(params, opt, grads):
    for k, p in tree_items(params):
        p.grad = torch.from_numpy(grads[k].copy())
    opt.step()
    return params


def _experiment(tmp_path, **kw):
    return texp.Experiment("maml_ppo", "Particles2D-v1", {"seed": 3},
                           path=str(tmp_path) + "/", **kw)


def test_port_checkpoint_holds_optax_keys_and_loads_in_jax(tmp_path):
    params, opt, gen = _stepped()
    e = _experiment(tmp_path)
    e.save_model_checkpoint(params, 7, opt_state=opt, gen=gen)
    path = os.path.join(e.model_path, "model_checkpoints", "model_7.npz")
    jtpl = JPolicy(2, 2).init(jax.random.key(0))
    want_keys = set(jexp.flatten_params(optax.adam(LR).init(jtpl),
                                        prefix="__opt__/"))
    with np.load(path) as z:
        files = set(z.files)
        assert z["__opt__/0/count"].dtype == np.int32
    assert {k for k in files if k.startswith("__opt__/")} == want_keys
    assert "__rng__" not in files and "__torch_rng__/cpu" in files
    jparams, jstate, jkey, it = jexp.load_checkpoint(
        path, jtpl, optax.adam(LR).init(jtpl))
    assert it == 7 and jkey is None
    assert int(jstate[0].count) == 2
    for k, p in tree_items(params):
        np.testing.assert_array_equal(
            np.asarray(jexp.flatten_params(jparams)[k]), p.detach().numpy())
        st = opt.state[p]
        np.testing.assert_array_equal(
            np.asarray(jexp.flatten_params(jstate[0].mu)[k]),
            st["exp_avg"].numpy())
        np.testing.assert_array_equal(
            np.asarray(jexp.flatten_params(jstate[0].nu)[k]),
            st["exp_avg_sq"].numpy())
    # one more step from the same state in each package
    grads = _grads(1, params)
    jnext = _jax_step(jparams, jstate, _jax_tree(grads, jtpl))
    _hold_adam_step(_port_step(params, opt, grads), jparams, jnext, 2)


def test_jax_checkpoint_loads_in_the_port(tmp_path, capsys):
    """A JAX checkpoint (optax state, threefry key) restores the port's
    params and Adam; its key is not a generator state, so the resume says
    the stream restarts from the seed, as JAX does with a port one."""
    jtpl = JPolicy(2, 2).init(jax.random.key(4))
    jparams = jax.tree_util.tree_map(lambda x: x + 0.1, jtpl)
    state = optax.adam(LR).init(jparams)
    for s in (5, 6, 7):
        g = _jax_tree(_grads(s, params_from_jax(jparams, "cpu")), jparams)
        _, state = optax.adam(LR).update(g, state, jparams)
    je = jexp.Experiment("maml_ppo", "Particles2D-v1", {"seed": 3},
                         path=str(tmp_path / "jax") + "/")
    je.save_model_checkpoint(jparams, 9, opt_state=state,
                             rng_key=jax.random.key(1))
    path = os.path.join(je.model_path, "model_checkpoints", "model_9.npz")

    params, opt, gen = _stepped(steps=0)
    loaded, lopt, gstate, it = texp.load_checkpoint(path, params, opt)
    assert it == 9 and lopt is opt and gstate is None
    for k, p in tree_items(params):
        st = opt.state[p]
        assert float(st["step"]) == 3.0 and st["step"].device.type == "cpu"
        np.testing.assert_array_equal(
            st["exp_avg"].numpy(),
            np.asarray(jexp.flatten_params(state[0].mu)[k]))
    before = gen.get_state()
    params, _, gen, start = texp.resume_training(path, params, opt, gen)
    out = capsys.readouterr().out
    assert start == 10 and torch.equal(gen.get_state(), before)
    assert "holds no cpu generator state" in out
    assert "restarts from --seed" in out
    for (k, p), (_, q) in zip(tree_items(params), tree_items(loaded)):
        assert torch.equal(p.detach(), q)
    grads = _grads(2, params)
    jnext = _jax_step(jparams, state, _jax_tree(grads, jparams))
    _hold_adam_step(_port_step(params, opt, grads), jparams, jnext, 3)


def test_first_adam_step_agrees_within_1e5_lr_as_it_stands():
    """The standing finding itself: from optax's init (count 0) the first
    step agrees within 1e-5 lr with no correction (g = -6.6e-6)."""
    params, opt, _ = _stepped(steps=0)
    # copies: JAX may take a numpy buffer without copying and read it when
    # its asynchronous step runs, after the port's step changed it in place
    jtpl = jexp.unflatten_into(JPolicy(2, 2).init(jax.random.key(0)),
                               {k: v.detach().numpy().copy()
                                for k, v in tree_items(params)})
    grads = _grads(3, params)
    jnext = _jax_step(jtpl, optax.adam(LR).init(jtpl),
                      _jax_tree(grads, jtpl))
    tnext = _port_step(params, opt, grads)
    assert abs(_bias_correction_gap(0)) < 1e-5
    for k, p in tree_items(tnext):
        np.testing.assert_allclose(
            p.detach().numpy(), np.asarray(jexp.flatten_params(jnext)[k]),
            rtol=0, atol=1e-5 * LR, err_msg=k)


def test_an_adam_that_has_not_stepped_saves_optax_init(tmp_path):
    params, opt, _ = _stepped(steps=0)
    flat = texp.adam_state(opt, params)
    jinit = jexp.flatten_params(
        optax.adam(LR).init(JPolicy(2, 2).init(jax.random.key(0))))
    assert set(flat) == set(jinit)
    assert float(flat["0/count"]) == 0
    assert all(not v.any() for v in flat.values())


def test_async_checkpoints_hold_the_values_at_submit_time(tmp_path):
    """Each submit is followed by in-place changes of the params, the Adam
    state and the generator; after the flush every file holds what was
    there at its submit."""
    params, opt, gen = _stepped()
    e = _experiment(tmp_path)
    want = {}
    for i in range(4):
        e.save_model_checkpoint(params, i, opt_state=opt, gen=gen,
                                async_write=True)
        want[i] = {k: v.detach().clone() for k, v in
                   texp.resume_state(params, opt, gen).items()}
        for p in tree_leaves(params):
            p.grad = torch.randn(p.shape, generator=gen)
        opt.step()
        with torch.no_grad():
            for p in tree_leaves(params):
                p.mul_(1.5)
    e.flush_checkpoints()
    for i, flat in want.items():
        with np.load(os.path.join(e.model_path, "model_checkpoints",
                                  f"model_{i}.npz")) as z:
            assert int(z["__iteration__"]) == i
            assert int(z["__opt__/0/count"]) == 2 + i
            for k, v in flat.items():
                np.testing.assert_array_equal(
                    z[k], v.numpy().astype(z[k].dtype), err_msg=k)


def test_a_failed_async_write_raises_at_the_flush(tmp_path):
    params, opt, gen = _stepped()
    e = _experiment(tmp_path)
    os.rmdir(os.path.join(e.model_path, "model_checkpoints"))
    e.save_model_checkpoint(params, 0, async_write=True)
    with pytest.raises(FileNotFoundError):
        e.flush_checkpoints()


def test_dcp_saves_restore_and_the_latest_step_wins(tmp_path):
    params, opt, gen = _stepped()
    ck = DCPCheckpointer(str(tmp_path / "model_checkpoints"))
    ck.save(3, params, opt_state=opt, gen=gen)
    saved = {k: v.detach().clone() for k, v in
             texp.resume_state(params, opt, gen).items()}
    with torch.no_grad():
        for p in tree_leaves(params):
            p.add_(1.0)
    ck.save(11, params)                    # params only
    ck.wait()
    assert ck.steps() == [3, 11] and ck.latest_step() == 11
    tpl, topt, _ = _stepped(seed=9, steps=0)
    p, o, g, step = ck.restore(tpl, topt, step=3)
    assert step == 3 and o is topt and g is not None
    assert torch.equal(g, saved["__torch_rng__/cpu"])
    for k, v in tree_items(p):
        assert torch.equal(v, saved[k])
    for k, t in tree_items(tpl):
        assert torch.equal(topt.state[t]["exp_avg"],
                           saved[f"__opt__/0/mu/{k}"])
        assert float(topt.state[t]["step"]) == 2.0
    # the directory restores its latest step; a params-only save gives None
    tpl, topt, _ = _stepped(seed=9, steps=0)
    p, o, g, it = texp.load_checkpoint(str(tmp_path / "model_checkpoints"),
                                       tpl, topt)
    assert (it, o, g) == (11, None, None)
    for (_, a), (_, b) in zip(tree_items(p), tree_items(params)):
        assert torch.equal(a, b.detach())


def test_experiment_writes_dcp_steps_under_the_orbax_backend(tmp_path):
    params, opt, gen = _stepped()
    e = _experiment(tmp_path)
    e.ckpt_backend = "orbax"
    e.save_model_checkpoint(params, 0, opt_state=opt, gen=gen)
    e.save_model_checkpoint(params, 4, opt_state=opt, gen=gen)
    e.flush_checkpoints()
    ckdir = os.path.join(e.model_path, "model_checkpoints")
    assert sorted(os.listdir(ckdir)) == ["0", "4"]
    tpl, topt, tgen = _stepped(seed=9, steps=0)
    _, o, _, start = texp.resume_training(ckdir, tpl, topt, tgen)
    assert start == 5 and o is topt
    assert torch.equal(tgen.get_state(), gen.get_state())


class _Wandb(types.ModuleType):
    """A stand-in for wandb that records ``init`` and ``log``."""

    def __init__(self):
        super().__init__("wandb")
        self.calls = []

    def init(self, project=None, id=None, config=None, tags=None):
        self.calls.append(("init", project, id, sorted(config), tags))
        return self

    def log(self, metrics, step=None):
        self.calls.append(("log", dict(metrics), step))


def test_wandb_records_what_jax_records(tmp_path, monkeypatch):
    calls = {}
    for name, make in (("port", lambda p, **kw: texp.Experiment(
            "maml_trpo", "Particles2D-v1", {"seed": 3}, path=p, **kw)),
                       ("jax", lambda p, **kw: jexp.Experiment(
            "maml_trpo", "Particles2D-v1", {"seed": 3}, path=p, **kw))):
        stub = _Wandb()
        monkeypatch.setitem(sys.modules, "wandb", stub)
        e = make(str(tmp_path / name) + "/", use_wandb=True)
        e.log_metrics({"meta_loss": 0.5, "adapt_reward": -3.0}, step=2)
        e.log_metrics({"meta_loss": 0.25})
        init = stub.calls[0]
        assert init[2] == f"maml_trpo_Particles2D-v1_{e.logger['model_id']}"
        calls[name] = [init[:2] + init[3:]] + stub.calls[1:]
    assert calls["port"] == calls["jax"]
    assert calls["port"][0][0] == "init" and calls["port"][1][2] == 2


def test_without_wandb_the_run_says_so_and_goes_on(tmp_path, monkeypatch,
                                                   capsys):
    monkeypatch.setitem(sys.modules, "wandb", None)
    e = _experiment(tmp_path, use_wandb=True)
    e.log_metrics({"meta_loss": 1.0})
    assert "wandb unavailable" in capsys.readouterr().out
    assert e.metrics == {"meta_loss": [1.0]}


def test_phase_timer_schema_is_jax_s(tmp_path):
    summaries = {}
    for name, mod, x in (("port", tprof, torch.ones(3)),
                         ("jax", jprof, jnp.ones(3))):
        timer = mod.PhaseTimer()
        for _ in range(2):
            with timer.phase("collect") as sync:
                sync.append(x * 2)
        with timer.phase("meta_step", block_on=x):
            pass
        summaries[name] = timer.summary()
        timer.save(str(tmp_path / f"{name}.json"))
    for name, s in summaries.items():
        assert {k: (sorted(v), v["count"]) for k, v in s.items()} == {
            "collect": (["count", "mean_ms", "total_s"], 2),
            "meta_step": (["count", "mean_ms", "total_s"], 1)}, name
        with open(tmp_path / f"{name}.json") as f:
            assert set(json.load(f)) == {"collect", "meta_step"}


def _jax_phase_names(module: str) -> set:
    with open(os.path.join(REPO, "exploring_meta_tpu", "trainers",
                           module)) as f:
        return set(re.findall(r'ph\("(\w+)"\)', f.read()))


@pytest.mark.parametrize("kind,fuse,want", [
    ("trpo", 1, {"collect", "meta_step"}), ("ppo", 1, {"meta_step"}),
    ("trpo", 2, {"train_chunk"}), ("vision", 1,
                                   {"sample", "valid_eval", "meta_step"}),
    ("vision", 2, {"train_chunk"}),
])
def test_profile_writes_jax_s_phases(tmp_path, kind, fuse, want):
    """``--profile`` writes ``phase_times.json`` with the phases of JAX's
    trainer on the same path (names read from JAX's trainer source)."""
    if kind == "vision":
        cfg = tv.VisionConfig(num_iterations=2, meta_batch_size=2, shots=1,
                              synthetic=True, profile=True, fuse=fuse,
                              save_every=10)
        trainer = tv.VisionTrainer(cfg, path=str(tmp_path) + "/",
                                   device="cpu")
        jax_names = _jax_phase_names("vision.py")
    else:
        cfg = trl.RLScriptConfig(num_iterations=2, meta_batch_size=2,
                                 adapt_batch_size=2, max_path_length=5,
                                 n_eval_tasks=1, profile=True, fuse=fuse,
                                 outer_lr=0.01, save_every=10)
        trainer = trl.RLTrainer(cfg, algo=kind, path=str(tmp_path) + "/",
                                device="cpu")
        jax_names = _jax_phase_names("rl.py")
    trainer.run()
    with open(os.path.join(trainer.model_path, "phase_times.json")) as f:
        phases = json.load(f)
    assert set(phases) == want and want <= jax_names
    per = 1 if fuse > 1 else 2
    assert all(v["count"] == per and v["total_s"] >= 0
               for v in phases.values())


def test_device_trace_writes_a_chrome_trace(tmp_path):
    with tprof.device_trace(str(tmp_path / "trace")):
        torch.ones(8).mul(3).sum()
    (name,) = os.listdir(tmp_path / "trace")
    with open(tmp_path / "trace" / name) as f:
        events = json.load(f)["traceEvents"]
    assert any("aten::mul" in e.get("name", "") for e in events)


# -- the compile cache: tests/test_compile_cache.py's cases that carry over

def test_off_values_disable():
    for v in ("off", "OFF", "none", "0", "false", " off "):
        assert enable_compile_cache(v) is None
        assert build.BUILD_DIR == build.DEFAULT_BUILD_DIR


def test_env_var_off(monkeypatch):
    monkeypatch.setenv("EMT_COMPILE_CACHE", "off")
    assert enable_compile_cache("") is None
    assert enable_compile_cache(None) is None


def test_explicit_path_wins_over_env(tmp_path, monkeypatch):
    monkeypatch.setenv("EMT_COMPILE_CACHE", "off")
    d = str(tmp_path / "cache")
    assert enable_compile_cache(d) == d
    assert os.path.isdir(d) and build.BUILD_DIR == d


def test_env_var_path(tmp_path, monkeypatch):
    d = str(tmp_path / "envcache")
    monkeypatch.setenv("EMT_COMPILE_CACHE", d)
    assert enable_compile_cache("") == d
    assert os.path.isdir(d) and build.BUILD_DIR == d


def test_library_path_moves_with_the_cache(tmp_path, monkeypatch):
    """The hashed library name stays; only its directory moves (no nvcc is
    needed to name it)."""
    monkeypatch.delenv("EMT_COMPILE_CACHE", raising=False)
    default = build.library_path("gae.cu")
    enable_compile_cache(str(tmp_path / "kernels"))
    moved = build.library_path("gae.cu")
    assert os.path.dirname(moved) == str(tmp_path / "kernels")
    assert os.path.basename(moved) == os.path.basename(default)
    assert os.path.dirname(default) == build.DEFAULT_BUILD_DIR
    _experiment(tmp_path / "runs")           # "" and no env: build/ again
    assert build.library_path("gae.cu") == default


def test_experiment_respects_off(tmp_path, monkeypatch):
    monkeypatch.setenv("EMT_COMPILE_CACHE", str(tmp_path / "env"))
    texp.Experiment("algo", "ds", {"compile_cache": "off"},
                    path=str(tmp_path) + "/")
    assert build.BUILD_DIR == build.DEFAULT_BUILD_DIR
    assert not os.path.exists(tmp_path / "env")


VISION_ARGV = ["--num_iterations", "1", "--meta_batch_size", "2",
               "--synthetic"]
RL_ARGV = ["--num_iterations", "1", "--meta_batch_size", "2"]


@pytest.mark.parametrize("command", [
    "maml_vision", "anil_vision", "maml_trpo", "anil_trpo", "maml_ppo",
    "anil_ppo", "maml_vpg", "anil_vpg", "ppo_baseline", "trpo_baseline",
    "random_baseline", "vision_baseline"])
def test_every_trainer_takes_compile_cache_off_from_argv(tmp_path,
                                                         monkeypatch,
                                                         command):
    """JAX's ``--compile_cache off`` reaches each trainer's ``Experiment``
    (which builds the kernels into build/) instead of being refused; the
    training itself is skipped here."""
    built = []
    for cls in (trl.RLTrainer, tv.VisionTrainer, tb.PPOBaseline,
                tb.TRPOBaseline, tb.RandomPolicyBaseline, tb.VisionBaseline):
        monkeypatch.setattr(cls, "run", lambda self: built.append(self))
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("EMT_FORCE_CPU", "1")
    monkeypatch.setenv("EMT_COMPILE_CACHE", str(tmp_path / "env"))
    argv = VISION_ARGV if "vision" in command else RL_ARGV
    cli.COMMANDS[command](argv + ["--compile_cache", "off"])
    (trainer,) = built
    assert trainer.cfg.compile_cache == "off"
    assert build.BUILD_DIR == build.DEFAULT_BUILD_DIR
    assert os.path.isdir(os.path.join(trainer.model_path,
                                      "model_checkpoints"))
