"""The plain references against the port's CPU path at small sizes: the
CNN4 forward, a served request, the second-order meta-step with Adam, and
on Particles2D the rollout, discounting and GAE, and the VPG step."""

import pytest
import torch

from portbench import synth
from portbench.reference import cnn4 as rc
from portbench.reference import particles as rp
from portbench.reference.precision import Precision

F64 = Precision("float64")
CNN4 = {"image_size": 28, "channels": 1, "hidden": 8, "layers": 4,
        "ways": 5, "shots": 2, "queries": 5, "inner_lr": 0.5,
        "adapt_steps": 1, "outer_lr": 0.003}
MLP = {"obs_size": 2, "action_size": 2, "hiddens": [16, 16],
       "max_action": 0.1, "goal_threshold": 0.01, "goal_range": 0.5,
       "gamma": 0.99, "tau": 1.0, "value_reg": 1e-5, "inner_lr": 0.05,
       "adapt_steps": 1, "outer_lr": 1.0, "max_kl": 0.01,
       "ls_max_steps": 15, "backtrack_factor": 0.5, "cg_iterations": 10,
       "damping": 1e-5}


def _spec():
    from exploring_meta_tpu_torch.models.cnn4 import CNN4Spec
    return CNN4Spec(channels=1, hidden=CNN4["hidden"], layers=4,
                    max_pool=False, head_in=CNN4["hidden"], ways=5,
                    image_size=28, head_init="normal", global_pool=True)


def _images(n):
    gen = torch.Generator().manual_seed(3)
    return torch.rand((n, 28, 28, 1), generator=gen)


@pytest.mark.parametrize("impl", ["direct", "fused"])
def test_cnn4_forward(impl):
    from exploring_meta_tpu_torch.models import layers
    from exploring_meta_tpu_torch.models.cnn4 import cnn4_apply
    params = synth.cnn4_params(torch.Generator().manual_seed(1), CNN4)
    x = _images(6)
    saved = layers.get_conv_impl()
    layers.set_conv_impl(impl)
    try:
        got = cnn4_apply(params, _spec(), x)
    finally:
        layers.set_conv_impl(saved)
    want = rc.forward(rc.cast(params, F64), x.double(), F64)
    assert torch.allclose(got.double(), want, rtol=1e-4, atol=1e-4)


def test_served_request():
    from exploring_meta_tpu_torch.serve import VisionServer
    params = synth.cnn4_params(torch.Generator().manual_seed(2), CNN4)
    sx, qx = _images(10), _images(5) * 0.5
    sy = torch.arange(10) // 2
    server = VisionServer(_spec(), params, inner_lr=0.5, adapt_steps=1,
                          device="cpu")
    _, probs = server.batch(sx[None], sy[None], qx[None])
    want = rc.serve(params, sx, sy, qx, CNN4, F64)
    # float32 against float64 through one inner step at lr 0.5
    assert torch.allclose(probs[0].double(), want, atol=1e-5)


def test_second_order_meta_step_and_adam():
    from exploring_meta_tpu_torch.adapt.maml import adam, make_meta_step
    from exploring_meta_tpu_torch.adapt.vision import make_vision_fast_adapt
    params0 = synth.cnn4_params(torch.Generator().manual_seed(4), CNN4)
    gen = torch.Generator().manual_seed(5)
    data = torch.rand((3, 20, 28, 28, 1), generator=gen)
    labels = (torch.arange(20) // 4).expand(3, -1)
    params = {"base": [{g: {k: v.clone().requires_grad_()
                            for k, v in b[g].items()} for g in b}
                       for b in params0["base"]],
              "head": {k: v.clone().requires_grad_()
                       for k, v in params0["head"].items()}}
    opt = adam(params, CNN4["outer_lr"])
    step = make_meta_step(make_vision_fast_adapt(_spec(), 0.5, 1, 2, 5))
    _, _, m = step(params, opt, data, labels)
    s = torch.arange(10) * 2
    batch = (data[:, s], labels[:, s], data[:, s + 1], labels[:, s + 1])
    losses, grads, after = rc.meta_train(params0, [batch], CNN4, F64)
    assert float(m["loss"]) == pytest.approx(losses[0], rel=1e-5)
    got = [p.grad for _, p in rc.leaves(params)]
    scale = max(float(w.abs().max()) for w in grads)
    for g, w in zip(got, grads):
        assert torch.allclose(g.double(), w, rtol=1e-3, atol=1e-5 * scale)
    # leaves whose gradient is nought to rounding (the conv biases, under
    # BN) move under Adam by round-off alone: left out, as the check does
    norms = sorted(float(w.norm()) for w in grads)
    med = norms[len(norms) // 2]
    for (_, p), w, g in zip(rc.leaves(params), after[0], grads):
        if float(g.norm()) >= 1e-3 * med:
            assert torch.allclose(p.detach().double(), w, atol=1e-6)


def _port_rl():
    from exploring_meta_tpu_torch.envs.particles2d import Particles2D
    from exploring_meta_tpu_torch.models.policies import DiagNormalPolicy
    env = Particles2D()
    policy = DiagNormalPolicy(input_size=2, output_size=2,
                              hiddens=tuple(MLP["hiddens"]))
    return env, policy


def _port_traj(traj):
    from exploring_meta_tpu_torch.rl.rollout import Trajectory
    return Trajectory(*traj)


def test_rollout_draws_the_programs_numbers():
    from exploring_meta_tpu_torch.adapt.maml import per_task
    from exploring_meta_tpu_torch.rl.rollout import rollout
    env, policy = _port_rl()
    params = synth.policy_params(torch.Generator().manual_seed(6), MLP)
    goals = env.sample_tasks(torch.Generator().manual_seed(7), 3)
    got = rollout(env, policy.sample, per_task(params, 3), goals,
                  torch.Generator().manual_seed(8), episodes=4, horizon=30)
    f32 = Precision("float32")
    want = rp.rollout(rp.per_task(params, 3), goals,
                      torch.Generator().manual_seed(8), 4, 30, MLP, f32)
    for name, g, w in zip(rp.Traj._fields, got, want):
        assert torch.allclose(g.double(), w.double(), atol=1e-6), name


def test_discount_gae_and_baseline():
    from exploring_meta_tpu_torch.ops.gae import discount
    from exploring_meta_tpu_torch.rl.adapt_rl import RLConfig, \
        traj_advantages
    params = synth.policy_params(torch.Generator().manual_seed(9), MLP)
    goals = torch.rand((3, 2), generator=torch.Generator().manual_seed(1))
    traj = rp.rollout(rp.per_task(params, 3), goals - 0.5,
                      torch.Generator().manual_seed(2), 5, 40, MLP,
                      Precision("float32"))
    got = discount(0.99, traj.reward, traj.done)
    assert torch.allclose(got, rp.discount(0.99, traj.reward, traj.done),
                          atol=1e-5)
    adv, _ = traj_advantages(_port_traj(traj), RLConfig(gamma=0.99,
                                                        tau=1.0))
    t64 = rp.Traj(*(x.double() if x.is_floating_point() else x
                    for x in traj))
    want, _ = rp.advantages(t64, MLP, F64)
    assert torch.allclose(adv.double(), want, atol=1e-3 * float(
        want.abs().max()))


def test_vpg_step():
    from exploring_meta_tpu_torch.adapt.maml import per_task
    from exploring_meta_tpu_torch.rl.adapt_rl import RLConfig, \
        single_adapt_step
    env, policy = _port_rl()
    params = synth.policy_params(torch.Generator().manual_seed(10), MLP)
    goals = env.sample_tasks(torch.Generator().manual_seed(11), 3)
    traj = rp.rollout(rp.per_task(params, 3), goals,
                      torch.Generator().manual_seed(12), 5, 30, MLP,
                      Precision("float32"))
    got = single_adapt_step("vpg", policy, per_task(params, 3),
                            _port_traj(traj), RLConfig(inner_lr=0.05))
    t64 = rp.Traj(*(x.double() if x.is_floating_point() else x
                    for x in traj))
    want = rp.vpg_adapt(rp.per_task(rp.cast(params, F64), 3), t64, MLP, F64)
    for g, w, p in zip(rp.leaves(got), rp.leaves(want), rp.leaves(params)):
        step = float((w - p.double()).norm())
        assert float((g.detach().double() - w).norm()) <= 1e-3 * step + 1e-9
