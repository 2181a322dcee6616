"""The port's Particles2D objects built from a configuration file."""

from __future__ import annotations


def port_objects(cfg: dict, episodes: int, horizon: int):
    """-> (policy, RLConfig) of the port."""
    from exploring_meta_tpu_torch.models.policies import DiagNormalPolicy
    from exploring_meta_tpu_torch.rl.adapt_rl import RLConfig
    policy = DiagNormalPolicy(input_size=cfg["obs_size"],
                              output_size=cfg["action_size"],
                              hiddens=tuple(cfg["hiddens"]))
    rl_cfg = RLConfig(inner_lr=cfg["inner_lr"], gamma=cfg["gamma"],
                      tau=cfg["tau"], adapt_steps=cfg["adapt_steps"],
                      adapt_batch_size=episodes, max_path_length=horizon,
                      value_reg=cfg["value_reg"])
    return policy, rl_cfg


def policy_leaves(params: dict) -> list:
    """The port's policy params in the reference's leaf order."""
    out = []
    for layer in params["mean"]:
        out += [layer["w"], layer["b"]]
    return out + [params["sigma"]]
