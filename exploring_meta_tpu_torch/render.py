"""Render rollouts of a saved policy (port of
``scripts/render_metaworld.py``; reference
``misc_scripts/render_metaworld.py``).

Loads a trained policy from a run directory (``logger.json`` and
``model.npz``, written by either package) and rolls it out on one slot of
the run's host env, rendering every step: Meta-World's or MuJoCo's own
``render()`` when the env has one, an animated GIF (or ``.npy`` frames
when the encoding fails) under ``--out``. Without a GL stack rendering
degrades to reporting the episode returns. Host physics only: a device
env (Particles2D) is refused. The policy runs on the card unless
``EMT_FORCE_CPU=1`` asks for the CPU, as in every other command, and each
step moves the observation to it and the action back, as the host-env
trainers' collection does (``envs/host.py:_place_policy``).

    python -m exploring_meta_tpu_torch.cli render_policy <run_dir> \\
        --episodes 3 --out renders/
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from exploring_meta_tpu_torch.device import resolve_device
from exploring_meta_tpu_torch.envs.factory import make_env
from exploring_meta_tpu_torch.envs.host import _place_policy
from exploring_meta_tpu_torch.trainers.rl import build_policy
from exploring_meta_tpu_torch.utils.config import requested_device
from exploring_meta_tpu_torch.utils.experiment import load_params
from exploring_meta_tpu_torch.utils.tree import tree_leaves


def write_frames(frames: list, out: str) -> str:
    """``frames`` as ``out/rollout.gif``, or as ``out/frame_<i>.npy`` when
    the GIF cannot be encoded (no Pillow, or frames it cannot take) ->
    what was written."""
    os.makedirs(out, exist_ok=True)
    try:  # animated GIF like the reference's renders/ artifacts
        from PIL import Image
        pil = [Image.fromarray(np.asarray(f, np.uint8)) for f in frames]
        gif = os.path.join(out, "rollout.gif")
        pil[0].save(gif, save_all=True, append_images=pil[1:],
                    duration=40, loop=0)
        print(f"wrote {gif} ({len(frames)} frames)")
        return gif
    except Exception as e:  # noqa: BLE001 - any encoder failure falls back
        for i, fr in enumerate(frames):
            np.save(os.path.join(out, f"frame_{i:05d}.npy"), fr)
        print(f"GIF encode failed ({e}); dumped {len(frames)} npy frames")
        return out


def render_policy(path: str, episodes: int = 3, out: str | None = None,
                  device=None) -> dict:
    """Roll the policy of run dir ``path`` out for ``episodes`` episodes
    on one task -> ``{"returns": [...], "frames": n, "written": path or
    None}``. The params go to ``device`` (``None``: the card)."""
    with open(os.path.join(path, "logger.json")) as f:
        config = json.load(f)["config"]
    env, is_device = make_env(config["dataset"], workers=1,
                              seed=config["seed"],
                              max_path_length=config["max_path_length"])
    if is_device:
        raise SystemExit("rendering targets host physics envs "
                         "(AntDirection / Meta-World)")

    policy = build_policy(env, config["algo"].startswith("anil"),
                          fc_neurons=config.get("fc_neurons", 100),
                          activation=config.get("activation", "relu"))
    dev = resolve_device(device)
    template = policy.init(torch.Generator(device=dev).manual_seed(0))
    params, gen = _place_policy(
        None, load_params(os.path.join(path, "model.npz"), template),
        torch.Generator(device=dev).manual_seed(0))
    pdev = tree_leaves(params)[0].device

    inner = env.envs[0]
    task = env.sample_tasks(None, 1)[0]
    inner.set_task(task)
    frames, returns = [], []
    can_render = True  # headless images (no GL stack) degrade gracefully
    for ep in range(episodes):
        obs = inner.reset()
        total = 0.0
        for _ in range(config["max_path_length"]):
            state = torch.from_numpy(np.asarray(obs, np.float32)[None])
            with torch.no_grad():
                action = policy.sample(params, gen, state.to(pdev))[0]
            action = action.cpu().numpy()
            obs, rew, done, _, _ = inner.step(action)
            total += rew
            render = getattr(getattr(inner, "_env", inner), "render", None)
            if can_render and render is not None:
                try:
                    frame = render()
                except Exception as e:  # noqa: BLE001 - no GL stack
                    print(f"rendering unavailable ({e}); reporting "
                          "returns only")
                    can_render = False
                    frame = None
                if out is not None and frame is not None:
                    frames.append(np.asarray(frame))
            if done:
                break
        print(f"episode {ep}: return {total:.2f}")
        returns.append(total)

    written = write_frames(frames, out) if out and frames else None
    return {"returns": returns, "frames": len(frames), "written": written}


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description="Render a saved policy")
    p.add_argument("path", help="run directory")
    p.add_argument("--episodes", type=int, default=3)
    p.add_argument("--out", default=None, help="dir for RGB frame dumps")
    args = p.parse_args(argv)
    return render_policy(args.path, args.episodes, args.out,
                         device=requested_device())
