"""Import reference-trained torch checkpoints into the port's params (the
port's own copy of ``exploring_meta_tpu/utils/import_torch.py``).

The reference's run dirs hold torch ``state_dict`` pickles. This module
loads them into the port's params trees, torch tensors in the JAX layout,
and whole run dirs into the run-dir contract that both packages'
``load_params``, the port's ``eval_*`` and its servers read:

- conv weights: torch OIHW ``[co, ci, kh, kw]`` -> HWIO ``[kh, kw, ci,
  co]``;
- linear weights: ``[out, in]`` -> ``[in, out]``;
- flattened conv features feeding a linear head (MiniImagenetCNN's
  ``view(-1, 25 * hidden)``, ANIL-vision's flatten): torch flattens NCHW
  as (c, h, w) and the port, as JAX, NHWC as (h, w, c), so the head's
  input axis is permuted;
- BatchNorm: ``normalize.{weight,bias}`` -> ``bn.{scale,bias}``; the
  running statistics are dropped, since both normalize with batch
  statistics;
- ``module.``-prefixed keys (l2l ``MAML``-wrapped modules) are unwrapped;
- ANIL RL checkpoints hold body and head only; ``sigma`` is reset to its
  init log(1) = 0, as the reference's own eval driver does;
- the cherry ``LinearValue`` baseline is not imported: the port fits its
  linear baseline in closed form per batch.
"""

from __future__ import annotations

import glob
import json
import os
import re

import numpy as np
import torch


# ---------------------------------------------------------------------------
# state_dict loading / key utilities
# ---------------------------------------------------------------------------

def load_state_dict(path: str) -> dict:
    """``torch.load`` a ``.pt`` state_dict (weights only) -> ``{key: CPU
    tensor}``."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    return {k: v.detach().cpu() for k, v in sd.items()
            if isinstance(v, torch.Tensor)}


def strip_maml_prefix(sd: dict) -> dict:
    """Unwrap l2l ``MAML(module)`` state_dicts (keys ``module.*``)."""
    if sd and all(k.startswith("module.") for k in sd):
        return {k[len("module."):]: v for k, v in sd.items()}
    return sd


def _t(w) -> torch.Tensor:
    return torch.as_tensor(w).t().contiguous()


def _copy(w) -> torch.Tensor:
    return torch.as_tensor(w).clone()


def _conv_w(w) -> torch.Tensor:
    """OIHW -> HWIO."""
    return torch.as_tensor(w).permute(2, 3, 1, 0).contiguous()


def _flat_head_w(w, channels: int, spatial: int) -> torch.Tensor:
    """Torch ``[out, c*h*w]`` head weight -> ``[h*w*c, out]``."""
    w = torch.as_tensor(w)
    out = w.shape[0]
    w = w.reshape(out, channels, spatial, spatial).permute(0, 2, 3, 1)
    return _t(w.reshape(out, -1))


# ---------------------------------------------------------------------------
# vision models
# ---------------------------------------------------------------------------

def import_conv_base(sd: dict, prefix: str = "") -> list:
    """ConvBase state_dict (keys ``{prefix}<i>.conv.*`` /
    ``{prefix}<i>.normalize.*``) -> the port's block list."""
    blocks = []
    for i in range(64):  # blocks are contiguous from 0
        kc = f"{prefix}{i}.conv.weight"
        if kc not in sd:
            break
        blocks.append({
            "conv": {"w": _conv_w(sd[kc]),
                     "b": _copy(sd[f"{prefix}{i}.conv.bias"])},
            "bn": {"scale": _copy(sd[f"{prefix}{i}.normalize.weight"]),
                   "bias": _copy(sd[f"{prefix}{i}.normalize.bias"])},
        })
    if not blocks:
        raise ValueError(
            f"no ConvBase blocks under prefix {prefix!r}: keys={list(sd)[:8]}")
    return blocks


def import_cnn4(sd: dict, spec) -> dict:
    """OmniglotCNN / MiniImagenetCNN state_dict -> ``init_cnn4``-shaped
    params."""
    sd = strip_maml_prefix(sd)
    base = import_conv_base(sd, prefix="base.")
    w, b = sd["linear.weight"], sd["linear.bias"]
    if spec.global_pool:  # Omniglot head: [ways, hidden] on pooled feats
        head_w = _t(w)
    else:  # flattened NCHW features
        spatial = int(round((spec.head_in / spec.hidden) ** 0.5))
        head_w = _flat_head_w(w, spec.hidden, spatial)
    return {"base": base, "head": {"w": head_w, "b": _copy(b)}}


def import_anil_vision(features_sd: dict, head_sd: dict, spec) -> dict:
    """ANIL-vision ``features.pt`` (Sequential(ConvBase, Lambda): keys
    ``0.<i>.*``) + ``head.pt`` (possibly MAML-wrapped Linear) -> CNN4
    params."""
    features_sd = strip_maml_prefix(features_sd)
    head_sd = strip_maml_prefix(head_sd)
    prefix = "0." if any(k.startswith("0.0.") for k in features_sd) else ""
    base = import_conv_base(features_sd, prefix=prefix)
    spatial = int(round((spec.head_in / spec.hidden) ** 0.5))
    return {"base": base,
            "head": {"w": _flat_head_w(head_sd["weight"], spec.hidden,
                                       spatial),
                     "b": _copy(head_sd["bias"])}}


# ---------------------------------------------------------------------------
# RL policies
# ---------------------------------------------------------------------------

def _import_mlp(sd: dict, prefix: str) -> list:
    """nn.Sequential of Linear(+activation) -> the port's layer list."""
    idxs = sorted({int(m.group(1)) for k in sd
                   if (m := re.match(rf"{re.escape(prefix)}(\d+)\.weight$",
                                     k))})
    layers = [{"w": _t(sd[f"{prefix}{i}.weight"]),
               "b": _copy(sd[f"{prefix}{i}.bias"])} for i in idxs]
    if not layers:
        raise ValueError(f"no Linear layers under prefix {prefix!r}")
    return layers


def import_diag_policy(sd: dict) -> dict:
    """DiagNormalPolicy state_dict (``mean.<i>.*`` + ``sigma``) -> params."""
    sd = strip_maml_prefix(sd)
    return {"mean": _import_mlp(sd, "mean."), "sigma": _copy(sd["sigma"])}


def import_anil_policy(body_sd: dict, head_sd: dict) -> dict:
    """The ANIL policy from its split body / head checkpoints. ``sigma``
    resets to log(1) = 0, as the reference's eval driver does (it loads
    only body and head into a freshly built policy)."""
    body_sd = strip_maml_prefix(body_sd)
    head_sd = strip_maml_prefix(head_sd)
    out = head_sd["bias"].shape[0]
    return {"body": _import_mlp(body_sd, ""),
            "head": {"w": _t(head_sd["weight"]),
                     "b": _copy(head_sd["bias"])},
            "sigma": torch.zeros(out, dtype=torch.float32)}


# ---------------------------------------------------------------------------
# whole-run-dir import
# ---------------------------------------------------------------------------

def _vision_spec(config: dict, anil: bool):
    from exploring_meta_tpu_torch.models import cnn4
    ways = config["ways"]
    if config["dataset"] == "omni":
        return (cnn4.anil_omniglot_spec(ways) if anil
                else cnn4.omniglot_spec(ways))
    return (cnn4.anil_mini_imagenet_spec(ways) if anil
            else cnn4.mini_imagenet_spec(ways))


def _detect_kind(config: dict, src: str) -> str:
    anil = config.get("algo", "").startswith("anil")
    is_vision = (config.get("dataset") in ("omni", "min")
                 or os.path.exists(os.path.join(src, "features.pt"))
                 or "ways" in config)
    if is_vision:
        return "anil_vision" if anil else "maml_vision"
    return "anil_rl" if anil else "maml_rl"


def _import_params(kind: str, spec, paths: dict):
    if kind == "maml_vision":
        return import_cnn4(load_state_dict(paths["model"]), spec)
    if kind == "anil_vision":
        return import_anil_vision(load_state_dict(paths["features"]),
                                  load_state_dict(paths["head"]), spec)
    if kind == "maml_rl":
        return import_diag_policy(load_state_dict(paths["model"]))
    return import_anil_policy(load_state_dict(paths["body"]),
                              load_state_dict(paths["head"]))


_FINAL = {"maml_vision": {"model": "model.pt"},
          "anil_vision": {"features": "features.pt", "head": "head.pt"},
          "maml_rl": {"model": "model.pt"},
          "anil_rl": {"body": "body.pt", "head": "head.pt"}}


def import_reference_run(src: str, dst: str, kind: str | None = None) -> str:
    """Convert a reference run dir (``logger.json`` + ``*.pt`` +
    ``model_checkpoints/``) into a run dir of the port's contract
    (``logger.json`` + ``model.npz`` + ``model_checkpoints/*.npz``) that
    evaluation and serving read unchanged -> ``dst``. ``kind`` (one of
    ``maml_vision``, ``anil_vision``, ``maml_rl``, ``anil_rl``) is read
    from ``logger.json`` when omitted."""
    from exploring_meta_tpu_torch.utils.experiment import flatten_params

    with open(os.path.join(src, "logger.json")) as f:
        logger = json.load(f)
    config = dict(logger.get("config", logger))
    kind = kind or _detect_kind(config, src)
    anil = kind.startswith("anil")
    spec = _vision_spec(config, anil) if kind.endswith("vision") else None

    os.makedirs(os.path.join(dst, "model_checkpoints"), exist_ok=True)

    def save(params, path):
        np.savez(path, **flatten_params(params))

    paths = {k: os.path.join(src, v) for k, v in _FINAL[kind].items()}
    if all(os.path.exists(p) for p in paths.values()):
        save(_import_params(kind, spec, paths),
             os.path.join(dst, "model.npz"))

    # checkpoints: model_<iter>.pt (MAML) / split files (ANIL)
    ckdir = os.path.join(src, "model_checkpoints")
    n_ckpts = 0
    if os.path.isdir(ckdir):
        if kind in ("maml_vision", "maml_rl"):
            for p in glob.glob(os.path.join(ckdir, "model_*.pt")):
                m = re.match(r"model_(\d+)\.pt$", os.path.basename(p))
                if not m:
                    continue
                save(_import_params(kind, spec, {"model": p}),
                     os.path.join(dst, "model_checkpoints",
                                  f"model_{m.group(1)}.npz"))
                n_ckpts += 1
        else:
            first, second = (("features", "head") if kind == "anil_vision"
                             else ("body", "head"))
            for p in glob.glob(os.path.join(ckdir, f"model_{first}_*.pt")):
                m = re.match(rf"model_{first}_(\d+)\.pt$",
                             os.path.basename(p))
                if not m:
                    continue
                it = m.group(1)
                q = os.path.join(ckdir, f"model_{second}_{it}.pt")
                if not os.path.exists(q):
                    continue
                save(_import_params(kind, spec, {first: p, second: q}),
                     os.path.join(dst, "model_checkpoints",
                                  f"model_{it}.npz"))
                n_ckpts += 1

    config.setdefault("imported_from", os.path.abspath(src))
    with open(os.path.join(dst, "logger.json"), "w") as f:
        json.dump({"config": config,
                   "date": logger.get("date", ""),
                   "model_id": logger.get("model_id", "imported")},
                  f, sort_keys=True, indent=4)
    # metrics.json is copied when present (the plotters read it)
    srcm = os.path.join(src, "metrics.json")
    if os.path.exists(srcm):
        with open(srcm) as f:
            metrics = json.load(f)
        with open(os.path.join(dst, "metrics.json"), "w") as f:
            json.dump(metrics, f)
    print(f"imported kind={kind} -> {dst} ({n_ckpts} checkpoints)")
    return dst
