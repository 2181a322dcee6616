"""Parameter initializers with torch-parity semantics (port of
``exploring_meta_tpu/models/init.py``).

The same distributions as the JAX package: xavier-uniform with torch fan
rules, N(0,1) heads, U(0,1) BatchNorm scales, truncated normal on
[-2, 2]. Every draw comes from an explicit ``torch.Generator``; the
tensors are drawn on the generator's device and then moved to ``device``
(default: the generator's device).
"""

from __future__ import annotations

import math

import torch


def _uniform(gen, shape, lo, hi, dtype, device):
    u = torch.rand(shape, generator=gen, dtype=dtype, device=gen.device)
    return (lo + (hi - lo) * u).to(device or gen.device)


def xavier_uniform(gen, shape, fan_in: int, fan_out: int, gain: float = 1.0,
                   dtype=torch.float32, device=None) -> torch.Tensor:
    """torch ``nn.init.xavier_uniform_``: U(-a, a), a = gain*sqrt(6/(fi+fo))."""
    a = gain * math.sqrt(6.0 / (fan_in + fan_out))
    return _uniform(gen, shape, -a, a, dtype, device)


def truncated_normal(gen, shape, mean: float = 0.0, std: float = 1.0,
                     dtype=torch.float32, device=None) -> torch.Tensor:
    """Standard normal truncated to [-2, 2], then scaled and shifted."""
    t = torch.empty(shape, dtype=dtype, device=gen.device)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return (mean + std * t).to(device or gen.device)


def linear_params(gen, in_dim: int, out_dim: int, init: str = "xavier",
                  dtype=torch.float32, device=None) -> dict:
    """Dense layer params ``{"w": [in, out], "b": [out]}``; ``init`` is
    ``"xavier"``, ``"normal"``, ``"trunc"`` or ``"torch_default"`` as in
    the JAX package."""
    dev = device or gen.device
    shape = (in_dim, out_dim)
    if init == "xavier":
        w = xavier_uniform(gen, shape, in_dim, out_dim, dtype=dtype, device=dev)
    elif init == "normal":
        w = torch.randn(shape, generator=gen, dtype=dtype,
                        device=gen.device).to(dev)
    elif init == "trunc":
        w = truncated_normal(gen, shape, std=0.01, dtype=dtype, device=dev)
    elif init == "torch_default":
        bound = math.sqrt(1.0 / in_dim)
        w = _uniform(gen, shape, -bound, bound, dtype, dev)
        b = _uniform(gen, (out_dim,), -bound, bound, dtype, dev)
        return {"w": w, "b": b}
    else:
        raise ValueError(f"unknown init {init!r}")
    return {"w": w, "b": torch.zeros(out_dim, dtype=dtype, device=dev)}


def conv_params(gen, k: int, in_ch: int, out_ch: int, dtype=torch.float32,
                device=None) -> dict:
    """``{"w": [k, k, in, out] (HWIO), "b": [out]}``: xavier-uniform weight
    with torch fan rules (fan_in = in*k*k, fan_out = out*k*k), zero bias."""
    dev = device or gen.device
    w = xavier_uniform(gen, (k, k, in_ch, out_ch), in_ch * k * k,
                       out_ch * k * k, dtype=dtype, device=dev)
    return {"w": w, "b": torch.zeros(out_ch, dtype=dtype, device=dev)}


def batchnorm_params(gen, ch: int, dtype=torch.float32, device=None) -> dict:
    """Affine BN params: scale ~ U(0, 1), zero shift."""
    dev = device or gen.device
    return {"scale": _uniform(gen, (ch,), 0.0, 1.0, dtype, dev),
            "bias": torch.zeros(ch, dtype=dtype, device=dev)}
