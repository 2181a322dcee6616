"""RL policies (port of ``exploring_meta_tpu/models/policies.py``;
reference ``core_functions/policies.py``).

``DiagNormalPolicy`` params are the JAX tree ``{"mean": [{"w": [in,
out], "b": [out]}, ...], "sigma": [act]}``: a relu (or tanh) MLP for the
mean and a learned, state-independent log-sigma clamped at ``log(1e-6)``.
``DiagNormalPolicyANIL`` splits the mean into a tanh ``body`` and a linear
``head`` (``{"body": [...], "head": {...}, "sigma": [act]}``).
``DiagNormalPolicyCNN`` and ``BaselineCNN`` read ``[N, 64, 64, C]``
pixels through conv blocks (``{"features": [{"conv", "bn"}, ...]}``, each
a stride-1 conv, batch-stat BN, ReLU and a 2x2 max-pool, as
``layers.conv2d`` lowers it in JAX: ``F.conv2d``, no kernel of the port),
with a ``mean`` (plus ``sigma``) or ``head`` linear layer on the flattened
NHWC features. ``CategoricalPolicy`` is a relu MLP from one-hot integer
states to logits (``{"mean": [...]}``). Per-task params carry a leading
``[B]`` on every leaf; with them the state is ``[B, N, ...]`` and the
layers run per task (a batched matmul, a grouped conv, BN statistics per
task).

``log_prob`` keeps the reference's quirk of *averaging* (not summing) the
per-dimension log density over the action axis (``policies.py:54-56``).

Mixed precision (``--bf16`` on the RL trainers): each spec carries a
``compute_dtype``; ``policy._replace(compute_dtype="bf16")`` runs the MLP
(for ANIL, the body and the head) on bfloat16 copies of the float32 master
params and the bfloat16-cast state. ``loc`` is cast back to float32 and
``sigma`` stays float32, so the advantages, KL, CG and line search keep
full precision; autograd transposes the casts, so the gradients reach the
float32 leaves as float32.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from exploring_meta_tpu_torch.models import distributions as dist
from exploring_meta_tpu_torch.models import init as pinit
from exploring_meta_tpu_torch.models.layers import (
    batch_norm, conv2d, linear, max_pool2d, mlp_apply, task_param,
)
from exploring_meta_tpu_torch.ops.stats import onehot
from exploring_meta_tpu_torch.utils.tree import tree_map

EPSILON = 1e-6
MIN_LOG_SIGMA = math.log(EPSILON)


def relu(x: torch.Tensor) -> torch.Tensor:
    """``max(x, 0)`` as the JAX package writes it (``jnp.maximum``): at a
    tie ``x == 0`` its gradient is 1/2, where ``torch.relu``'s is 0. Ties
    are common here: every episode starts at the origin and the biases
    start at zero, so the first steps' pre-activations are exactly 0."""
    return torch.maximum(x, x.new_zeros(()))


def _sigma(params) -> torch.Tensor:
    """``exp(clamp(sigma, min=log 1e-6))``, viewed to broadcast against
    ``[B, N, act]`` when it is per task."""
    return torch.exp(torch.clamp(task_param(params["sigma"], 1, 1),
                                 min=MIN_LOG_SIGMA))


def _compute_cast(compute_dtype: str, params, x):
    """``(params, input)`` in the policy's compute dtype: bfloat16 copies
    when ``compute_dtype == "bf16"``, as they are otherwise."""
    if compute_dtype == "bf16":
        return (tree_map(lambda t: t.to(torch.bfloat16), params),
                x.to(torch.bfloat16))
    return params, x


def _init_mlp(gen, sizes, device) -> list:
    return [pinit.linear_params(gen, i, o, init="xavier", device=device)
            for i, o in zip(sizes[:-1], sizes[1:])]


def _module_sliced_rep(layer_params, act, x, layer: int,
                       trailing_act: bool):
    """The reference's ``get_representation``: walk the torch Sequential's
    modules (Linear and activation modules counted separately) and apply
    ``modules[1:layer]``, the first ``layer - 1`` of them; ``layer == -1``
    applies all but the last. ``trailing_act``: the Sequential ends with
    an activation (the ANIL body), not a Linear (the mean net)."""
    mods: list = []
    n = len(layer_params)
    for i, p in enumerate(layer_params):
        mods.append(p)
        if i < n - 1 or trailing_act:
            mods.append(None)  # activation module
    sel = mods[:-1] if layer == -1 else mods[:max(layer - 1, 0)]
    for m in sel:
        x = linear(m, x) if m is not None else act(x)
    return x


def _mean_log_prob(loc, scale, action) -> torch.Tensor:
    return dist.normal_log_prob(loc, scale, action).mean(dim=-1, keepdim=True)


class DiagNormalPolicy(NamedTuple):
    """Static spec; params are a separate tree."""
    input_size: int
    output_size: int
    hiddens: tuple = (100, 100)
    activation: str = "relu"
    compute_dtype: str = "f32"   # "bf16": the MLP in bfloat16

    def init(self, gen: torch.Generator, device=None) -> dict:
        """Xavier-uniform weights, zero biases, ``sigma = 0`` (torch
        ``fill_(log 1)``)."""
        sizes = (self.input_size,) + tuple(self.hiddens) + (self.output_size,)
        dev = device or gen.device
        return {"mean": _init_mlp(gen, sizes, dev),
                "sigma": torch.zeros(self.output_size, device=dev)}

    def _act(self):
        return torch.tanh if self.activation == "tanh" else relu

    def density(self, params, state):
        """-> (loc, scale) of the diagonal Gaussian, both ``[..., act]``,
        float32."""
        mean_p, state = _compute_cast(self.compute_dtype, params["mean"],
                                      state)
        loc = mlp_apply(mean_p, state, self._act()).float()
        return loc, _sigma(params).expand(loc.shape)

    def log_prob(self, params, state, action) -> torch.Tensor:
        """-> ``[..., 1]``: the mean over action dims of the log density."""
        return _mean_log_prob(*self.density(params, state), action)

    def sample(self, params, gen: torch.Generator, state) -> torch.Tensor:
        loc, scale = self.density(params, state)
        return dist.normal_sample(gen, loc, scale)

    def get_representation(self, params, x, layer: int = -1):
        """Activation tap with the reference's module-counted index
        (``policies.py:63-67``): 1 is the identity, 2 the first Linear's
        output, 3 adds its activation, ...; -1 applies all but the last
        Linear."""
        return _module_sliced_rep(params["mean"], self._act(), x, layer,
                                  trailing_act=False)


class DiagNormalPolicyANIL(NamedTuple):
    """Tanh body, linear head; the ANIL inner loop adapts the head and
    sigma on detached body features (``stop_body_grad``, the reference's
    ``turn_off_body_grads``, ``policies.py:94-106``)."""
    input_size: int
    output_size: int
    fc_neurons: int = 100
    hiddens: tuple = (100, 100)
    compute_dtype: str = "f32"   # "bf16": body and head in bfloat16

    def init(self, gen: torch.Generator, device=None) -> dict:
        """Xavier-uniform body and head, zero biases, ``sigma = 0``."""
        if self.fc_neurons != self.hiddens[-1]:
            # the reference's Linear(fc_neurons, out) head fails in the
            # first forward for any other width; fail at init instead
            raise ValueError(
                f"fc_neurons={self.fc_neurons} must equal the body's "
                f"output width hiddens[-1]={self.hiddens[-1]} "
                f"(pass hiddens=(100, fc_neurons))")
        dev = device or gen.device
        sizes = (self.input_size,) + tuple(self.hiddens)
        body = _init_mlp(gen, sizes, dev)
        return {"body": body,
                "head": pinit.linear_params(gen, self.fc_neurons,
                                            self.output_size, init="xavier",
                                            device=dev),
                "sigma": torch.zeros(self.output_size, device=dev)}

    def features(self, params, state):
        """Tanh body, an activation after every layer (reference
        ``:79-85``)."""
        body_p, x = _compute_cast(self.compute_dtype, params["body"], state)
        for p in body_p:
            x = torch.tanh(linear(p, x))
        return x

    def density(self, params, state, stop_body_grad: bool = False):
        """-> (loc, scale); ``stop_body_grad`` detaches the features."""
        feats = self.features(params, state)
        if stop_body_grad:
            feats = feats.detach()
        head_p, feats = _compute_cast(self.compute_dtype, params["head"],
                                      feats)
        loc = linear(head_p, feats).float()
        return loc, _sigma(params).expand(loc.shape)

    def log_prob(self, params, state, action,
                 stop_body_grad: bool = False) -> torch.Tensor:
        return _mean_log_prob(*self.density(params, state, stop_body_grad),
                              action)

    def sample(self, params, gen: torch.Generator, state) -> torch.Tensor:
        loc, scale = self.density(params, state)
        return dist.normal_sample(gen, loc, scale)

    def get_representation(self, params, x, layer: int = -1):
        """Module-counted tap over the body (reference ``:122-126``); the
        body ends with an activation, so -1 is the last hidden layer's
        pre-activation output."""
        return _module_sliced_rep(params["body"], torch.tanh, x, layer,
                                  trailing_act=True)


def _init_conv_blocks(gen, in_ch: int, network: tuple, device) -> list:
    blocks = []
    for out_ch in network:
        blocks.append({"conv": pinit.conv_params(gen, 3, in_ch, out_ch,
                                                 device=device),
                       "bn": pinit.batchnorm_params(gen, out_ch,
                                                    device=device)})
        in_ch = out_ch
    return blocks


def _conv_features(blocks, x) -> torch.Tensor:
    """Conv -> batch-stat BN -> ReLU -> 2x2 max-pool per block, then the
    NHWC features flattened: ``[..., N, H, W, C]`` -> ``[..., N, F]``."""
    for p in blocks:
        x = conv2d(p["conv"], x, stride=1, padding=1)
        x = max_pool2d(relu(batch_norm(p["bn"], x)), 2, 2)
    return x.reshape(x.shape[:-3] + (-1,))


def _flatten_size(network: tuple) -> int:
    final = int(64 / (2 ** len(network)))
    return network[-1] * final * final


class DiagNormalPolicyCNN(NamedTuple):
    """Conv Gaussian policy on ``[N, 64, 64, C]`` pixels (reference
    ``:129-193``)."""
    input_channels: int
    output_size: int
    network: tuple = (32, 64, 64)
    compute_dtype: str = "f32"   # "bf16": the convs and the mean layer

    @property
    def flatten_size(self) -> int:
        return _flatten_size(self.network)

    def init(self, gen: torch.Generator, device=None) -> dict:
        """Xavier-uniform convs and mean layer, U(0, 1) BN scales, zero
        biases, ``sigma = 0``."""
        dev = device or gen.device
        return {"features": _init_conv_blocks(gen, self.input_channels,
                                              self.network, dev),
                "mean": pinit.linear_params(gen, self.flatten_size,
                                            self.output_size, init="xavier",
                                            device=dev),
                "sigma": torch.zeros(self.output_size, device=dev)}

    def density(self, params, state):
        """-> (loc, scale), both ``[..., N, act]``, float32."""
        feat_p, x = _compute_cast(self.compute_dtype, params["features"],
                                  state)
        mean_p, feats = _compute_cast(self.compute_dtype, params["mean"],
                                      _conv_features(feat_p, x))
        loc = linear(mean_p, feats).float()
        return loc, _sigma(params).expand(loc.shape)

    def log_prob(self, params, state, action) -> torch.Tensor:
        return _mean_log_prob(*self.density(params, state), action)

    def sample(self, params, gen: torch.Generator, state) -> torch.Tensor:
        loc, scale = self.density(params, state)
        return dist.normal_sample(gen, loc, scale)


class BaselineCNN(NamedTuple):
    """Conv value network -> ``[..., N, 1]`` (reference ``:196-245``)."""
    input_channels: int
    network: tuple = (32, 64, 64)

    @property
    def flatten_size(self) -> int:
        return _flatten_size(self.network)

    def init(self, gen: torch.Generator, device=None) -> dict:
        dev = device or gen.device
        return {"features": _init_conv_blocks(gen, self.input_channels,
                                              self.network, dev),
                "head": pinit.linear_params(gen, self.flatten_size, 1,
                                            init="xavier", device=dev)}

    def apply(self, params, state) -> torch.Tensor:
        return linear(params["head"],
                      _conv_features(params["features"], state))


class CategoricalPolicy(NamedTuple):
    """Discrete policy over one-hot integer states (reference
    ``:248-268``)."""
    input_size: int
    output_size: int
    hiddens: tuple = (100, 100)

    def init(self, gen: torch.Generator, device=None) -> dict:
        sizes = (self.input_size,) + tuple(self.hiddens) + (self.output_size,)
        return {"mean": _init_mlp(gen, sizes, device or gen.device)}

    def logits(self, params, state) -> torch.Tensor:
        """Integer states ``[..., N]`` (any shape; flattened per task when
        the params are per task) -> logits ``[..., N, act]``."""
        w0 = params["mean"][0]["w"]
        lead = tuple(w0.shape[:-2])
        state = torch.as_tensor(state, device=w0.device)
        x = onehot(state, self.input_size).reshape(
            lead + (-1, self.input_size))
        return mlp_apply(params["mean"], x, relu)

    def sample(self, params, gen: torch.Generator, state):
        """-> (actions, ``{"log_prob"}``), the log-probs detached."""
        lg = self.logits(params, state)
        action = dist.categorical_sample(gen, lg)
        return action, {"log_prob": dist.categorical_log_prob(
            lg, action).detach()}

    def log_prob(self, params, state, action) -> torch.Tensor:
        return dist.categorical_log_prob(self.logits(params, state), action)
