"""Reverse GAE / discount sweeps: CUDA kernels, their plain twins, autograd.

Port of ``exploring_meta_tpu/pallas/gae_pallas.py`` (rows 5-6 of the
TPU-kernel table in PERF.md). Two kernels in ``csrc/gae.cu``:

- ``gae_sweep``       ``a_t = (r_t + g(1-d_t)V_{t+1} - V_t) + g*tau(1-d_t)a_{t+1}``
  with ``V_T = 0`` (``gae_pallas``);
- ``discount_sweep``  ``R_t = r_t + g(1-d_t)R_{t+1}``, zero bootstrap
  (``discount_pallas``).

Inputs are ``[T]``, ``[T, E]`` or a task batch ``[B, T, E]``: time is
axis 0, or axis 1 when there is a task axis. The kernels see the
contiguous float32 view ``[G, T, L]`` (:func:`sweep_view`), so no permute
or pad is made.

The wrappers :func:`gae_sweep` and :func:`discount_sweep` run the plain
twins for CPU tensors and launch the kernels for CUDA tensors; there is no
other path. Each counts its kernel launches in ``<wrapper>.launches``. The
gradient is the VJP of the plain formulation, as the JAX ``custom_vjp``
reruns its XLA version (``gae_pallas.py:134-138``); JAX has no backward
kernel.
"""

from __future__ import annotations

import ctypes

import torch
from torch.autograd.function import once_differentiable

_THREADS = 64          # kThreads in csrc/gae.cu
_SOURCE = "gae.cu"
_lib = None


def sweep_view(x: torch.Tensor) -> torch.Tensor:
    """``[T]``, ``[T, E]`` or ``[B, T, E]`` -> the ``[G, T, L]`` view."""
    if x.ndim == 1:
        return x.reshape(1, -1, 1)
    if x.ndim == 2:
        return x.unsqueeze(0)
    if x.ndim == 3:
        return x
    raise ValueError(f"GAE sweeps take [T], [T, E] or [B, T, E], got "
                     f"{tuple(x.shape)}")


# ---------------------------------------------------------------------------
# plain PyTorch twins (CPU path; the card-side reference in chip_smoke.py),
# reverse loops over t mirroring ops/gae.py's scans
# ---------------------------------------------------------------------------

def discount_plain(gamma: float, rewards, dones, bootstrap=0.0):
    """``R_t = r_t + gamma (1 - d_t) R_{t+1}``, ``R_T = bootstrap`` (a
    scalar or a tensor of the shape without the time axis)."""
    r, d = sweep_view(rewards), sweep_view(dones).to(rewards.dtype)
    carry = torch.as_tensor(bootstrap, dtype=r.dtype, device=r.device)
    carry = carry.reshape(-1, r.shape[2]) if carry.ndim else carry
    out = [None] * r.shape[1]
    for t in reversed(range(r.shape[1])):
        carry = r[:, t] + gamma * carry * (1.0 - d[:, t])
        out[t] = carry
    return torch.stack(out, dim=1).reshape(rewards.shape)


def gae_plain(gamma: float, tau: float, rewards, dones, values):
    """GAE(gamma, tau) with terminal next-value 0: the TD errors, then
    their ``gamma * tau`` discount, in one reverse loop."""
    r, v = sweep_view(rewards), sweep_view(values)
    d = sweep_view(dones).to(rewards.dtype)
    gtau = gamma * tau
    carry = torch.zeros_like(r[:, 0])
    v_next = torch.zeros_like(v[:, 0])
    out = [None] * r.shape[1]
    for t in reversed(range(r.shape[1])):
        not_done = 1.0 - d[:, t]
        td = r[:, t] + gamma * not_done * v_next - v[:, t]
        carry = td + gtau * carry * not_done
        out[t] = carry
        v_next = v[:, t]
    return torch.stack(out, dim=1).reshape(rewards.shape)


# ---------------------------------------------------------------------------
# kernel launches
# ---------------------------------------------------------------------------

def _load():
    global _lib
    if _lib is None:
        from exploring_meta_tpu_torch.cuda import build
        lib = build.load(_SOURCE)
        P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.gae_sweep.argtypes = [P] * 4 + [I] * 3 + [F, F, P]
        lib.discount_sweep.argtypes = [P] * 3 + [I] * 3 + [F, P]
        lib.gae_sweep.restype = ctypes.c_int
        lib.discount_sweep.restype = ctypes.c_int
        _lib = lib
    return _lib


def _on_cpu(*ts: torch.Tensor) -> bool:
    dev = ts[0].device
    if any(t.device != dev for t in ts):
        raise ValueError("GAE sweep: every tensor must be on one device")
    if dev.type == "cpu":
        return True
    if dev.type != "cuda":
        raise RuntimeError(f"GAE sweep: unsupported device {dev}")
    return False


def _check(*ts: torch.Tensor):
    """Raise on anything the kernels do not take; -> (G, T, L)."""
    shape = ts[0].shape
    for t in ts:
        if t.shape != shape:
            raise ValueError(f"GAE sweep: shapes differ, {tuple(t.shape)} "
                             f"vs {tuple(shape)}")
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError("GAE sweep kernels take contiguous float32 "
                             f"tensors, got {t.dtype}")
    G, T, L = sweep_view(ts[0]).shape
    if G * L > 2 ** 31 - 1 or T * L > 2 ** 31 - 1:
        raise ValueError(f"GAE sweep: [{G}, {T}, {L}] is too large")
    return G, T, L


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _launch_gae(gamma, tau, r, d, v) -> torch.Tensor:
    G, T, L = _check(r, d, v)
    out = torch.empty_like(r)
    with torch.cuda.device(r.device):
        err = _load().gae_sweep(r.data_ptr(), d.data_ptr(), v.data_ptr(),
                                out.data_ptr(), G, T, L, gamma, gamma * tau,
                                _stream(r))
    _raise_on(err, "gae_sweep")
    gae_sweep.launches += 1
    return out


def _launch_discount(gamma, r, d) -> torch.Tensor:
    G, T, L = _check(r, d)
    out = torch.empty_like(r)
    with torch.cuda.device(r.device):
        err = _load().discount_sweep(r.data_ptr(), d.data_ptr(),
                                     out.data_ptr(), G, T, L, gamma,
                                     _stream(r))
    _raise_on(err, "discount_sweep")
    discount_sweep.launches += 1
    return out


# ---------------------------------------------------------------------------
# autograd: the kernels forward, the plain formulation's VJP backward
# ---------------------------------------------------------------------------

def _plain_vjp(fn, inputs, needs, g):
    with torch.enable_grad():
        ins = [x.detach().requires_grad_(n) for x, n in zip(inputs, needs)]
        wrt = [x for x in ins if x.requires_grad]
        grads = iter(torch.autograd.grad(fn(*ins), wrt, g))
    return [next(grads) if n else None for n in needs]


class _GAESweep(torch.autograd.Function):
    @staticmethod
    def forward(ctx, r, d, v, gamma, tau):
        ctx.save_for_backward(r, d, v)
        ctx.gamma, ctx.tau = gamma, tau
        return _launch_gae(gamma, tau, r, d, v)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        fn = lambda r, d, v: gae_plain(ctx.gamma, ctx.tau, r, d, v)
        return (*_plain_vjp(fn, ctx.saved_tensors, ctx.needs_input_grad[:3],
                            g), None, None)


class _DiscountSweep(torch.autograd.Function):
    @staticmethod
    def forward(ctx, r, d, gamma):
        ctx.save_for_backward(r, d)
        ctx.gamma = gamma
        return _launch_discount(gamma, r, d)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        fn = lambda r, d: discount_plain(ctx.gamma, r, d)
        return (*_plain_vjp(fn, ctx.saved_tensors, ctx.needs_input_grad[:2],
                            g), None)


def gae_sweep(gamma: float, tau: float, rewards, dones, values):
    """GAE(gamma, tau) with terminal next-value 0 -> rewards' shape."""
    if _on_cpu(rewards, dones, values):
        return gae_plain(gamma, tau, rewards, dones, values)
    return _GAESweep.apply(rewards, dones, values, float(gamma), float(tau))


def discount_sweep(gamma: float, rewards, dones):
    """Discounted returns with zero bootstrap -> rewards' shape."""
    if _on_cpu(rewards, dones):
        return discount_plain(gamma, rewards, dones)
    return _DiscountSweep.apply(rewards, dones, float(gamma))


gae_sweep.launches = 0
discount_sweep.launches = 0

KERNELS = {"gae_sweep": gae_sweep, "discount_sweep": discount_sweep}


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0
