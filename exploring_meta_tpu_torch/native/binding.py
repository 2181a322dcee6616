"""ctypes binding of the native env-stepping service ``vecenv.cpp`` (port
of ``exploring_meta_tpu/native/binding.py``; the source is a byte-identical
copy of the JAX package's).

The library is built with ``g++`` at first use into ``build/`` beside the
package (``cuda/build.py:BUILD_DIR``, which ``--compile_cache`` moves), not
beside the source: its name carries a hash of the source, and it is
compiled to a private temporary name and renamed into place, so
processes that build at once never load a half-written library. Without
``g++`` (or on a failed build) :func:`load_vecenv_library` prints one line
and returns ``None``; a caller that asked for the native backend raises.

The boundary is a plain C ABI with numpy buffers passed by pointer: one
crossing per batched step. Every shape is checked in Python before a
pointer reaches C, which would otherwise read out of bounds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import sys
import threading

import numpy as np

from exploring_meta_tpu_torch.cuda import build as _build

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "vecenv.cpp")
_LIB_CACHE: dict = {}
_LOCK = threading.Lock()

_c_double_p = ctypes.POINTER(ctypes.c_double)
# indexed per-env callbacks of Python-backed physics (vecenv.cpp
# py_reset_fn / py_step_fn)
RESET_CB = ctypes.CFUNCTYPE(None, ctypes.c_int, _c_double_p, _c_double_p)
STEP_CB = ctypes.CFUNCTYPE(None, ctypes.c_int, _c_double_p, _c_double_p,
                           _c_double_p, _c_double_p, _c_double_p)


def effective_cpus() -> int:
    """The CPUs this process may run on (``os.sched_getaffinity``), not
    the machine's count: a container or ``taskset`` may grant fewer."""
    return len(os.sched_getaffinity(0))


def library_path() -> str:
    with open(SRC, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    return os.path.join(_build.BUILD_DIR, f"libvecenv_{digest}.so")


def _declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.vecenv_create_particles2d.restype = ctypes.c_void_p
    lib.vecenv_create_particles2d.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.vecenv_destroy.restype = None
    lib.vecenv_destroy.argtypes = [ctypes.c_void_p]
    lib.vecenv_obs_size.argtypes = [ctypes.c_void_p]
    lib.vecenv_obs_size.restype = ctypes.c_int
    lib.vecenv_action_size.argtypes = [ctypes.c_void_p]
    lib.vecenv_action_size.restype = ctypes.c_int
    lib.vecenv_reset.restype = None
    lib.vecenv_reset.argtypes = [ctypes.c_void_p, _c_double_p, ctypes.c_int,
                                 ctypes.c_int, _c_double_p]
    lib.vecenv_step.restype = None
    lib.vecenv_step.argtypes = [ctypes.c_void_p] + [_c_double_p] * 5
    lib.vecenv_create_python.restype = ctypes.c_void_p
    lib.vecenv_create_python.argtypes = [RESET_CB, STEP_CB, ctypes.c_int,
                                         ctypes.c_int, ctypes.c_int,
                                         ctypes.c_int]
    lib.vecenv_create_busy.restype = ctypes.c_void_p
    lib.vecenv_create_busy.argtypes = [ctypes.c_int, ctypes.c_int,
                                       ctypes.c_double, ctypes.c_int]
    return lib


def load_vecenv_library() -> ctypes.CDLL | None:
    """Compile (if needed) and load the native library, once per process;
    ``None`` after one printed line when it cannot be built."""
    path = library_path()
    with _LOCK:
        if path in _LIB_CACHE:
            return _LIB_CACHE[path]
        if not os.path.exists(path):
            tmp = f"{path}.tmp.{os.getpid()}"
            try:
                os.makedirs(os.path.dirname(path), exist_ok=True)
                subprocess.run(
                    ["g++", "-O3", "-march=native", "-shared", "-fPIC",
                     "-std=c++17", "-pthread", SRC, "-o", tmp],
                    check=True, capture_output=True)
                os.replace(tmp, path)
            except (subprocess.CalledProcessError, OSError) as e:
                print(f"native vecenv unavailable ({e}); using Python paths",
                      file=sys.stderr)
                if os.path.exists(tmp):
                    os.remove(tmp)
                _LIB_CACHE[path] = None
                return None
        _LIB_CACHE[path] = _declare(ctypes.CDLL(path))
        return _LIB_CACHE[path]


def native_available() -> bool:
    return load_vecenv_library() is not None


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(_c_double_p)


def _required_library() -> ctypes.CDLL:
    lib = load_vecenv_library()
    if lib is None:
        raise RuntimeError("native vecenv library unavailable")
    return lib


class _Pool:
    """The shared part of the two handles: the C pool ``_h``, its step
    buffers, and its release."""

    def __del__(self):
        if getattr(self, "_h", None) and self._lib is not None:
            self._lib.vecenv_destroy(self._h)
            self._h = None

    def _step(self, actions: np.ndarray):
        actions = np.ascontiguousarray(actions, np.float64)
        # the native side reads actions + i * action_size for every env
        if actions.shape != (self.n_envs, self.action_size):
            raise ValueError(f"actions must be [{self.n_envs}, "
                             f"{self.action_size}], got {actions.shape}")
        bufs = (actions, np.empty((self.n_envs, self.obs_size), np.float64),
                *(np.empty(self.n_envs, np.float64) for _ in range(3)))
        # the batch's arrays, for Python callbacks to index (PythonEnvPool)
        self._batch = bufs
        self._lib.vecenv_step(self._h, *(_ptr(b) for b in bufs))
        return bufs[1:]


class NativeVecEnv(_Pool):
    """Handle of the C++ thread-pool stepper over an env implemented
    natively: ``"particles2d"`` (bit-compatible with the device
    Particles2D) or ``"busy"`` (a synthetic env whose step costs
    ``busy_us`` microseconds on the C side, sleeping or, with
    ``busy_spin``, spinning). A batched step is one ctypes call."""

    def __init__(self, env_type: str = "particles2d", n_envs: int = 16,
                 n_threads: int | None = None, busy_us: float = 0.0,
                 busy_spin: bool = False):
        self._lib = _required_library()
        threads = (n_threads if n_threads is not None
                   else min(n_envs, effective_cpus()))
        if env_type == "particles2d":
            self._h = self._lib.vecenv_create_particles2d(n_envs, threads)
        elif env_type == "busy":
            self._h = self._lib.vecenv_create_busy(n_envs, threads,
                                                   float(busy_us),
                                                   int(busy_spin))
        else:
            raise ValueError(f"unknown native env {env_type!r}")
        self.n_envs = n_envs
        self.obs_size = self._lib.vecenv_obs_size(self._h)
        self.action_size = self._lib.vecenv_action_size(self._h)

    def reset(self, tasks: np.ndarray) -> np.ndarray:
        tasks = np.ascontiguousarray(tasks, np.float64)
        if tasks.ndim == 1:
            tasks = tasks[None]
        # the native side reads tasks[i] for every env unless one row
        # broadcasts
        if tasks.shape[0] not in (1, self.n_envs):
            raise ValueError(f"tasks rows must be 1 or n_envs "
                             f"({self.n_envs}), got {tasks.shape[0]}")
        if tasks.shape[1] != 2:  # the particles2d goal
            raise ValueError(f"particles2d tasks need dim 2, "
                             f"got {tasks.shape[1]}")
        obs = np.empty((self.n_envs, self.obs_size), np.float64)
        self._lib.vecenv_reset(self._h, _ptr(tasks), tasks.shape[0],
                               tasks.shape[1], _ptr(obs))
        return obs

    def step(self, actions: np.ndarray):
        """-> ``(obs [E, obs], reward [E], done [E], success [E])``,
        float64."""
        return self._step(actions)


class PythonEnvPool(_Pool):
    """The C++ thread pool stepping Python env objects (MuJoCo,
    Meta-World): the batch fan-out, the worker threads and the completion
    barrier live in C++ (``vecenv_create_python``), and each env's step
    re-enters Python through a ctypes callback on a pool thread. Only the
    env's own (numpy) ``reset`` / ``step`` run there, never torch. MuJoCo
    releases the GIL inside ``mj_step``, so steps overlap across threads.

    Envs follow the host-env protocol of ``envs/host.py``: ``reset(seed=)
    -> obs`` and ``step(a) -> (obs, reward, done, truncated, success)``.
    An exception inside a callback is kept and raised by the call that ran
    the batch (ctypes would otherwise print and drop it)."""

    def __init__(self, envs: list, n_threads: int | None = None):
        self._lib = _required_library()
        self.envs = envs
        self.n_envs = len(envs)
        self.obs_size = int(envs[0].obs_size)
        self.action_size = int(envs[0].action_size)
        self._reset_seed = None
        self._error = None

        def _reset_cb(i, task_ptr, obs_ptr):
            try:
                # per-slot seeds (gym AsyncVectorEnv): a shared seed would
                # put every slot's np_random in lockstep
                s = None if self._reset_seed is None else self._reset_seed + i
                obs = np.ascontiguousarray(self.envs[i].reset(seed=s),
                                           np.float64)
                if obs.size != self.obs_size:  # memmove would read OOB
                    raise ValueError(f"env {i} reset obs size {obs.size} "
                                     f"!= {self.obs_size}")
                ctypes.memmove(obs_ptr, obs.ctypes.data, 8 * self.obs_size)
            except BaseException as exc:  # ctypes would drop it: _check
                self._error = exc               # raises it

        def _step_cb(i, act_ptr, obs_ptr, rew_ptr, done_ptr, suc_ptr):
            # The pointers are row i of the batch's arrays (_step passed
            # them), so the callback indexes the arrays: wrapping each
            # pointer in a numpy view costs more than the step of a light
            # env, and the callback holds the GIL throughout.
            try:
                actions, obs_b, rew_b, done_b, suc_b = self._batch
                obs, rew, done, _trunc, suc = self.envs[i].step(actions[i])
                obs = np.asarray(obs, np.float64).reshape(-1)
                if obs.size != self.obs_size:
                    raise ValueError(f"env {i} step obs size {obs.size} "
                                     f"!= {self.obs_size}")
                obs_b[i] = obs
                rew_b[i] = float(rew)
                done_b[i] = 1.0 if done else 0.0
                suc_b[i] = float(suc)
            except BaseException as exc:  # ctypes would drop it: _check
                self._error = exc               # raises it

        # the CFUNCTYPE wrappers live as long as the pool: C++ holds their
        # raw pointers
        self._reset_cb = RESET_CB(_reset_cb)
        self._step_cb = STEP_CB(_step_cb)
        threads = (n_threads if n_threads is not None
                   else min(self.n_envs, effective_cpus()))
        self._h = self._lib.vecenv_create_python(
            self._reset_cb, self._step_cb, self.obs_size, self.action_size,
            self.n_envs, threads)

    def _check(self):
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def reset(self, seed: int | None = None) -> np.ndarray:
        """Reset every slot (slot i with ``seed + i``) -> obs ``[E, obs]``
        float64; tasks are set on the Python envs."""
        self._reset_seed = seed
        dummy = np.zeros((1, 1), np.float64)
        obs = np.empty((self.n_envs, self.obs_size), np.float64)
        self._lib.vecenv_reset(self._h, _ptr(dummy), 1, 1, _ptr(obs))
        self._check()
        return obs

    def step(self, actions: np.ndarray):
        """-> ``(obs, reward, done, success)`` as :meth:`NativeVecEnv.step`."""
        out = self._step(actions)
        self._check()
        return out
