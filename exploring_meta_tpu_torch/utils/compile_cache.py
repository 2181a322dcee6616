"""Where the port keeps its compiled kernels, ``--compile_cache`` (port of
``exploring_meta_tpu/utils/compile_cache.py``).

The port's only compile artifact is the ``nvcc`` build directory of its
CUDA sources (``cuda/build.py:BUILD_DIR``, ``build/`` beside the package).
A library there is named by a hash of its source, so a stale build is
never loaded and a cache directory can be shared between checkouts.

- a path moves the build directory, for every kernel this process has not
  loaded yet;
- ``None`` or ``""`` takes ``$EMT_COMPILE_CACHE`` when it is set, as JAX
  does; an explicit path wins over the environment variable;
- the strings "off", "none", "0" and "false" (any case, surrounding
  spaces ignored) mean no cache, as in JAX. The kernels then build into
  ``build/``: unlike JAX, the port cannot run a kernel without building
  it once.
"""

from __future__ import annotations

import os

_OFF = ("off", "none", "0", "false")


def _resolve(path: str | None) -> str | None:
    if path is not None and path.strip().lower() in _OFF:
        return None
    if not path:
        path = os.environ.get("EMT_COMPILE_CACHE", "")
        if not path or path.strip().lower() in _OFF:
            return None
    return path


def enable_compile_cache(path: str | None = None) -> str | None:
    """Build the kernels into ``path`` (or ``$EMT_COMPILE_CACHE``) -> the
    directory in use, or None when the cache is off and the kernels build
    into ``build/``."""
    from exploring_meta_tpu_torch.cuda import build
    path = _resolve(path)
    if path is None:
        build.BUILD_DIR = build.DEFAULT_BUILD_DIR
        return None
    os.makedirs(path, exist_ok=True)
    build.BUILD_DIR = os.path.abspath(path)
    return path
