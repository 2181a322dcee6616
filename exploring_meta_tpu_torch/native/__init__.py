"""Native (C++) runtime of the host envs, bound with ctypes (port of
``exploring_meta_tpu/native``): the threaded vectorized env-stepping
service of ``vecenv.cpp``, built with ``g++`` at first use into the
gitignored ``build/`` (``binding.py``)."""
