"""The precisions a reference computes in, and the control's.

A reference runs in ``float64`` (or ``float32``) with TF32 off. The
control of a configuration is the same reference in the nearest precision
below the one the configuration states: ``tf32`` for float32 with TF32
off (float32 with TF32 products).
"""

from __future__ import annotations

import contextlib

import torch


class Precision:
    """``dtype`` of the reference's tensors, and ``tf32``."""

    def __init__(self, name: str):
        if name not in ("float64", "float32", "tf32"):
            raise ValueError(name)
        self.name = name
        self.dtype = torch.float64 if name == "float64" else torch.float32
        self.tf32 = name == "tf32"

    @contextlib.contextmanager
    def active(self):
        """TF32 for products and convolutions on (``tf32``) or off, and
        restored after."""
        saved = (torch.backends.cuda.matmul.allow_tf32,
                 torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = self.tf32
        torch.backends.cudnn.allow_tf32 = self.tf32
        try:
            yield self
        finally:
            (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32) = saved


def control_precision(cfg: dict) -> str:
    """The control's precision for a configuration computing in
    ``compute_dtype`` (or ``dtype``) float32 with TF32 off: ``tf32``."""
    dtype = cfg.get("compute_dtype", cfg.get("dtype"))
    if dtype != "float32":
        raise ValueError(f"no control for {dtype}")
    return "tf32"
