"""Analysis tier: CL transfer matrices, representation-change probes and
the offline evaluation entry points (port of
``exploring_meta_tpu/analysis/__init__.py``)."""

import importlib

from exploring_meta_tpu_torch.analysis.cl import (
    run_cl_exp,
    run_cl_rl_exp,
    save_acc_matrix,
)
from exploring_meta_tpu_torch.analysis.rc import (
    measure_change_through_time,
    run_rep_exp,
    run_rep_rl_exp,
    sanity_check,
)


def __getattr__(name):
    # the eval modules pull in the trainers' modules and the datasets:
    # load them only when asked for
    if name in ("eval_vision", "eval_rl"):
        return importlib.import_module(f"{__name__}.{name}")
    raise AttributeError(name)


__all__ = [
    "run_cl_exp", "run_cl_rl_exp", "save_acc_matrix", "run_rep_exp",
    "run_rep_rl_exp", "sanity_check", "measure_change_through_time",
    "eval_vision", "eval_rl",
]
