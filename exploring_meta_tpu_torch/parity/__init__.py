"""Accuracy parity of the port against torch reproductions of the
reference (port of ``scripts/parity_check.py`` and
``scripts/torch_rl_repro.py``): ``check.py`` trains both sides;
``reference_vision.py`` and ``reference_rl.py`` are the reproductions."""
