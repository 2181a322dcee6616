"""Multi-seed training in one program (port of
``exploring_meta_tpu/parallel``'s seed sweeps; the task-axis mesh is not
ported yet)."""
