"""Scale-out: task data parallelism over ``torch.distributed``
(``mesh.py``, ranks started by ``launch.py``) and multi-seed training in
one program (``multiseed.py``); the port of ``exploring_meta_tpu/parallel``."""
