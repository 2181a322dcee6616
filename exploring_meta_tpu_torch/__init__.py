"""PyTorch/CUDA port of ``exploring_meta_tpu`` for NVIDIA Hopper.

The first slice serves few-shot requests on the CNN4-Omniglot model
(:class:`exploring_meta_tpu_torch.serve.VisionServer`). The fused
conv -> batch-stat BN -> ReLU block runs on hand-written CUDA kernels
(``csrc/cnn4_block.cu``), built with ``nvcc`` at first use.

Conventions shared by every module:

- tensors are in the JAX package's layout at every public function: NHWC
  activations, HWIO conv weights, ``[in, out]`` linear weights; params are
  the same nested dict/list as the JAX params pytree;
- a leading request (task) axis is written out where JAX used ``vmap``:
  activations ``[B, N, H, W, C]``, per-task params ``[B, ...]``;
- entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
  without a card they raise instead of falling back to the CPU.

Importing the package imports ``torch`` only; the kernel library is
compiled and loaded the first time a CUDA tensor reaches a kernel.
"""

__version__ = "0.1.0"
