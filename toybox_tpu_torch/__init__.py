"""PyTorch + CUDA port of toybox_tpu for an NVIDIA H100.

The package mirrors ``toybox_tpu``'s module names so each counterpart is
easy to find. Entry points run on ``cuda`` unless the caller passes
``device="cpu"``. Hand-written CUDA kernels live in ``csrc/`` and are
built with ``nvcc`` at first use (``ops/render_cuda.py``); their plain
PyTorch versions run only for tensors that lie on the CPU.

This package imports ``torch`` and ``numpy`` and never ``jax``, ``flax``,
``msgpack`` or ``toybox_tpu``.
"""
