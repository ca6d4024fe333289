"""PyTorch/CUDA port of the PIM-ML reproduction.

The JAX package :mod:`repro` is the reference; this package runs the same
training loop (paper §2.2, Fig. 3) on an NVIDIA H100 in PyTorch, with the
TPU's Pallas kernels replaced by CUDA C++ kernels written for Hopper
(``csrc/``):

  1. ``System.put`` quantizes the dataset once and shards it over a
     leading ``cores`` axis of one device tensor ``[C, n_pc, ...]``;
  2. every simulated core runs its gradient kernel over its own shard —
     one batched launch covers all cores (no ``vmap``);
  3. a ``ReduceStrategy`` (fabric, host or hierarchical) combines the
     partials;
  4. the host updates ``w``, re-quantizes it and broadcasts it again.

It imports ``torch`` and ``numpy`` only: never ``jax``, never ``repro``.
Entry points run on ``"cuda"`` unless the caller asks for ``"cpu"``; on a
CUDA tensor a kernel op launches its CUDA kernel or raises, on a CPU
tensor it runs the op's plain PyTorch version
(:mod:`repro_torch.kernels.dispatch`).
"""
