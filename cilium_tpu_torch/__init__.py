"""cilium-tpu on PyTorch and CUDA: the serving step on an NVIDIA H100.

A port of ``cilium_tpu`` (the JAX package, which stays the reference).
The module tree mirrors the JAX package's, so each module has a
counterpart of the same name there.  Host-only modules (labels,
identity, policy compiler, LPM compiler) are copies; device modules are
rewritten over torch tensors, and every device program on the serving
path is a CUDA kernel written by hand for ``sm_90a`` (``csrc/``, built
by ``kernels/build.py`` on first use).

Conventions:

- u32 words live in ``torch.int32`` tensors as bit patterns; the CUDA
  kernels read them as ``uint32_t``.  Plain torch code widens them to
  int64 (``u32.widen``) because torch on the CPU has no unsigned add,
  shift or compare.
- Every kernel has a plain PyTorch version of the same function in the
  same module.  A wrapper takes it only for CPU tensors; for CUDA
  tensors it launches the kernel or raises.
- Entry points default to ``device="cuda"`` and raise without a GPU.
"""

__version__ = "0.1.0"
