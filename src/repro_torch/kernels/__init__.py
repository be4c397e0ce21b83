"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch version.

  rhs      fused DGSEM Navier-Stokes RHS (csrc/ns_rhs.cu), replacing the
           Pallas kernel `repro/kernels/rhs.py:fused_navier_stokes_rhs`
  _build   nvcc build at first use, ctypes loading

Kernels are built and loaded when first launched, never at import.
"""
