"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch version.

  rhs            fused DGSEM Navier-Stokes RHS (csrc/ns_rhs.cu), replacing
                 the Pallas kernel `repro/kernels/rhs.py:fused_navier_stokes_rhs`
  dg_derivative  three-direction volume derivative (csrc/dg_derivative.cu),
                 replacing `repro/kernels/dg_derivative.py:dg_derivative3`
  smagorinsky    eddy viscosity (csrc/smagorinsky.cu), replacing
                 `repro/kernels/smagorinsky.py:smagorinsky_nut`
  wall_model     Reichardt wall-stress inversion (csrc/wall_model.cu),
                 replacing `repro/kernels/wall_model.py:wall_model_tau`
  _build         nvcc build at first use, ctypes loading

Kernels are built and loaded when first launched, never at import.
"""
