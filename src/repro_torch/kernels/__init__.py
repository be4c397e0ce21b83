"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch version.

  rhs            fused DGSEM Navier-Stokes RHS (csrc/ns_rhs_cluster.cu, one
                 cluster launch per call; csrc/ns_rhs.cu, two passes, for
                 meshes beyond a 16-CTA cluster), replacing the Pallas kernel
                 `repro/kernels/rhs.py:fused_navier_stokes_rhs`
  dg_derivative  three-direction volume derivative (csrc/dg_derivative_tiled.cu,
                 specialised on n for 2 <= n <= 8; csrc/dg_derivative.cu for
                 other n), replacing
                 `repro/kernels/dg_derivative.py:dg_derivative3`
  smagorinsky    eddy viscosity (csrc/smagorinsky.cu), replacing
                 `repro/kernels/smagorinsky.py:smagorinsky_nut`
  wall_model     Reichardt wall-stress inversion (csrc/wall_model.cu),
                 replacing `repro/kernels/wall_model.py:wall_model_tau`
  flash_attention  online-softmax GQA attention forward
                 (csrc/flash_attention.cu), replacing
                 `repro/kernels/flash_attention.py:flash_attention`
  linear_scan    gated linear recurrence forward (csrc/linear_scan.cu),
                 replacing `repro/kernels/linear_scan.py:linear_scan`
  ops            the LM kernels' impl dispatch (kernel | chunked | naive/scan)
  _build         nvcc build at first use, ctypes loading

Kernels are built and loaded when first launched, never at import.
"""
