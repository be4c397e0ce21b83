"""The paper's own configurations (Table 1): HIT LES at 24 and 32 DOF.

    name    N  #Elems  #DOF    k_max  alpha
    24 DOF  5  4^3     13,824  9      0.4
    32 DOF  7  4^3     32,768  12     0.2

`use_kernels` stays True: the fused RHS, which is the CUDA kernel on GPU
tensors and its plain PyTorch version on CPU tensors.
"""
from ..cfd.solver import HITConfig

HIT24 = HITConfig(n_poly=5, n_elem=4, k_max=9, alpha=0.4)
HIT32 = HITConfig(n_poly=7, n_elem=4, k_max=12, alpha=0.2)


def reduced(use_kernels: bool = True) -> HITConfig:
    """CPU-friendly smoke scale: N=3, 2^3 elements, short episodes."""
    return HITConfig(n_poly=3, n_elem=2, k_max=3, alpha=0.4, t_end=0.3,
                     dt_rl=0.1, k_peak=2.0, k_eta=8.0,
                     use_kernels=use_kernels)
