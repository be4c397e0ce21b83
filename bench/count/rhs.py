"""Operations and bytes of one fused Navier-Stokes RHS call, from shapes
alone (frozen from the port's chip check of the kernel)."""
from __future__ import annotations

from .peaks import PEAK_BYTES_PER_S, PEAK_FP32_PER_S


def operations(batch: int, kx: int, ky: int, kz: int, n: int) -> int:
    """Float32 operations (+, -, *, /, sqrt, min, max, abs each 1) that one
    RHS call needs, whatever a kernel recomputes: every node's primitives,
    strain, viscous flux and Euler flux once; each face's central values and
    LLF flux once for the two elements that share it; the symmetric
    Kennedy-Gruber two-point flux once per pair of nodes on a line.  The
    work does not depend on the data."""
    n3, elems = n**3, kx * ky * kz
    nodes, faces = batch * elems * n3, batch * elems * 3 * n * n
    per_node = (
        15                      # rho, v (3 div), |v|^2 (5), kinetic (2),
                                # p (2), T (2), E/rho
        + 6 + 4                 # 1/2 m.v; 4 values times the node weight
        + 3 * 4 * (2 * n - 1) + 12  # gradient of (v, T): 3 x 4 lines, jac
        + 6 + 12 + 6            # strain (3 off-diagonal), S:S, nu_t
        + 10 + 3 * 11           # viscous flux: shared terms, per direction
        + 3 * (10 * (n - 1) + 6 + 10 * n)  # split form: half of the n - 1
                                # partners' fluxes (20 each), the Euler flux
                                # (6), D contraction of 5 channels, factor 2
        + 3 * 4 * 2 * n         # viscous volume: D contraction, subtract
        + 15                    # sum of the 3 directions, jac
        + 15)                   # forcing: fluctuation, scale, energy, add
    per_face = 8 + 37 + 12      # central (v, T); LLF; central viscous flux
    per_face_side = 12 + 19     # gradient lift; flux lift
    return (nodes * per_node + faces * (per_face + 2 * per_face_side)
            + 4 * (nodes - batch)  # the weighted sums, per env
            + batch * (4 + 5)      # means; TKE controller
            + 5 * n3)              # node weights w_i w_j w_k / 8


def bytes_moved(batch: int, kx: int, ky: int, kz: int, n: int,
                itemsize: int = 4) -> int:
    """Each input read once and the output written once: u and the RHS
    (5 values a node), C_s a node, D (n, n) and w (n,) in float32."""
    nodes = batch * kx * ky * kz * n**3
    return 2 * 5 * nodes * itemsize + nodes * itemsize + 4 * (n * n + n)


def bound_s(batch: int, kx: int, ky: int, kz: int, n: int) -> float:
    """The least time one call can take on the card: the larger of its
    operations at the float32 peak and its bytes at the HBM bandwidth."""
    return max(operations(batch, kx, ky, kz, n) / PEAK_FP32_PER_S,
               bytes_moved(batch, kx, ky, kz, n) / PEAK_BYTES_PER_S)
