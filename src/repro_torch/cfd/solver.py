"""HIT LES solver: RHS assembly, linear forcing and low-storage RK stepping
(PyTorch port of `repro.cfd.solver`).

This is the transition function T(s_{t+1} | a_t, s_t) of the paper's MDP:
given the current flow state and the per-element Smagorinsky coefficients
(the RL action), advance the compressible Navier-Stokes LES by Delta t_RL.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from ..kernels import dg_derivative, smagorinsky
from ..kernels import rhs as rhs_kernel
from . import dgsem, equations, gll, tables
from .dgsem import DGParams
from .equations import GasParams

# Carpenter & Kennedy (1994) five-stage fourth-order low-storage RK.
_RK_A = np.array([
    0.0,
    -567301805773.0 / 1357537059087.0,
    -2404267990393.0 / 2016746695238.0,
    -3550918686646.0 / 2091501179385.0,
    -1275806237668.0 / 842570457699.0,
])
_RK_B = np.array([
    1432997174477.0 / 9575080441755.0,
    5161836677717.0 / 13612068292357.0,
    1720146321549.0 / 2090206949498.0,
    3134564353537.0 / 4481467310338.0,
    2277821191437.0 / 14882151754819.0,
])


@dataclasses.dataclass(frozen=True)
class HITConfig:
    """Static configuration of one HIT LES environment (paper Table 1)."""

    n_poly: int = 5
    n_elem: int = 4
    length: float = 2.0 * np.pi
    # gas / flow
    mach: float = 0.3
    nu: float = 1.8e-3
    rho0: float = 1.0
    u_rms: float = 1.0
    prandtl: float = 0.72
    prandtl_turb: float = 0.9
    # forcing (Lundgren linear forcing + TKE proportional controller)
    forcing_a0: float = 0.3
    # time stepping
    cfl: float = 0.35
    dt_rl: float = 0.1
    t_end: float = 5.0
    # reward (paper Table 1)
    k_max: int = 9
    alpha: float = 0.4
    cs_max: float = 0.5
    # True: the fused RHS (kernels/rhs.py), which launches the CUDA kernel
    # on GPU tensors and runs its plain version on CPU tensors.  False: the
    # staged plain assembly (`navier_stokes_rhs`).
    use_kernels: bool = True
    # "fp32", or "bf16": the state, RK accumulator and RHS inputs/outputs
    # are bfloat16 inside `advance_rl_interval` (kernel math stays float32);
    # observations, reward and PPO stay float32.
    precision: str = "fp32"
    # synthetic DNS target spectrum (von Karman-Pao)
    k_peak: float = 4.0
    k_eta: float = 48.0

    @property
    def dg(self) -> DGParams:
        return DGParams(self.n_poly, self.n_elem, self.length)

    @property
    def compute_dtype(self) -> torch.dtype:
        """Rollout state dtype resolved from `precision` (validated here)."""
        if self.precision not in ("fp32", "bf16"):
            raise ValueError(f"unknown precision: {self.precision!r} "
                             f"(expected 'fp32' or 'bf16')")
        return torch.bfloat16 if self.precision == "bf16" else torch.float32

    @property
    def k_tke(self) -> float:
        """Target turbulent kinetic energy 3/2 u_rms^2."""
        return 1.5 * self.u_rms**2

    @property
    def gas(self) -> GasParams:
        return GasParams(mu=self.rho0 * self.nu, prandtl=self.prandtl,
                         prandtl_turb=self.prandtl_turb)

    @property
    def sound_speed0(self) -> float:
        return self.u_rms / self.mach

    @property
    def p0(self) -> float:
        return self.rho0 * self.sound_speed0**2 / equations.GAMMA

    @property
    def delta_filter(self) -> float:
        """LES filter width: element size over number of nodes per direction."""
        return self.dg.dx / (self.n_poly + 1)

    @property
    def dt(self) -> float:
        """Fixed stable timestep (DG CFL ~ 1/(2N+1)) that divides dt_rl."""
        v_max = self.sound_speed0 + 3.0 * self.u_rms
        dt_stable = self.cfl * self.dg.dx / (v_max * (2 * self.n_poly + 1))
        n_sub = int(np.ceil(self.dt_rl / dt_stable))
        return self.dt_rl / n_sub

    @property
    def n_substeps(self) -> int:
        return int(round(self.dt_rl / self.dt))

    @property
    def n_actions(self) -> int:
        return int(round(self.t_end / self.dt_rl))

    def operators(self, device: torch.device | str = "cpu",
                  dtype: torch.dtype = torch.float32) -> dict:
        """Operator tensors on `device` in `dtype`: D (n, n), w (n,), made
        once per (config, device, dtype) (`tables.table`), and the
        endpoint inverse weights."""
        _, w = self.dg.nodes_weights()
        return {
            "D": tables.table(gll.lagrange_derivative_matrix, self.n_poly,
                              device=device, dtype=dtype),
            "inv_w_end": (float(1.0 / w[0]), float(1.0 / w[-1])),
            "w": tables.table(gll.gll_weights, self.n_poly, device=device,
                              dtype=dtype),
        }


def kernel_grad_nut(q_prim: torch.Tensor, cs_nodes: torch.Tensor,
                    d_matrix: torch.Tensor, inv_w_end: tuple[float, float],
                    delta: float, *, dg: DGParams | None = None, jac=None,
                    bc: tuple | None = None, split=None
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """BR1 gradient of q_prim (..., 4, 3) and Smagorinsky nu_t through the
    component kernels: `dg_derivative3` gives the volume derivatives that
    `dgsem.dg_gradient` lifts (with `dg` / `jac` / `bc` / `split` as it
    takes them), then `smagorinsky_nut` the eddy viscosity.  Both kernels
    are element-local, so they run on a rank's block of a split mesh (its
    x-slabs, or its x- by y-slabs) as on a whole mesh.  Each
    kernel's wrapper takes its plain version for CPU tensors."""
    n, c = q_prim.shape[-2], q_prim.shape[-1]
    vols = dg_derivative.dg_derivative3(
        q_prim.reshape((-1, n, n, n, c)).contiguous(), d_matrix)
    vol_derivs = tuple(v.reshape(q_prim.shape) for v in vols)
    grad_prim = dgsem.dg_gradient(q_prim, dg, d_matrix, inv_w_end,
                                  vol_derivs=vol_derivs, jac=jac, bc=bc,
                                  split=split)
    # the velocity rows, a view of the (..., 4, 3) gradient with a point
    # stride of 12 values, which the kernel reads in place
    nu_t = smagorinsky.smagorinsky_nut(
        grad_prim[..., 0:3, :].reshape((-1, 3, 3)), cs_nodes.reshape(-1),
        delta).reshape(cs_nodes.shape)
    return grad_prim, nu_t


def broadcast_cs(cs_elem: torch.Tensor, cfg: HITConfig) -> torch.Tensor:
    """Per-element coefficients (..., K,K,K) -> nodal field (..., K,K,K,n,n,n)."""
    n = cfg.n_poly + 1
    return cs_elem[..., None, None, None].expand(cs_elem.shape + (n, n, n))


def navier_stokes_rhs(u: torch.Tensor, cs_nodes: torch.Tensor,
                      cfg: HITConfig, ops: dict, split=None) -> torch.Tensor:
    """-div(F_adv - F_visc) + forcing, the full semi-discrete RHS.

    With `cfg.use_kernels` the whole evaluation is one call of the fused
    RHS (the CUDA kernel for CUDA tensors, its float32 plain version for CPU
    tensors).  Otherwise the staged plain assembly runs in the state's dtype:
    the reference's `rhs_gradients` / `rhs_divergence` / `rhs_forcing`,
    which are `plain_gradients` / `plain_divergence` / `plain_forcing` of
    kernels/rhs.py.

    On a mesh split over ranks (`split`: by its x-slabs, a
    `core.collectives.ElemSplit`, or by x- and y-slabs, a `PencilSplit`;
    u is this rank's block) the fused kernel cannot run: it wraps whole
    periodic meshes and takes whole-box means inside.  There
    `use_kernels` means the channel's staged assembly: `kernel_grad_nut`
    (the `dg_derivative3` and `smagorinsky_nut` kernels, one launch each
    on the rank's block), then `plain_divergence` and the forcing, the
    faces of each split direction and the box sums exchanged through
    `split`; in bf16 the staged parts run in bf16, as the unsplit staged
    assembly does.
    """
    kw = dict(inv_w_end=ops["inv_w_end"], jac=cfg.dg.jac,
              delta=cfg.delta_filter, forcing_a0=cfg.forcing_a0,
              k_tke=cfg.k_tke)
    if split is not None:
        return rhs_kernel.plain_rhs(
            u, cs_nodes, ops["D"], ops["w"], gas=cfg.gas, split=split,
            gradients=(kernel_grad_nut if cfg.use_kernels
                       else rhs_kernel.plain_gradients), **kw)
    if cfg.use_kernels:
        return rhs_kernel.fused_navier_stokes_rhs(
            u, cs_nodes, ops["D"], ops["w"], mu=cfg.gas.mu,
            prandtl=cfg.prandtl, prandtl_turb=cfg.prandtl_turb, **kw)
    return rhs_kernel.plain_rhs(u, cs_nodes, ops["D"], ops["w"], gas=cfg.gas,
                                **kw)


def rk_substep(u: torch.Tensor, cs_nodes: torch.Tensor, cfg: HITConfig,
               ops: dict, split=None) -> torch.Tensor:
    """One low-storage RK5(4) step of size cfg.dt."""
    dt = _rounded(cfg.dt, u.dtype)
    du = torch.zeros_like(u)
    for stage in range(5):
        # the cast keeps the carry in the rollout compute dtype (the staged
        # RHS promotes a bf16 state against the float32 operators)
        rhs = navier_stokes_rhs(u, cs_nodes, cfg, ops, split).to(u.dtype)
        du = _rounded(_RK_A[stage], u.dtype) * du + dt * rhs
        u = u + _rounded(_RK_B[stage], u.dtype) * du
    return u


@functools.cache
def _rounded(x: float, dtype: torch.dtype) -> float:
    """`x` rounded to `dtype`, as a Python float.  The reference multiplies
    by constants already rounded to the carry's dtype (JAX's weak typing);
    a Python float keeps a bf16 carry bf16 and needs no device copy.
    Cached by (x, dtype): the RK loop asks for the same 11 per substep."""
    return torch.tensor(float(x), dtype=dtype).item()


def advance_rl_interval(u: torch.Tensor, cs_elem: torch.Tensor,
                        cfg: HITConfig, split=None) -> torch.Tensor:
    """Advance the LES by Delta t_RL under fixed per-element C_s (one MDP
    transition).  With `cfg.precision == "bf16"` the state is advanced in
    bfloat16 and cast back to float32 at the end.  With `split` u and
    cs_elem are this rank's block of a split mesh (`navier_stokes_rhs`)."""
    dtype = cfg.compute_dtype
    # the operator matrices follow the compute dtype, as in the reference
    ops = cfg.operators(u.device, dtype)
    # contiguous: the fused kernel reads one C_s per node
    cs_nodes = broadcast_cs(cs_elem, cfg).to(dtype).contiguous()
    u = u.to(dtype)
    for _ in range(cfg.n_substeps):
        u = rk_substep(u, cs_nodes, cfg, ops, split)
    return u.to(torch.float32)
