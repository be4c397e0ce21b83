"""Plane-channel flow with wall-modeled LES, the non-periodic DGSEM scenario
(PyTorch port of `repro.cfd.channel`).

The domain is periodic in x (streamwise) and z (spanwise) and walled in y:
the y surface exchange replaces the periodic wrap with weak-form wall fluxes
built on `dgsem.set_face` / `dgsem.left_faces`.

Boundary treatment (weak, flux-based; nothing is overwritten in the state):

  * advective wall flux: no penetration; the +y Euler flux at a wall face
    is the pure pressure flux [0, 0, p, 0, 0] of the interior trace;
  * viscous wall flux: wall-modeled.  The tangential stress
    tau_w = rho u_tau^2 comes from inverting Reichardt's law of the wall at
    a matching point inside the wall-adjacent element, and the RL action
    scales it per wall element: tau = a * tau_model, a in [0, a_max].  No
    work and no heat flux at the (no-slip, adiabatic) wall;
  * BR1 gradient wall trace: the interior trace with the wall-normal
    velocity zeroed, so that wall friction enters only through the modeled
    flux.

Everything else (split-form Kennedy-Gruber volume terms, LLF interior
surfaces, BR1 viscous interfaces, Carpenter-Kennedy RK5(4)) is the periodic
HIT solver's; with `wall=False` every override is skipped and the assembly
is the periodic one.  A constant streamwise pressure-gradient forcing
f_x = u_tau^2 / h drives the flow; the reward compares the x-z mean velocity
profile with Reichardt's law at the target u_tau.

State layout: (..., Kx, Ky, Kz, n, n, n, 5), with element counts and lengths
per direction.  With `use_kernels` the gradient, eddy viscosity and wall
model go through the component kernels (`solver.kernel_grad_nut` and
`kernels/wall_model.py`): the CUDA kernels for CUDA tensors, their plain
versions for CPU tensors.

A channel split over ranks by its x-slabs (`core.collectives.ElemSplit`,
passed as `split`) exchanges its x-faces through the split: x is periodic,
and the walls, their matching states and the body force are local to an
x-slab.  With `split=None` the code is the unsplit one.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..kernels import rhs as rhs_kernel
from ..kernels import wall_model
from ..kernels.wall_model import reichardt_uplus
from . import dgsem, equations, gll, tables
from .equations import GasParams
from .solver import _RK_A, _RK_B, _rounded, kernel_grad_nut


@dataclasses.dataclass(frozen=True)
class ChannelConfig:
    """Static configuration of one wall-modeled channel-flow environment."""

    n_poly: int = 3
    n_elem: tuple[int, int, int] = (3, 4, 3)          # (Kx, Ky, Kz)
    lengths: tuple[float, float, float] = (4.0, 2.0, 2.0)
    # gas / flow
    mach: float = 0.3
    nu: float = 5e-3
    rho0: float = 1.0
    u_bulk: float = 1.0        # velocity scale (obs normalization)
    prandtl: float = 0.72
    prandtl_turb: float = 0.9
    cs_sgs: float = 0.1        # fixed interior Smagorinsky coefficient
    # wall model / forcing
    u_tau: float = 0.12        # target friction velocity; f_x = u_tau^2 / h
    kappa: float = 0.41
    wm_iters: int = 8          # fixed-point iterations inverting the wall law
    wall: bool = True          # False -> fully periodic (BC-reduction tests)
    # time stepping
    cfl: float = 0.35
    dt_rl: float = 0.1
    t_end: float = 2.0
    # reward / action
    alpha: float = 0.2         # reward shape, r = 2 exp(-l/alpha) - 1
    a_max: float = 2.0         # wall-stress scaling bound (1.0 = model as-is)
    # initial-state perturbation amplitude (fraction of u_bulk)
    perturb: float = 0.08
    # True: gradient, nu_t and wall model through the component kernels
    # (CUDA for CUDA tensors, their plain versions for CPU tensors).  False:
    # the staged plain assembly.
    use_kernels: bool = True
    # "fp32", or "bf16": the state is advanced in bfloat16 inside
    # `advance_rl_interval` (kernel math stays float32); observations,
    # reward and PPO stay float32.
    precision: str = "fp32"

    @property
    def n(self) -> int:
        return self.n_poly + 1

    @property
    def compute_dtype(self) -> torch.dtype:
        """Rollout state dtype resolved from `precision` (validated here)."""
        if self.precision not in ("fp32", "bf16"):
            raise ValueError(f"unknown precision: {self.precision!r} "
                             f"(expected 'fp32' or 'bf16')")
        return torch.bfloat16 if self.precision == "bf16" else torch.float32

    @property
    def dxs(self) -> tuple[float, float, float]:
        return tuple(l / k for l, k in zip(self.lengths, self.n_elem))

    @property
    def jacs(self) -> tuple[float, float, float]:
        return tuple(2.0 / dx for dx in self.dxs)

    @property
    def half_height(self) -> float:
        return 0.5 * self.lengths[1]

    @property
    def f_x(self) -> float:
        """Constant streamwise forcing balancing the target wall stress."""
        return self.u_tau**2 / self.half_height

    @property
    def gas(self) -> GasParams:
        return GasParams(mu=self.rho0 * self.nu, prandtl=self.prandtl,
                         prandtl_turb=self.prandtl_turb)

    @property
    def sound_speed0(self) -> float:
        return self.u_bulk / self.mach

    @property
    def p0(self) -> float:
        return self.rho0 * self.sound_speed0**2 / equations.GAMMA

    @property
    def delta_filter(self) -> float:
        """LES filter width: geometric-mean node spacing."""
        dx, dy, dz = self.dxs
        return float((dx * dy * dz) ** (1.0 / 3.0)) / self.n

    @property
    def dt(self) -> float:
        """Fixed stable timestep (DG CFL ~ 1/(2N+1)) that divides dt_rl."""
        v_max = self.sound_speed0 + 3.0 * self.u_bulk
        dt_stable = self.cfl * min(self.dxs) / (v_max * (2 * self.n_poly + 1))
        n_sub = int(np.ceil(self.dt_rl / dt_stable))
        return self.dt_rl / n_sub

    @property
    def n_substeps(self) -> int:
        return int(round(self.dt_rl / self.dt))

    @property
    def n_actions(self) -> int:
        return int(round(self.t_end / self.dt_rl))

    @property
    def n_wall_elements(self) -> int:
        """Wall-adjacent elements over both walls: 2 * Kx * Kz."""
        return 2 * self.n_elem[0] * self.n_elem[2]

    @property
    def tau_wall(self) -> float:
        """Target wall shear stress rho u_tau^2 (the wall-pressure scale)."""
        return self.rho0 * self.u_tau**2

    @property
    def t0(self) -> float:
        """Background temperature p0 / (rho0 R)."""
        return self.p0 / (self.rho0 * equations.R_GAS)

    @property
    def t_tau(self) -> float:
        """Friction-temperature scale u_tau^2 / cp of an adiabatic wall."""
        return self.u_tau**2 / equations.CP

    def operators(self, device: torch.device | str = "cpu",
                  dtype: torch.dtype = torch.float32) -> dict:
        """Operator tensors on `device` in `dtype`: D (n, n), w (n,), made
        once per (config, device, dtype) (`tables.table`), and the
        endpoint inverse weights."""
        _, w = gll.gll_nodes_weights(self.n_poly)
        return {
            "D": tables.table(gll.lagrange_derivative_matrix, self.n_poly,
                              device=device, dtype=dtype),
            "inv_w_end": (float(1.0 / w[0]), float(1.0 / w[-1])),
            "w": tables.table(gll.gll_weights, self.n_poly, device=device,
                              dtype=dtype),
        }


# --- wall law / reference profile -------------------------------------------
def node_coords(cfg: ChannelConfig, direction: int) -> np.ndarray:
    """Physical GLL node coordinates along `direction`, shape (K_d, n)."""
    x_gll, _ = gll.gll_nodes_weights(cfg.n_poly)
    dx = cfg.dxs[direction]
    offsets = (np.arange(cfg.n_elem[direction]) + 0.5) * dx
    return offsets[:, None] + 0.5 * dx * x_gll[None, :]


def reference_profile(cfg: ChannelConfig) -> np.ndarray:
    """Target mean streamwise velocity at the y GLL nodes, (Ky, n) float32:
    Reichardt's law at the target u_tau, evaluated in float64 and then
    rounded (symmetric in the two channel halves)."""
    y = node_coords(cfg, 1)
    y_dist = np.minimum(y, cfg.lengths[1] - y)
    y_plus = y_dist * cfg.u_tau / cfg.nu
    return (cfg.u_tau * reichardt_uplus(y_plus, cfg.kappa, xp=np)
            ).astype(np.float32)


def mean_velocity_profile(u: torch.Tensor, cfg: ChannelConfig,
                          ops: dict) -> torch.Tensor:
    """x-z quadrature average of streamwise velocity: (..., Ky, n).  u is
    the whole channel (a split channel gathers its state first): the
    division is by the whole channel's Kx * Kz."""
    _, vel, _, _ = equations.conservative_to_primitive(u)
    w = ops["w"] * 0.5
    kx, _, kz = cfg.n_elem
    return torch.einsum("...abcijk,i,k->...bj", vel[..., 0], w, w) / (kx * kz)


def profile_error(profile: torch.Tensor, ref: torch.Tensor,
                  ops: dict) -> torch.Tensor:
    """Quadrature-weighted relative squared L2 error of the mean profile."""
    w = ops["w"] * 0.5
    num = torch.einsum("...bj,j->...", (profile - ref) ** 2, w)
    den = torch.einsum("bj,j->", ref * ref, w)
    return num / torch.clamp_min(den, 1e-12)


# --- initial states ---------------------------------------------------------
_MODES = ((1, 1), (1, 2), (2, 1), (2, 2))


def initial_states(bulk_factor: torch.Tensor, phases: torch.Tensor,
                   cfg: ChannelConfig) -> torch.Tensor:
    """States (N, Kx, Ky, Kz, n, n, n, 5) from their random draws: the
    reference profile times a bulk factor (N,) in [0.75, 1.25], so that the
    wall-stress action has work to do, plus four wall-vanishing modes,
    periodic in x and z, with phases (N, 4, 3) in [0, 2 pi)."""
    dev = bulk_factor.device
    kx, ky, kz = cfg.n_elem
    n = cfg.n
    shape = (kx, ky, kz, n, n, n)
    xs = [torch.as_tensor(node_coords(cfg, d), dtype=torch.float32,
                          device=dev) for d in range(3)]
    x = xs[0][:, None, None, :, None, None].expand(shape)
    y = xs[1][None, :, None, None, :, None].expand(shape)
    z = xs[2][None, None, :, None, None, :].expand(shape)

    u_ref = torch.as_tensor(reference_profile(cfg), device=dev)
    bulk = bulk_factor[:, None, None, None, None, None, None]
    ux = u_ref[None, :, None, None, :, None].expand(shape) * bulk
    uy = torch.zeros_like(ux)
    uz = torch.zeros_like(ux)

    env = torch.sin(np.pi * y / cfg.lengths[1])
    lx, _, lz = cfg.lengths
    amp = cfg.perturb * cfg.u_bulk
    ph = phases[:, :, :, None, None, None, None, None, None]
    for m, (mx, mz) in enumerate(_MODES):
        cx = 2.0 * np.pi * mx / lx
        cz = 2.0 * np.pi * mz / lz
        ux = ux + amp * env * torch.sin(cx * x + ph[:, m, 0]) * torch.cos(
            cz * z)
        uy = uy + amp * env * torch.cos(cx * x + ph[:, m, 1]) * torch.sin(
            cz * z)
        uz = uz + amp * env * torch.sin(cz * z + ph[:, m, 2]) * torch.cos(
            cx * x)

    rho = torch.full(ux.shape, cfg.rho0, dtype=torch.float32, device=dev)
    p = torch.full(ux.shape, cfg.p0, dtype=torch.float32, device=dev)
    return equations.primitive_to_conservative(
        rho, torch.stack([ux, uy, uz], dim=-1), p)


def make_state_bank(gen: torch.Generator, cfg: ChannelConfig,
                    n_states: int) -> torch.Tensor:
    """Bank of initial states (n_states, Kx, Ky, Kz, n, n, n, 5) on the
    generator's device, its draws taken from `gen`."""
    dev = gen.device
    bulk = 0.75 + 0.5 * torch.rand((n_states,), generator=gen, device=dev)
    phases = 2.0 * np.pi * torch.rand((n_states, len(_MODES), 3),
                                      generator=gen, device=dev)
    return initial_states(bulk, phases, cfg)


def sample_initial_state(gen: torch.Generator,
                         cfg: ChannelConfig) -> torch.Tensor:
    """One random state (Kx, Ky, Kz, n, n, n, 5)."""
    return make_state_bank(gen, cfg, 1)[0]


# --- near-wall observation fields --------------------------------------------
def wall_observation(field: torch.Tensor, cfg: ChannelConfig, *,
                     flip_sign_channel: int | None = None) -> torch.Tensor:
    """The wall-adjacent element layers of a nodal field (..., Kx, Ky, Kz,
    n, n, n, C), top wall mirrored (y node axis flipped; channel
    `flip_sign_channel`, if given, negated) so that "away from the wall" is
    increasing node index at both walls.  Returns (..., 2*Kx*Kz, n, n, n,
    C), bottom wall first."""
    ky_axis = field.ndim - 6
    bot = field.select(ky_axis, 0)
    top = torch.flip(field.select(ky_axis, field.shape[ky_axis] - 1),
                     dims=(-3,))
    if flip_sign_channel is not None:
        top[..., flip_sign_channel] *= -1.0  # `flip` returned a copy
    kx, _, kz = cfg.n_elem
    n = cfg.n
    batch = tuple(field.shape[: field.ndim - 7])
    shape = batch + (kx * kz, n, n, n, field.shape[-1])
    return torch.cat([bot.reshape(shape), top.reshape(shape)], dim=-5)


def wall_velocity_observation(u: torch.Tensor,
                              cfg: ChannelConfig) -> torch.Tensor:
    """Wall-adjacent element velocities, (..., 2*Kx*Kz, n, n, n, 3),
    un-normalized (the env divides by its declared channel scale)."""
    _, vel, _, _ = equations.conservative_to_primitive(u)
    return wall_observation(vel, cfg, flip_sign_channel=1)


def wall_pressure_observation(u: torch.Tensor,
                              cfg: ChannelConfig) -> torch.Tensor:
    """Near-wall pressure fluctuation p - p0, (..., 2*Kx*Kz, n, n, n, 1),
    un-normalized (the env divides by `cfg.tau_wall`); no sign flip."""
    _, _, p, _ = equations.conservative_to_primitive(u)
    return wall_observation((p - cfg.p0)[..., None], cfg)


def wall_temperature_observation(u: torch.Tensor,
                                 cfg: ChannelConfig) -> torch.Tensor:
    """Near-wall temperature fluctuation T - T0, (..., 2*Kx*Kz, n, n, n, 1),
    un-normalized (the env divides by `cfg.t_tau`); no sign flip."""
    _, _, _, temp = equations.conservative_to_primitive(u)
    return wall_observation((temp - cfg.t0)[..., None], cfg)


# --- wall model -------------------------------------------------------------
def wall_stress_magnitude(u_par: torch.Tensor, rho_w: torch.Tensor,
                          y_m: float, cfg: ChannelConfig) -> torch.Tensor:
    """tau_w = rho u_tau^2 by inverting u_par/u_tau = u+(y_m u_tau / nu)
    with `cfg.wm_iters` damped fixed-point rounds; through the wall-model
    kernel with `cfg.use_kernels`, else its plain version."""
    kw = dict(y_m=y_m, nu=cfg.nu, kappa=cfg.kappa, iters=cfg.wm_iters)
    if cfg.use_kernels:
        # on the card the kernel takes contiguous operands of one shape, as
        # `wall_fluxes` builds them
        return wall_model.wall_model_tau(u_par, rho_w, **kw)
    return wall_model.wall_model_tau_plain(u_par, rho_w, **kw)


def _wall_slab(arr: torch.Tensor, side: int) -> torch.Tensor:
    """The wall-adjacent element along y of a y-face array (..., Kx, Ky, Kz,
    n, n, C): side 0 -> ky=0, side 1 -> ky=Ky-1."""
    axis = dgsem.ELEM_AXIS[1] + arr.ndim + 1
    return arr.select(axis, 0 if side == 0 else arr.shape[axis] - 1)


def _matching_state(u: torch.Tensor, cfg: ChannelConfig, ops: dict
                    ) -> tuple[torch.Tensor, ...]:
    """(rho, u_x, u_z) at the wall-model matching point of both walls: the
    y-quadrature mean of the wall-adjacent element, per (x, z) face-node
    column.  Shapes (2, ..., Kx, Kz, n, n), bottom wall first; rho is
    contiguous."""
    axis = dgsem.ELEM_AXIS[1] + u.ndim
    ue = torch.stack((u.select(axis, 0), u.select(axis, u.shape[axis] - 1)))
    # (2, ..., Kx, Kz, ni, nj, nk, 5): average the y node axis
    ue = torch.einsum("...ijkc,j->...ikc", ue, ops["w"] * 0.5)
    rho, vel, _, _ = equations.conservative_to_primitive(ue)
    return rho.contiguous(), vel[..., 0], vel[..., 2]


def wall_fluxes(u: torch.Tensor, scale_bot: torch.Tensor,
                scale_top: torch.Tensor, cfg: ChannelConfig, ops: dict
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Combined (advective - viscous) +y numerical flux at the two wall
    faces, each (..., Kx, Kz, n, n, 5).  scale_bot / scale_top: RL
    wall-stress scaling at face nodes, (..., Kx, Kz, n, n).

    Both walls go through one batch, stacked on a leading axis of size 2
    (bottom, top): one wall-model call per RHS on both walls' points."""
    lo_tr, hi_tr = dgsem._face_slices(u, 1)
    u_wall = torch.stack((_wall_slab(lo_tr, 0), _wall_slab(hi_tr, 1)))
    y_m = 0.5 * cfg.dxs[1]  # matching point: wall-element centroid distance
    _, _, p_w, _ = equations.conservative_to_primitive(u_wall)
    rho_m, ux_m, uz_m = _matching_state(u, cfg, ops)
    u_par = torch.sqrt(ux_m**2 + uz_m**2 + 1e-12)
    # tau_xy on the +y flux is positive at the bottom wall (du/dy > 0 for
    # flow in +x) and negative at the top: the top's sign rides on its
    # scale (exact, a sign flip rounds nothing)
    side = torch.broadcast_shapes(scale_bot.shape, scale_top.shape,
                                  u_par.shape[1:])
    scale = torch.stack((scale_bot.expand(side), -scale_top.expand(side)))
    tau = scale * wall_stress_magnitude(u_par, rho_m, y_m, cfg)
    tau_x = tau * ux_m / u_par
    tau_z = tau * uz_m / u_par
    zero = torch.zeros_like(p_w)
    # advective: no-penetration pressure flux; viscous: modeled stress,
    # no wall work (no slip) and no heat flux (adiabatic)
    f_adv = torch.stack([zero, zero, p_w, zero, zero], dim=-1)
    f_visc = torch.stack([zero, tau_x, zero, tau_z, zero], dim=-1)
    flux = f_adv - f_visc
    return flux[0], flux[1]


# --- RHS / stepping ---------------------------------------------------------
def channel_rhs(u: torch.Tensor, scale_bot: torch.Tensor,
                scale_top: torch.Tensor, cfg: ChannelConfig,
                ops: dict, split=None) -> torch.Tensor:
    """-div(F_adv - F_visc) + pressure-gradient forcing, walls in y.

    The periodic solver's assembly (`kernels/rhs.py:plain_divergence`) with
    the y surface exchange routed through the wall fluxes; `cfg.wall=False`
    skips every override and is the periodic path.  With `split` u and the
    scales are this rank's x-slabs; the x-faces cross ranks 5 times."""
    d_matrix, inv_w_end = ops["D"], ops["inv_w_end"]
    rho, vel, p, temp = equations.conservative_to_primitive(u)
    prim = (rho, vel, p, u[..., 4] / rho)
    q_prim = torch.cat([vel, temp[..., None]], dim=-1)

    bc_grad = None
    if cfg.wall:
        # gradient wall trace: interior trace with v_y zeroed (slip-like)
        lo_tr, hi_tr = dgsem._face_slices(q_prim, 1)
        q_lo = _wall_slab(lo_tr, 0).clone()
        q_hi = _wall_slab(hi_tr, 1).clone()
        q_lo[..., 1] = 0.0
        q_hi[..., 1] = 0.0
        bc_grad = (None, (q_lo, q_hi), None)
    cs_nodes = torch.full(u.shape[:-1], cfg.cs_sgs, dtype=u.dtype,
                          device=u.device)
    if cfg.use_kernels:
        grad_prim, nu_t = kernel_grad_nut(q_prim, cs_nodes, d_matrix,
                                          inv_w_end, cfg.delta_filter,
                                          jac=cfg.jacs, bc=bc_grad,
                                          split=split)
    else:
        grad_prim = dgsem.dg_gradient(q_prim, None, d_matrix, inv_w_end,
                                      jac=cfg.jacs, bc=bc_grad, split=split)
        s_mag = equations.strain_magnitude(
            equations.strain_rate(grad_prim[..., 0:3, :]))
        nu_t = equations.eddy_viscosity(cs_nodes, cfg.delta_filter, s_mag)

    wall = (wall_fluxes(u, scale_bot, scale_top, cfg, ops) if cfg.wall
            else None)
    rhs = rhs_kernel.plain_divergence(u, prim, grad_prim, nu_t, d_matrix,
                                      inv_w_end, jac=cfg.jacs, gas=cfg.gas,
                                      wall=wall, split=split)

    # constant streamwise pressure-gradient forcing
    f_mom_x = rho * cfg.f_x
    f_e = f_mom_x * vel[..., 0]
    zero = torch.zeros_like(f_mom_x)
    return rhs + torch.stack([zero, f_mom_x, zero, zero, f_e], dim=-1)


def rk_substep(u: torch.Tensor, scale_bot: torch.Tensor,
               scale_top: torch.Tensor, cfg: ChannelConfig,
               ops: dict, split=None) -> torch.Tensor:
    """One Carpenter-Kennedy RK5(4) low-storage step of size cfg.dt."""
    dt = _rounded(cfg.dt, u.dtype)
    du = torch.zeros_like(u)
    for stage in range(5):
        # the cast keeps the carry in the rollout compute dtype
        rhs = channel_rhs(u, scale_bot, scale_top, cfg, ops,
                          split).to(u.dtype)
        du = _rounded(_RK_A[stage], u.dtype) * du + dt * rhs
        u = u + _rounded(_RK_B[stage], u.dtype) * du
    return u


def advance_rl_interval(u: torch.Tensor, scale_bot: torch.Tensor,
                        scale_top: torch.Tensor, cfg: ChannelConfig,
                        split=None) -> torch.Tensor:
    """Advance the channel LES by Delta t_RL under fixed wall-stress scaling
    (one MDP transition).  u: (..., Kx, Ky, Kz, n, n, n, 5); scale_bot /
    scale_top: per-wall-element scaling (..., Kx, Kz), broadcast to face
    nodes here.  With `cfg.precision == "bf16"` the state advances in
    bfloat16 and is cast back to float32 at the end.  With `split` u and
    the scales are this rank's x-slabs of a split channel."""
    n = cfg.n
    dtype = cfg.compute_dtype
    # the operator matrices follow the compute dtype, as in the reference
    ops = cfg.operators(u.device, dtype)
    sb, st = (s[..., None, None].expand(s.shape + (n, n)).to(dtype)
              for s in (scale_bot, scale_top))
    u = u.to(dtype)
    for _ in range(cfg.n_substeps):
        u = rk_substep(u, sb, st, cfg, ops, split)
    return u.to(torch.float32)
