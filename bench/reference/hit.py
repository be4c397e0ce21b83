"""Plain PyTorch reference of the HIT LES environment (Kurz et al. 2022,
Sec. 5.2): the compressible Navier-Stokes DGSEM right-hand side (split-form
Kennedy-Gruber volume, LLF and BR1 surfaces, Smagorinsky eddy viscosity,
Lundgren forcing), the RK5(4) interval, the reward, the observation and
the initial-state bank.  Float32 on whatever device its inputs are on, one
staged expression per term, no kernel, no cache.  It follows the port's
plain assembly formula for formula (a frozen copy, periodic box only) and
imports nothing of the program."""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from . import gll

GAMMA = 1.4
R_GAS = 1.0
CP = GAMMA * R_GAS / (GAMMA - 1.0)
ELEM_AXIS = (-7, -6, -5)
NODE_AXIS = (-4, -3, -2)

# Carpenter & Kennedy (1994) five-stage fourth-order low-storage RK.
RK_A = (0.0, -567301805773.0 / 1357537059087.0,
        -2404267990393.0 / 2016746695238.0,
        -3550918686646.0 / 2091501179385.0,
        -1275806237668.0 / 842570457699.0)
RK_B = (1432997174477.0 / 9575080441755.0,
        5161836677717.0 / 13612068292357.0,
        1720146321549.0 / 2090206949498.0,
        3134564353537.0 / 4481467310338.0,
        2277821191437.0 / 14882151754819.0)


@dataclasses.dataclass(frozen=True)
class Case:
    """One HIT configuration as the configuration file states it."""

    n_poly: int
    n_elem: int
    length: float
    mach: float
    nu: float
    rho0: float
    u_rms: float
    prandtl: float
    prandtl_turb: float
    forcing_a0: float
    cfl: float
    dt_rl: float
    t_end: float
    k_max: int
    alpha: float
    cs_max: float
    k_peak: float
    k_eta: float

    @classmethod
    def from_fields(cls, fields: dict) -> "Case":
        return cls(**{f.name: fields[f.name] for f in dataclasses.fields(cls)})

    @property
    def n(self) -> int:
        return self.n_poly + 1

    @property
    def dx(self) -> float:
        return self.length / self.n_elem

    @property
    def jac(self) -> float:
        return 2.0 / self.dx

    @property
    def n_grid(self) -> int:
        return self.n_elem * self.n

    @property
    def n_substeps(self) -> int:
        v_max = self.u_rms / self.mach + 3.0 * self.u_rms
        dt_stable = self.cfl * self.dx / (v_max * (2 * self.n_poly + 1))
        return int(np.ceil(self.dt_rl / dt_stable))

    @property
    def dt(self) -> float:
        return self.dt_rl / self.n_substeps

    @property
    def n_actions(self) -> int:
        return int(round(self.t_end / self.dt_rl))

    @property
    def delta(self) -> float:
        return self.dx / self.n

    @property
    def k_tke(self) -> float:
        return 1.5 * self.u_rms**2

    @property
    def p0(self) -> float:
        return self.rho0 * (self.u_rms / self.mach) ** 2 / GAMMA


def f32(x: float) -> float:
    """x rounded to float32, as a Python float."""
    return float(np.float32(x))


# --- gas ---------------------------------------------------------------------
def primitives(u):
    rho = u[..., 0]
    vel = u[..., 1:4] / rho[..., None]
    kinetic = 0.5 * rho * torch.sum(vel * vel, dim=-1)
    p = (GAMMA - 1.0) * (u[..., 4] - kinetic)
    return rho, vel, p, p / (rho * R_GAS)


def conservative(rho, vel, p):
    e_tot = p / (GAMMA - 1.0) + 0.5 * rho * torch.sum(vel * vel, dim=-1)
    return torch.cat([rho[..., None], rho[..., None] * vel, e_tot[..., None]],
                     dim=-1)


def _mom_columns(base, per_comp, p, d):
    cols = [base * per_comp[..., i] for i in range(3)]
    cols[d] = cols[d] + p
    return torch.stack(cols, dim=-1)


def euler_flux(u, d):
    _, vel, p, _ = primitives(u)
    vn = vel[..., d]
    return torch.cat([u[..., 1 + d][..., None],
                      _mom_columns(vn, u[..., 1:4], p, d),
                      ((u[..., 4] + p) * vn)[..., None]], dim=-1)


def llf_flux(u_l, u_r, d):
    rho_l, vel_l, p_l, _ = primitives(u_l)
    rho_r, vel_r, p_r, _ = primitives(u_r)
    lam = torch.maximum(
        torch.abs(vel_l[..., d]) + torch.sqrt(GAMMA * p_l / rho_l),
        torch.abs(vel_r[..., d]) + torch.sqrt(GAMMA * p_r / rho_r))
    return (0.5 * (euler_flux(u_l, d) + euler_flux(u_r, d))
            - 0.5 * lam[..., None] * (u_r - u_l))


def kennedy_gruber(a, b, d):
    rho_m = 0.5 * (a[0] + b[0])
    vel_m = 0.5 * (a[1] + b[1])
    p_m = 0.5 * (a[2] + b[2])
    e_m = 0.5 * (a[3] + b[3])
    vn = vel_m[..., d]
    f_rho = rho_m * vn
    return torch.cat([f_rho[..., None], _mom_columns(f_rho, vel_m, p_m, d),
                      (f_rho * e_m + p_m * vn)[..., None]], dim=-1)


def viscous_flux(u, grad, nu_t, case: Case, d):
    rho, vel, _, _ = primitives(u)
    grad_v, grad_t = grad[..., 0:3, :], grad[..., 3, :]
    s_ij = 0.5 * (grad_v + grad_v.transpose(-1, -2))
    div_v = grad_v[..., 0, 0] + grad_v[..., 1, 1] + grad_v[..., 2, 2]
    mu = case.rho0 * case.nu
    mu_eff = mu + rho * nu_t
    tau = 2.0 * mu_eff[..., None, None] * s_ij
    third = (2.0 / 3.0) * mu_eff * div_v
    tau = tau - third[..., None, None] * torch.eye(3, dtype=u.dtype,
                                                   device=u.device)
    k_eff = CP * (mu / case.prandtl + rho * nu_t / case.prandtl_turb)
    q_d = -k_eff * grad_t[..., d]
    tau_d = tau[..., :, d]
    work = torch.sum(tau_d * vel, dim=-1)
    return torch.cat([torch.zeros_like(rho)[..., None], tau_d,
                      (work - q_d)[..., None]], dim=-1)


# --- DGSEM operators on the periodic box -------------------------------------
def deriv_along(u, dmat, d):
    axis = NODE_AXIS[d] + u.ndim
    return torch.movedim(torch.movedim(u, axis, -1) @ dmat.T, -1, axis)


def faces(u, d):
    axis = NODE_AXIS[d] + u.ndim
    return u.select(axis, 0), u.select(axis, u.shape[axis] - 1)


def traces(u, d):
    """(node-N trace of e, node-0 trace of e + 1) at each right face."""
    lo, hi = faces(u, d)
    return hi, torch.roll(lo, shifts=-1, dims=ELEM_AXIS[d] + lo.ndim + 1)


def to_left(f_right, d):
    return torch.roll(f_right, shifts=1, dims=ELEM_AXIS[d] + f_right.ndim + 1)


def lift(du, jump_right, jump_left, d, inv_w_end):
    axis = NODE_AXIS[d] + du.ndim
    moved = torch.movedim(du, axis, -1).clone()
    moved[..., -1] += inv_w_end[1] * jump_right
    moved[..., 0] += -inv_w_end[0] * jump_left
    return torch.movedim(moved, -1, axis)


def gradient(q, dmat, inv_w_end, jac):
    """BR1 gradient with central interface values, (..., C, 3)."""
    out = []
    for d in range(3):
        vol = deriv_along(q, dmat, d)
        q_l, q_r = traces(q, d)
        star = 0.5 * (q_l + q_r)
        lo, hi = faces(q, d)
        out.append(lift(vol, star - hi, to_left(star, d) - lo, d, inv_w_end)
                   * jac)
    return torch.stack(out, dim=-1)


def split_form_volume(prim, dmat, d):
    """out_i = sum_j 2 D_ij F#(u_i, u_j) along node axis d."""
    def pair(q, vec):
        moved = torch.movedim(q, q.ndim + NODE_AXIS[d] + (0 if vec else 1),
                              -2 if vec else -1)
        if vec:
            return moved[..., :, None, :], moved[..., None, :, :]
        return moved[..., :, None], moved[..., None, :]

    a, b = zip(*(pair(q, i == 1) for i, q in enumerate(prim)))
    out = 2.0 * torch.einsum("ij,...ijc->...ic", dmat,
                             kennedy_gruber(a, b, d))
    return torch.movedim(out, -2, NODE_AXIS[d] + out.ndim)


class Operators:
    """The float32 tables of one case on one device."""

    def __init__(self, case: Case, device):
        x, w = gll.nodes_weights(case.n_poly)
        self.d = torch.as_tensor(gll.derivative_matrix(case.n_poly),
                                 dtype=torch.float32, device=device)
        self.w = torch.as_tensor(w, dtype=torch.float32, device=device)
        self.inv_w_end = (float(1.0 / w[0]), float(1.0 / w[-1]))
        self.to_uniform = torch.as_tensor(gll.to_uniform_matrix(case.n_poly),
                                          dtype=torch.float32, device=device)
        n = case.n_grid
        k1 = np.fft.fftfreq(n, d=1.0 / n)
        kr = np.fft.rfftfreq(n, d=1.0 / n)
        kx, ky, kz = np.meshgrid(k1, k1, kr, indexing="ij")
        shells = np.rint(np.sqrt(kx**2 + ky**2 + kz**2)).astype(np.int32)
        self.n_shells = int(shells.max()) + 1
        self.shells = shells
        self.shell_onehot = torch.as_tensor(
            np.eye(self.n_shells, dtype=np.float32)[shells.reshape(-1)],
            device=device)
        self.half_weight = torch.as_tensor(
            np.where((kz == 0) | (2 * kz == n), 1.0, 2.0),
            dtype=torch.float32, device=device)
        self.k_vec = torch.as_tensor(np.stack([kx, ky, kz], axis=-1),
                                     dtype=torch.float32, device=device)
        self.off_nyquist = torch.as_tensor(
            np.all(np.abs(np.stack([kx, ky, kz], -1)) < n // 2, axis=-1,
                   keepdims=True), dtype=torch.complex64, device=device)
        self.e_dns = torch.as_tensor(reference_spectrum(case, self.n_shells),
                                     dtype=torch.float32, device=device)


def reference_spectrum(case: Case, n_shells: int) -> np.ndarray:
    """von Karman-Pao E_DNS(k) on the integer shells, summing to 3/2 u_rms^2."""
    k = np.arange(n_shells, dtype=np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        shape = (k / case.k_peak) ** 4 / (1.0 + (k / case.k_peak) ** 2) ** (
            17.0 / 6.0)
        spec = shape * np.exp(-2.0 * (k / case.k_eta) ** 2)
    spec = np.where(k > 0, spec, 0.0)
    return spec * (case.k_tke / max(np.sum(spec), 1e-300))


def rhs(u, cs_nodes, case: Case, ops: Operators):
    """-div(F_adv - F_visc) + forcing of a batch of periodic boxes."""
    rho, vel, p, temp = primitives(u)
    prim = (rho, vel, p, u[..., 4] / rho)
    grad = gradient(torch.cat([vel, temp[..., None]], dim=-1), ops.d,
                    ops.inv_w_end, case.jac)
    gv = grad[..., 0:3, :]
    s_ij = 0.5 * (gv + gv.transpose(-1, -2))
    s_mag = torch.sqrt(2.0 * torch.sum(s_ij * s_ij, dim=(-1, -2)) + 1e-30)
    nu_t = (cs_nodes * case.delta) ** 2 * s_mag
    out = None
    for d in range(3):
        vol_adv = split_form_volume(prim, ops.d, d)
        f_nodes = euler_flux(u, d)
        f_star_adv = llf_flux(*traces(u, d), d)
        f_visc = viscous_flux(u, grad, nu_t, case, d)
        vol_visc = deriv_along(f_visc, ops.d, d)
        fv_l, fv_r = traces(f_visc, d)
        f_star = f_star_adv - 0.5 * (fv_l + fv_r)
        lo, hi = faces(f_nodes - f_visc, d)
        div_d = lift(vol_adv - vol_visc, f_star - hi, to_left(f_star, d) - lo,
                     d, ops.inv_w_end) * case.jac
        out = -div_d if out is None else out - div_d
    return out + forcing(u, vel, case, ops)


def forcing(u, vel, case: Case, ops: Operators):
    """Lundgren linear forcing with the proportional TKE controller."""
    w2 = ops.w * 0.5
    n_elem = u.shape[-7] * u.shape[-6] * u.shape[-5]
    mom = u[..., 1:4]
    ke = 0.5 * torch.sum(mom * vel, dim=-1, keepdim=True)
    mom_mean = torch.einsum("...xyzijkc,i,j,k->...c", mom, w2, w2, w2) / n_elem
    k_now = torch.einsum("...xyzijkc,i,j,k->...c", ke, w2, w2, w2)[..., 0] \
        / n_elem
    fluct = mom - mom_mean[..., None, None, None, None, None, None, :]
    a_eff = case.forcing_a0 * torch.clamp(
        case.k_tke / torch.clamp_min(k_now, 0.1 * case.k_tke), 0.0, 3.0)
    f_mom = a_eff[..., None, None, None, None, None, None, None] * fluct
    f_e = torch.sum(f_mom * vel, dim=-1, keepdim=True)
    return torch.cat([torch.zeros_like(u[..., :1]), f_mom, f_e], dim=-1)


def advance(u, cs_elem, case: Case, ops: Operators):
    """Delta t_RL of RK5(4) substeps under per-element C_s (..., K, K, K)."""
    n = case.n
    cs_nodes = cs_elem[..., None, None, None].expand(
        cs_elem.shape + (n, n, n)).contiguous()
    dt = f32(case.dt)
    for _ in range(case.n_substeps):
        du = torch.zeros_like(u)
        for stage in range(5):
            du = f32(RK_A[stage]) * du + dt * rhs(u, cs_nodes, case, ops)
            u = u + f32(RK_B[stage]) * du
    return u


# --- spectra, reward, observation --------------------------------------------
def to_uniform(q, case: Case, ops: Operators):
    for off in range(3):
        axis = q.ndim - 4 + off
        q = torch.movedim(torch.movedim(q, axis, -1) @ ops.to_uniform.T, -1,
                          axis)
    nd = q.ndim
    q = q.permute(list(range(nd - 7)) + [nd - 7, nd - 4, nd - 6, nd - 3,
                                         nd - 5, nd - 2, nd - 1])
    m = case.n_grid
    return q.reshape(tuple(q.shape[: nd - 7]) + (m, m, m, q.shape[-1]))


def spectrum(vel_uniform, ops: Operators):
    n = vel_uniform.shape[-2]
    vhat = torch.fft.rfftn(vel_uniform, dim=(-4, -3, -2)) / (n**3)
    dens = 0.5 * torch.sum(torch.abs(vhat) ** 2, dim=-1) * ops.half_weight
    return dens.reshape(dens.shape[:-3] + (-1,)) @ ops.shell_onehot


def reward(vel, case: Case, ops: Operators):
    """Paper Eqs. (4)-(5): 2 exp(-l / alpha) - 1, l the mean relative
    squared spectrum error over 1 <= k <= k_max."""
    e_les = spectrum(to_uniform(vel, case, ops), ops)
    sl = slice(1, case.k_max + 1)
    ell = torch.mean(((ops.e_dns[sl] - e_les[..., sl]) / ops.e_dns[sl]) ** 2,
                     dim=-1)
    return 2.0 * torch.exp(-ell / case.alpha) - 1.0


def observe(u, case: Case):
    """Per-element velocity over u_rms, (..., K^3, n, n, n, 3)."""
    _, vel, _, _ = primitives(u)
    k, n = case.n_elem, case.n
    return vel.reshape(tuple(vel.shape[: vel.ndim - 7]) + (k**3, n, n, n, 3)) \
        / case.u_rms


def step(u, action, case: Case, ops: Operators):
    """One MDP transition -> (u_next, reward, obs_next).  A row whose
    advanced state is not finite keeps its state and gets the reward
    floor -1."""
    k = case.n_elem
    cs = torch.clamp(action, 0.0, case.cs_max).reshape(
        tuple(action.shape[:-1]) + (k, k, k))
    u_new = advance(u, cs, case, ops)
    finite = torch.isfinite(u_new).flatten(start_dim=u_new.ndim - 7).all(-1)
    u_new = torch.where(finite[..., None, None, None, None, None, None, None],
                        u_new, u)
    _, vel, _, _ = primitives(u_new)
    r = torch.where(finite, reward(vel, case, ops), torch.full_like(
        finite, -1.0, dtype=torch.float32))
    return u_new, r, observe(u_new, case)


# --- the initial-state bank ----------------------------------------------------
def _fourier_to_gll(case: Case) -> np.ndarray:
    x_gll, _ = gll.nodes_weights(case.n_poly)
    offsets = (np.arange(case.n_elem) + 0.5) * case.dx
    coords = (offsets[:, None] + 0.5 * case.dx * x_gll[None, :]).reshape(-1)
    return gll.fourier_eval_matrix(case.n_grid, coords, case.length)


def bank(gen: torch.Generator, case: Case, ops: Operators, n_states: int):
    """(n_states, K, K, K, n, n, n, 5): divergence-free Gaussian velocity
    fields with the E_DNS shell spectrum (Rogallo sampling) on the uniform
    grid, interpolated exactly to the GLL nodes, at rho0 and p0."""
    m = case.n_grid
    noise = torch.randn((n_states, m, m, m, 3), generator=gen,
                        device=gen.device, dtype=torch.float32)
    vhat = torch.fft.rfftn(noise, dim=(-4, -3, -2))
    k_sq = torch.sum(ops.k_vec**2, dim=-1, keepdim=True)
    k_sq = torch.where(k_sq == 0, torch.ones_like(k_sq), k_sq)
    vhat = vhat * ops.off_nyquist
    proj = vhat - ops.k_vec * torch.sum(ops.k_vec * vhat, dim=-1,
                                        keepdim=True) / k_sq
    dens = 0.5 * torch.sum(torch.abs(proj) ** 2, dim=-1) * ops.half_weight \
        / (m**6)
    e_now = dens.reshape(dens.shape[:-3] + (-1,)) @ ops.shell_onehot
    scale = torch.sqrt(ops.e_dns / torch.clamp_min(e_now, 1e-30))
    scale = torch.where(ops.e_dns > 0, scale, torch.zeros_like(scale))
    idx = torch.as_tensor(ops.shells, dtype=torch.long, device=noise.device)
    proj = proj * scale[..., idx][..., None]
    field = torch.fft.irfftn(proj, s=(m,) * 3, dim=(-4, -3, -2))
    mat = torch.as_tensor(_fourier_to_gll(case), dtype=torch.complex64,
                          device=noise.device)
    fhat = torch.fft.fftn(field, dim=(-4, -3, -2))
    for off in range(3):
        axis = fhat.ndim - 4 + off
        fhat = torch.movedim(torch.movedim(fhat, axis, -1) @ mat.T, -1, axis)
    vel = fhat.real
    k, n = case.n_elem, case.n
    vel = vel.reshape((n_states, k, n, k, n, k, n, 3)).permute(
        0, 1, 3, 5, 2, 4, 6, 7).contiguous()
    rho = torch.full(vel.shape[:-1], case.rho0, dtype=vel.dtype,
                     device=vel.device)
    p = torch.full(vel.shape[:-1], case.p0, dtype=vel.dtype, device=vel.device)
    return conservative(rho, vel, p)


# --- the random draws of an episode ------------------------------------------
def episode_draws(gen: torch.Generator, n_envs: int, bank_size: int,
                  n_actions: int, n_elements: int):
    """(bank rows, action noise (T, B, E)) in the order a fleet draws them."""
    idx = torch.randint(0, bank_size - 1, (n_envs,), generator=gen,
                        device=gen.device)
    noise = torch.randn((n_actions, n_envs, n_elements), generator=gen,
                        device=gen.device)
    return idx, noise


@functools.cache
def mixed_seed(seed: int, k: int) -> int:
    """A 63-bit generator seed mixed from (seed, k)."""
    return int(np.random.SeedSequence([seed, k]).generate_state(
        1, np.uint64)[0]) >> 1
