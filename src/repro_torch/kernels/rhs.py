"""One fused periodic-HIT Navier-Stokes RHS evaluation: the CUDA kernel
(`csrc/ns_rhs.cu`) and its plain PyTorch version.

`fused_navier_stokes_rhs` replaces the Pallas TPU kernel
`repro/kernels/rhs.py:fused_navier_stokes_rhs`; `navier_stokes_rhs_plain` is
the port of its oracle `repro/kernels/ref.py:navier_stokes_rhs_fused`.  The
dispatch follows the tensor's device: a CPU tensor takes the plain version, a
CUDA tensor launches the kernel or raises.  `fused_navier_stokes_rhs.launches`
counts the calls that launched the kernel.

Pipeline (the JAX oracle's op order): primitive decode -> BR1 gradient of
(v, T) -> Smagorinsky nu_t -> per direction, split-form Kennedy-Gruber volume
+ LLF surface + BR1 viscous divergence -> whole-box quadrature-mean Lundgren
forcing.  All math in float32; the result has u's dtype (bf16 in/out for the
mixed-precision rollout).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ..cfd import dgsem, equations
from . import _build

_SOURCE = "ns_rhs.cu"
N_MAX = 8  # the kernel holds at most 8^3 nodes of an element in one block
_SCRATCH = 13  # gradient entries + nu_t per node in the kernel's scratch


def plain_gradients(q_prim: torch.Tensor, cs_nodes: torch.Tensor,
                    d_matrix: torch.Tensor, inv_w_end: tuple[float, float], *,
                    jac: float, delta: float):
    """BR1 gradient of (v, T) (..., 4, 3) and Smagorinsky nu_t."""
    grad_prim = dgsem.dg_gradient(q_prim, None, d_matrix, inv_w_end, jac=jac)
    s_mag = equations.strain_magnitude(
        equations.strain_rate(grad_prim[..., 0:3, :]))
    return grad_prim, equations.eddy_viscosity(cs_nodes, delta, s_mag)


def plain_divergence(u: torch.Tensor, prim: tuple, grad_prim: torch.Tensor,
                     nu_t: torch.Tensor, d_matrix: torch.Tensor,
                     inv_w_end: tuple[float, float], *, jac: float,
                     gas: equations.GasParams) -> torch.Tensor:
    """-div(F_adv - F_visc) over the three directions: split-form volume,
    LLF + BR1-central surfaces, periodic."""
    rhs = None
    for d in range(3):
        vol_adv = dgsem.flux_differencing(
            prim, equations.kennedy_gruber_flux, d_matrix, d)
        f_adv_nodes = equations.advective_flux(u, d)
        f_star_adv = equations.lax_friedrichs_flux(
            *dgsem.neighbor_traces(u, d), d)
        f_visc = equations.viscous_flux(u, grad_prim, nu_t, gas, d)
        vol_visc = dgsem.deriv_along(f_visc, d_matrix, d)
        fv_left, fv_right = dgsem.neighbor_traces(f_visc, d)
        f_star = f_star_adv - 0.5 * (fv_left + fv_right)
        lo, hi = dgsem._face_slices(f_adv_nodes - f_visc, d)
        div_d = dgsem.surface_lift(vol_adv - vol_visc, f_star - hi,
                                   dgsem.left_faces(f_star, d) - lo, d,
                                   inv_w_end) * jac
        rhs = -div_d if rhs is None else rhs - div_d
    return rhs


def plain_forcing(u: torch.Tensor, vel: torch.Tensor, w: torch.Tensor, *,
                  forcing_a0: float, k_tke: float) -> torch.Tensor:
    """Lundgren linear forcing with the proportional TKE controller, from
    whole-box quadrature means with the GLL weights `w`."""
    w2 = w.to(u.dtype) * 0.5  # reference [-1,1] -> unit mass
    n_elem_total = u.shape[-7] * u.shape[-6] * u.shape[-5]
    mom = u[..., 1:4]
    mom_mean = torch.einsum("...xyzijkc,i,j,k->...c", mom, w2, w2,
                            w2) / n_elem_total
    mom_fluct = mom - mom_mean[..., None, None, None, None, None, None, :]
    ke_density = 0.5 * torch.sum(mom * vel, dim=-1, keepdim=True)
    k_now = torch.einsum("...xyzijkc,i,j,k->...c", ke_density, w2, w2,
                         w2)[..., 0] / n_elem_total
    a_eff = forcing_a0 * torch.clamp(
        k_tke / torch.clamp_min(k_now, 0.1 * k_tke), 0.0, 3.0)
    f_mom = a_eff[..., None, None, None, None, None, None, None] * mom_fluct
    f_e = torch.sum(f_mom * vel, dim=-1, keepdim=True)
    return torch.cat([torch.zeros_like(u[..., :1]), f_mom, f_e], dim=-1)


def plain_rhs(u: torch.Tensor, cs_nodes: torch.Tensor, d_matrix: torch.Tensor,
              w: torch.Tensor, *, inv_w_end: tuple[float, float], jac: float,
              delta: float, gas: equations.GasParams, forcing_a0: float,
              k_tke: float) -> torch.Tensor:
    """The three parts composed, in the dtype of the inputs."""
    rho, vel, p, temp = equations.conservative_to_primitive(u)
    prim = (rho, vel, p, u[..., 4] / rho)
    q_prim = torch.cat([vel, temp[..., None]], dim=-1)
    grad_prim, nu_t = plain_gradients(q_prim, cs_nodes, d_matrix, inv_w_end,
                                      jac=jac, delta=delta)
    rhs = plain_divergence(u, prim, grad_prim, nu_t, d_matrix, inv_w_end,
                           jac=jac, gas=gas)
    return rhs + plain_forcing(u, vel, w, forcing_a0=forcing_a0, k_tke=k_tke)


def navier_stokes_rhs_plain(u: torch.Tensor, cs_nodes: torch.Tensor,
                            d_matrix: torch.Tensor, w: torch.Tensor, *,
                            inv_w_end: tuple[float, float], jac: float,
                            delta: float, mu: float, prandtl: float,
                            prandtl_turb: float, forcing_a0: float,
                            k_tke: float) -> torch.Tensor:
    """Plain PyTorch version of the fused RHS: float32 math whatever the
    I/O dtype, as the kernel does.

    u: (..., Kx, Ky, Kz, n, n, n, 5); cs_nodes shaped like u[..., 0];
    d_matrix (n, n); w (n,) GLL weights.  Returns the RHS in u's dtype.
    """
    f32 = torch.float32
    gas = equations.GasParams(mu=mu, prandtl=prandtl,
                              prandtl_turb=prandtl_turb)
    rhs = plain_rhs(u.to(f32), cs_nodes.to(f32), d_matrix.to(f32), w.to(f32),
                    inv_w_end=inv_w_end, jac=jac, delta=delta, gas=gas,
                    forcing_a0=forcing_a0, k_tke=k_tke)
    return rhs.to(u.dtype)


@functools.cache
def _library() -> ctypes.CDLL:
    """The kernel's library, built at first use, with its C signatures."""
    lib = _build.load(_SOURCE)
    lib.ns_rhs_launch.argtypes = (
        [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6
        + [ctypes.c_float] * 9 + [ctypes.c_void_p])
    lib.ns_rhs_launch.restype = ctypes.c_int
    lib.ns_rhs_error_string.argtypes = [ctypes.c_int]
    lib.ns_rhs_error_string.restype = ctypes.c_char_p
    return lib


def _check_inputs(u, cs_nodes, d_matrix, w) -> int:
    """Raise on anything the kernel does not take; returns n."""
    if u.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"fused RHS kernel takes float32 or bfloat16, "
                        f"got {u.dtype}")
    if u.ndim < 7 or u.shape[-1] != 5:
        raise ValueError(f"u must be (..., Kx, Ky, Kz, n, n, n, 5), "
                         f"got {tuple(u.shape)}")
    n = u.shape[-2]
    if not (u.shape[-4] == u.shape[-3] == n and 2 <= n <= N_MAX):
        raise ValueError(f"the kernel takes n x n x n elements with "
                         f"2 <= n <= {N_MAX}, got {tuple(u.shape[-4:-1])}")
    if cs_nodes.shape != u.shape[:-1] or cs_nodes.dtype != u.dtype:
        raise ValueError(f"cs_nodes must be {tuple(u.shape[:-1])} {u.dtype}, "
                         f"got {tuple(cs_nodes.shape)} {cs_nodes.dtype}")
    if tuple(d_matrix.shape) != (n, n) or tuple(w.shape) != (n,):
        raise ValueError(f"d_matrix must be ({n}, {n}) and w ({n},)")
    for name, t in (("u", u), ("cs_nodes", cs_nodes), ("d_matrix", d_matrix),
                    ("w", w)):
        if t.device != u.device:
            raise ValueError(f"{name} is on {t.device}, u on {u.device}")
    if not (u.is_contiguous() and cs_nodes.is_contiguous()):
        raise ValueError("u and cs_nodes must be contiguous")
    return n


def fused_navier_stokes_rhs(u: torch.Tensor, cs_nodes: torch.Tensor,
                            d_matrix: torch.Tensor, w: torch.Tensor, *,
                            inv_w_end: tuple[float, float], jac: float,
                            delta: float, mu: float, prandtl: float,
                            prandtl_turb: float, forcing_a0: float,
                            k_tke: float) -> torch.Tensor:
    """Fused RHS for a batch of HIT meshes; same contract as the plain
    version.  CPU tensors take the plain version; CUDA tensors launch the
    kernel (two passes, see csrc/ns_rhs.cu) or raise."""
    kw = dict(inv_w_end=inv_w_end, jac=jac, delta=delta, mu=mu,
              prandtl=prandtl, prandtl_turb=prandtl_turb,
              forcing_a0=forcing_a0, k_tke=k_tke)
    if u.device.type == "cpu":
        return navier_stokes_rhs_plain(u, cs_nodes, d_matrix, w, **kw)
    if u.device.type != "cuda":
        raise ValueError(f"no fused RHS for device {u.device}")
    n = _check_inputs(u, cs_nodes, d_matrix, w)
    kx, ky, kz = u.shape[-7:-4]
    batch = u.numel() // (kx * ky * kz * n**3 * 5)
    out = torch.empty_like(u)
    if batch == 0:
        return out
    d32 = d_matrix.to(torch.float32).contiguous()
    w32 = w.to(torch.float32).contiguous()
    n_blocks = batch * kx * ky * kz
    scratch = torch.empty((n_blocks, _SCRATCH, n**3), dtype=torch.float32,
                          device=u.device)
    partials = torch.empty((n_blocks, 4), dtype=torch.float32,
                           device=u.device)
    lib = _library()
    stream = torch.cuda.current_stream(u.device).cuda_stream
    rc = lib.ns_rhs_launch(
        u.data_ptr(), cs_nodes.data_ptr(), d32.data_ptr(), w32.data_ptr(),
        scratch.data_ptr(), partials.data_ptr(), out.data_ptr(),
        batch, kx, ky, kz, n, int(u.dtype == torch.bfloat16),
        float(inv_w_end[0]), float(inv_w_end[1]), float(jac), float(delta),
        float(mu), float(prandtl), float(prandtl_turb), float(forcing_a0),
        float(k_tke), stream)
    if rc != 0:
        raise RuntimeError(f"fused RHS kernel launch failed: "
                           f"{lib.ns_rhs_error_string(rc).decode()} ({rc})")
    fused_navier_stokes_rhs.launches += 1
    return out


fused_navier_stokes_rhs.launches = 0
