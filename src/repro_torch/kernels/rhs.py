"""One fused periodic-HIT Navier-Stokes RHS evaluation: the CUDA kernels
(`csrc/ns_rhs_cluster.cu`, `csrc/ns_rhs.cu`) and their plain PyTorch
version.

`fused_navier_stokes_rhs` replaces the Pallas TPU kernel
`repro/kernels/rhs.py:fused_navier_stokes_rhs`; `navier_stokes_rhs_plain` is
the port of its oracle `repro/kernels/ref.py:navier_stokes_rhs_fused`.  The
dispatch follows the tensor's device: a CPU tensor takes the plain version, a
CUDA tensor launches a kernel or raises.  Two instances, picked by shape
(`pick_instance`): "cluster" (one launch, one thread-block cluster per mesh,
faces through distributed shared memory) wherever `cluster_plan` finds a
plan, "two_pass" (two launches joined by a global scratch) for meshes too
large for a cluster of 16 CTAs.  `fused_navier_stokes_rhs.launches` counts
the calls that launched a kernel, `.instance_launches` the same by instance.

Pipeline (the JAX oracle's op order): primitive decode -> BR1 gradient of
(v, T) -> Smagorinsky nu_t -> per direction, split-form Kennedy-Gruber volume
+ LLF surface + BR1 viscous divergence -> whole-box quadrature-mean Lundgren
forcing.  All math in float32; the result has u's dtype (bf16 in/out for the
mixed-precision rollout).
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from ..cfd import dgsem, equations
from . import _build

SOURCES = {"cluster": "ns_rhs_cluster.cu", "two_pass": "ns_rhs.cu"}
N_MAX = 8  # the kernels hold at most 8^3 nodes of an element in one block
_SCRATCH = 13  # gradient entries + nu_t per node in the two-pass scratch
MAX_CTAS = 16  # CTAs of a cluster (a non-portable size above 8)
MAX_THREADS = 256  # threads of a cluster-kernel CTA
MAX_SMEM_BYTES = _build.SMEM_OPTIN_BYTES  # dynamic shared memory of a block
# 4-byte values the cluster kernel keeps in shared memory per node
# (primitives 7, viscous fluxes 12, RHS 5), per face node (lift jumps 10
# per direction) and per element (its index and its 9 neighbour entries),
# as `smem_floats` in csrc/ns_rhs_cluster.cu
_NODE_FLOATS, _FACE_FLOATS, _ELEM_INTS = 7 + 12 + 5, 3 * 10, 10
_MAX_WARPS = MAX_THREADS // 32


def plain_gradients(q_prim: torch.Tensor, cs_nodes: torch.Tensor,
                    d_matrix: torch.Tensor, inv_w_end: tuple[float, float], *,
                    jac: float, delta: float, split=None):
    """BR1 gradient of (v, T) (..., 4, 3) and Smagorinsky nu_t."""
    grad_prim = dgsem.dg_gradient(q_prim, None, d_matrix, inv_w_end, jac=jac,
                                  split=split)
    s_mag = equations.strain_magnitude(
        equations.strain_rate(grad_prim[..., 0:3, :]))
    return grad_prim, equations.eddy_viscosity(cs_nodes, delta, s_mag)


def plain_divergence(u: torch.Tensor, prim: tuple, grad_prim: torch.Tensor,
                     nu_t: torch.Tensor, d_matrix: torch.Tensor,
                     inv_w_end: tuple[float, float], *, jac,
                     gas: equations.GasParams,
                     wall: tuple | None = None, split=None) -> torch.Tensor:
    """-div(F_adv - F_visc) over the three directions: split-form volume,
    LLF + BR1-central surfaces.  `jac` is a scalar or one per direction.
    Periodic, unless `wall = (g_lo, g_hi)` gives the numerical fluxes of the
    two y domain faces (the channel's walls).  On a mesh split over ranks
    (`split`: x-slabs, or x- and y-slabs) the faces of each split direction
    cross ranks three times: the LLF traces of u, the viscous-flux traces
    and the left faces of F*."""
    jacs = jac if isinstance(jac, (tuple, list)) else (jac,) * 3
    rhs = None
    for d in range(3):
        vol_adv = dgsem.flux_differencing(
            prim, equations.kennedy_gruber_flux, d_matrix, d)
        f_adv_nodes = equations.advective_flux(u, d)
        f_star_adv = equations.lax_friedrichs_flux(
            *dgsem.neighbor_traces(u, d, split), d)
        f_visc = equations.viscous_flux(u, grad_prim, nu_t, gas, d)
        vol_visc = dgsem.deriv_along(f_visc, d_matrix, d)
        fv_left, fv_right = dgsem.neighbor_traces(f_visc, d, split)
        f_star = f_star_adv - 0.5 * (fv_left + fv_right)
        lo_value = None
        if wall is not None and d == 1:
            # non-periodic y: the wrapped faces are the wall fluxes
            f_star = dgsem.set_face(f_star, d, -1, wall[1])
            lo_value = wall[0]
        lo, hi = dgsem._face_slices(f_adv_nodes - f_visc, d)
        div_d = dgsem.surface_lift(
            vol_adv - vol_visc, f_star - hi,
            dgsem.left_faces(f_star, d, lo_value=lo_value, split=split) - lo,
            d,
            inv_w_end) * jacs[d]
        rhs = -div_d if rhs is None else rhs - div_d
    return rhs


def plain_forcing(u: torch.Tensor, vel: torch.Tensor, w: torch.Tensor, *,
                  forcing_a0: float, k_tke: float,
                  split=None) -> torch.Tensor:
    """Lundgren linear forcing with the proportional TKE controller, from
    whole-box quadrature means with the GLL weights `w`.  On a mesh split
    over ranks (`split`: x-slabs, or an x by y pencil) the local quadrature
    sums (momentum 3, kinetic energy 1 a row) are summed over every rank of
    the split (one all-reduce, or one per axis of a pencil) and divided by
    the whole box's element count, `split.size` blocks of the local one."""
    w2 = w.to(u.dtype) * 0.5  # reference [-1,1] -> unit mass
    n_elem_total = u.shape[-7] * u.shape[-6] * u.shape[-5]
    mom = u[..., 1:4]
    ke_density = 0.5 * torch.sum(mom * vel, dim=-1, keepdim=True)
    mom_sum = torch.einsum("...xyzijkc,i,j,k->...c", mom, w2, w2, w2)
    k_sum = torch.einsum("...xyzijkc,i,j,k->...c", ke_density, w2, w2, w2)
    if split is not None:
        sums = split.all_reduce_(torch.cat([mom_sum, k_sum], dim=-1))
        mom_sum, k_sum = sums[..., :3], sums[..., 3:]
        n_elem_total *= split.size
    mom_mean = mom_sum / n_elem_total
    mom_fluct = mom - mom_mean[..., None, None, None, None, None, None, :]
    k_now = k_sum[..., 0] / n_elem_total
    a_eff = forcing_a0 * torch.clamp(
        k_tke / torch.clamp_min(k_now, 0.1 * k_tke), 0.0, 3.0)
    f_mom = a_eff[..., None, None, None, None, None, None, None] * mom_fluct
    f_e = torch.sum(f_mom * vel, dim=-1, keepdim=True)
    return torch.cat([torch.zeros_like(u[..., :1]), f_mom, f_e], dim=-1)


def plain_rhs(u: torch.Tensor, cs_nodes: torch.Tensor, d_matrix: torch.Tensor,
              w: torch.Tensor, *, inv_w_end: tuple[float, float], jac: float,
              delta: float, gas: equations.GasParams, forcing_a0: float,
              k_tke: float, split=None,
              gradients=plain_gradients) -> torch.Tensor:
    """The three parts composed, in the dtype of the inputs.  `gradients`
    computes the gradient and nu_t (`solver.kernel_grad_nut` puts the
    component kernels there); `split` is the split of a mesh over ranks
    (x-slabs, or an x by y pencil), whose faces cross ranks 5 times along
    each split direction (twice in the gradient, three times in the
    divergence) and whose box sums once (once per axis of a pencil)."""
    rho, vel, p, temp = equations.conservative_to_primitive(u)
    prim = (rho, vel, p, u[..., 4] / rho)
    q_prim = torch.cat([vel, temp[..., None]], dim=-1)
    grad_prim, nu_t = gradients(q_prim, cs_nodes, d_matrix, inv_w_end,
                                jac=jac, delta=delta, split=split)
    rhs = plain_divergence(u, prim, grad_prim, nu_t, d_matrix, inv_w_end,
                           jac=jac, gas=gas, split=split)
    return rhs + plain_forcing(u, vel, w, forcing_a0=forcing_a0, k_tke=k_tke,
                               split=split)


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


_ARGTYPES = ((ctypes.c_void_p,) * 7 + (ctypes.c_int,) * 6
             + (ctypes.c_float,) * 9 + (ctypes.c_void_p,))
_ARGTYPES_CLUSTER = ((ctypes.c_void_p,) * 5 + (ctypes.c_int,) * 10
                     + (ctypes.c_float,) * 9 + (ctypes.c_void_p,))


class ClusterPlan(NamedTuple):
    """How the cluster kernel lays out one mesh: a grid of px x py x pz CTAs,
    each holding a (Kx/px, Ky/py, Kz/pz) block of elements."""
    px: int
    py: int
    pz: int
    threads: int
    smem_bytes: int

    @property
    def ctas(self) -> int:
        return self.px * self.py * self.pz


def cluster_smem_bytes(n: int, elements: int) -> int:
    """Dynamic shared memory of one CTA of the cluster kernel holding
    `elements` elements of n^3 nodes (`smem_floats` in the source)."""
    floats = (_NODE_FLOATS * elements * n**3 + _FACE_FLOATS * elements * n * n
              + n * n + 4 * _MAX_WARPS + 8 + _ELEM_INTS * elements)
    return 4 * floats


def _divisors(k: int) -> list[int]:
    return [p for p in range(1, k + 1) if k % p == 0]


@functools.cache
def cluster_plan(kx: int, ky: int, kz: int, n: int,
                 dtype: torch.dtype) -> ClusterPlan | None:
    """The cluster kernel's layout of a Kx x Ky x Kz mesh of n^3-node
    elements, or None where no cluster of at most 16 CTAs holds the mesh in
    shared memory.  The most CTAs (the kernel is latency-bound: more SMs,
    smaller blocks that share an SM), each p dividing its K; among those the
    most compact block (least surface), then the smallest (px, py, pz).  One
    thread per node of the block, rounded up to whole warps, at most 256.
    The layout does not depend on `dtype` (float32 inside)."""
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"fused RHS kernel takes float32 or bfloat16, "
                        f"got {dtype}")
    if not 2 <= n <= N_MAX:
        return None
    best = None
    for px in _divisors(kx):
        for py in _divisors(ky):
            for pz in _divisors(kz):
                if px * py * pz > MAX_CTAS:
                    continue
                sx, sy, sz = kx // px, ky // py, kz // pz
                smem = cluster_smem_bytes(n, sx * sy * sz)
                if smem > MAX_SMEM_BYTES:
                    continue
                key = (-px * py * pz, sx * sy + sy * sz + sx * sz, px, py, pz)
                if best is None or key < best[0]:
                    nodes = sx * sy * sz * n**3
                    threads = min(MAX_THREADS, 32 * -(-nodes // 32))
                    best = (key, ClusterPlan(px, py, pz, threads, smem))
    return None if best is None else best[1]


def pick_instance(shape: tuple, dtype: torch.dtype) -> str:
    """The kernel that takes a CUDA tensor u of `shape` and `dtype`:
    "cluster" where `cluster_plan` finds a plan, else "two_pass"."""
    kx, ky, kz, n = shape[-7], shape[-6], shape[-5], shape[-2]
    return "cluster" if cluster_plan(kx, ky, kz, n, dtype) else "two_pass"


def _resolve_instance(shape: tuple, dtype: torch.dtype,
                      instance: str | None) -> str:
    """`instance` as asked (None: by shape); raises on an unknown name and on
    "cluster" for a mesh that has no cluster plan."""
    if instance is None:
        return pick_instance(shape, dtype)
    if instance not in SOURCES:
        raise ValueError(f"no fused RHS instance {instance!r}; have "
                         f"{sorted(SOURCES)}")
    if instance == "cluster" and pick_instance(shape, dtype) != "cluster":
        raise ValueError(f"no cluster plan for a mesh of shape "
                         f"{tuple(shape)}: it needs more than {MAX_CTAS} "
                         f"CTAs of {MAX_SMEM_BYTES} bytes")
    return instance


@functools.cache
def max_active_clusters(kx: int, ky: int, kz: int, n: int,
                        dtype: torch.dtype) -> int:
    """How many clusters of this mesh's plan the current CUDA device holds
    at once (cudaOccupancyMaxActiveClusters)."""
    plan = cluster_plan(kx, ky, kz, n, dtype)
    if plan is None:
        raise ValueError(f"no cluster plan for {kx}x{ky}x{kz} elements of "
                         f"n={n}")
    lib = _build.load(SOURCES["cluster"])
    fn = lib.ns_rhs_cluster_max_active_clusters
    fn.argtypes = [ctypes.c_int] * 9 + [ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    count = ctypes.c_int(0)
    rc = fn(kx, ky, kz, n, plan.px, plan.py, plan.pz, plan.threads,
            int(dtype == torch.bfloat16), ctypes.byref(count))
    if rc != 0:
        err = lib.ns_rhs_cluster_error_string
        err.argtypes, err.restype = [ctypes.c_int], ctypes.c_char_p
        raise RuntimeError(f"cudaOccupancyMaxActiveClusters failed: "
                           f"{err(rc).decode()} ({rc})")
    return count.value


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
                            k_tke: float,
                            instance: str | None = None) -> torch.Tensor:
    """Fused RHS for a batch of HIT meshes; same contract as the plain
    version.  CPU tensors take the plain version; CUDA tensors launch a
    kernel or raise: the instance `pick_instance` gives for u's shape, or
    the one named by `instance` ("cluster" or "two_pass", for comparing
    the two)."""
    kw = dict(inv_w_end=inv_w_end, jac=jac, delta=delta, mu=mu,
              prandtl=prandtl, prandtl_turb=prandtl_turb,
              forcing_a0=forcing_a0, k_tke=k_tke)
    if u.device.type == "cpu":
        return navier_stokes_rhs_plain(u, cs_nodes, d_matrix, w, **kw)
    if u.device.type != "cuda":
        raise ValueError(f"no fused RHS for device {u.device}")
    n = _check_inputs(u, cs_nodes, d_matrix, w)
    kind = _resolve_instance(u.shape, u.dtype, instance)
    kx, ky, kz = u.shape[-7:-4]
    batch = u.numel() // (kx * ky * kz * n**3 * 5)
    out = torch.empty_like(u)
    if batch == 0:
        return out
    d32 = d_matrix.to(torch.float32).contiguous()
    w32 = w.to(torch.float32).contiguous()
    scalars = (float(inv_w_end[0]), float(inv_w_end[1]), float(jac),
               float(delta), float(mu), float(prandtl), float(prandtl_turb),
               float(forcing_a0), float(k_tke))
    is_bf16 = int(u.dtype == torch.bfloat16)
    stream = torch.cuda.current_stream(u.device).cuda_stream
    if kind == "cluster":
        plan = cluster_plan(kx, ky, kz, n, u.dtype)
        if max_active_clusters(kx, ky, kz, n, u.dtype) == 0:
            raise RuntimeError(f"the device cannot hold one cluster of "
                               f"{plan.ctas} CTAs with {plan.smem_bytes} "
                               f"bytes of shared memory each ({plan})")
        _build.launcher(SOURCES[kind], "ns_rhs_cluster", _ARGTYPES_CLUSTER)(
            u.data_ptr(), cs_nodes.data_ptr(), d32.data_ptr(),
            w32.data_ptr(), out.data_ptr(), batch, kx, ky, kz, n, plan.px,
            plan.py, plan.pz, plan.threads, is_bf16, *scalars, stream)
    else:
        n_blocks = batch * kx * ky * kz
        scratch = torch.empty((n_blocks, _SCRATCH, n**3),
                              dtype=torch.float32, device=u.device)
        partials = torch.empty((n_blocks, 4), dtype=torch.float32,
                               device=u.device)
        _build.launcher(SOURCES[kind], "ns_rhs", _ARGTYPES)(
            u.data_ptr(), cs_nodes.data_ptr(), d32.data_ptr(),
            w32.data_ptr(), scratch.data_ptr(), partials.data_ptr(),
            out.data_ptr(), batch, kx, ky, kz, n, is_bf16, *scalars, stream)
    fused_navier_stokes_rhs.launches += 1
    fused_navier_stokes_rhs.instance_launches[kind] += 1
    return out


fused_navier_stokes_rhs.launches = 0
fused_navier_stokes_rhs.instance_launches = dict.fromkeys(SOURCES, 0)
