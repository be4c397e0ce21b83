"""Discontinuous-Galerkin spectral element (DGSEM) operators on a Cartesian
mesh, with per-direction boundary conditions (PyTorch port of
`repro.cfd.dgsem`).

Layout convention for nodal state arrays:

    u.shape = (..., Kx, Ky, Kz, n, n, n, C)

with element axes at positions (-7, -6, -5), intra-element GLL node axes at
(-4, -3, -2) and the channel axis last.  `...` carries the environment batch;
every operator is batch-transparent.

Face arrays are *right-face-indexed*: a trace/flux array for direction d has
the node axis of d removed, and entry e along the element axis of d holds the
face BETWEEN element e and element e+1.  `set_face` overwrites one domain
boundary face slab; `left_faces(f_right, d, lo_value=None)` converts to
left-face indexing, periodic by default (a roll), non-periodic when
`lo_value` overrides element 0's left face.  `dg_gradient`/`dg_divergence`
take an optional per-direction `bc` tuple built on these helpers.

A mesh split over ranks (`split`: its x-slabs, `core.collectives.
ElemSplit`, or x- and y-slabs, a `PencilSplit`) takes every periodic roll
along a split direction through that direction's split
(`split.along(direction)`), whose `roll` fetches the wrapped face slab
from the neighbouring rank; a direction that is not split, and every
direction with `split=None`, rolls by `torch.roll`.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import gll

ELEM_AXIS = (-7, -6, -5)
NODE_AXIS = (-4, -3, -2)


@dataclasses.dataclass(frozen=True)
class DGParams:
    """Static discretization parameters; operator matrices are numpy."""

    n_poly: int
    n_elem: int
    length: float = 2.0 * np.pi

    @property
    def n(self) -> int:
        return self.n_poly + 1

    @property
    def dx(self) -> float:
        return self.length / self.n_elem

    @property
    def jac(self) -> float:
        """d(xi)/dx: reference-to-physical scaling for derivatives."""
        return 2.0 / self.dx

    @property
    def n_dof_dir(self) -> int:
        return self.n_elem * self.n

    def nodes_weights(self) -> tuple[np.ndarray, np.ndarray]:
        return gll.gll_nodes_weights(self.n_poly)

    def deriv_matrix(self) -> np.ndarray:
        return gll.lagrange_derivative_matrix(self.n_poly)

    def node_coords(self) -> np.ndarray:
        """Physical coordinates of every GLL node, shape (K, n) per direction."""
        x_gll, _ = self.nodes_weights()
        offsets = (np.arange(self.n_elem) + 0.5) * self.dx
        return offsets[:, None] + 0.5 * self.dx * x_gll[None, :]


def deriv_along(u: torch.Tensor, d_matrix: torch.Tensor,
                direction: int) -> torch.Tensor:
    """out[..., i, ...] = sum_m D[i, m] u[..., m, ...] along node axis d."""
    axis = NODE_AXIS[direction] + u.ndim
    moved = torch.movedim(u, axis, -1)
    return torch.movedim(moved @ d_matrix.T, -1, axis)


def _face_slices(u: torch.Tensor, direction: int):
    """(u_at_node0, u_at_nodeN) along `direction`, node axis removed."""
    axis = NODE_AXIS[direction] + u.ndim
    return u.select(axis, 0), u.select(axis, u.shape[axis] - 1)


def _roll(x: torch.Tensor, shifts: int, axis: int, direction: int,
          split) -> torch.Tensor:
    """The periodic roll of a face array along `direction`'s element axis:
    through the split of that direction where `split` splits it, else
    `torch.roll`."""
    along = split.along(direction) if split is not None else None
    if along is not None:
        return along.roll(x, shifts, axis)
    return torch.roll(x, shifts=shifts, dims=axis)


def neighbor_traces(u: torch.Tensor, direction: int, split=None):
    """States meeting at the right face of every element along `direction`:
    (node-N trace of e, node-0 trace of e+1), periodic wrap."""
    lo, hi = _face_slices(u, direction)
    elem_axis = ELEM_AXIS[direction] + lo.ndim + 1  # one axis was dropped
    return hi, _roll(lo, -1, elem_axis, direction, split)


def set_face(face_arr: torch.Tensor, direction: int, index: int,
             value: torch.Tensor) -> torch.Tensor:
    """Copy of a face-indexed array with one domain-boundary face slab
    replaced (`index` -1: the +L face of a right-face-indexed array; 0: the
    -0 face of a left-face-indexed one)."""
    axis = ELEM_AXIS[direction] + face_arr.ndim + 1
    out = face_arr.clone()
    out.select(axis, index).copy_(
        torch.broadcast_to(value, out.select(axis, index).shape))
    return out


def left_faces(f_right: torch.Tensor, direction: int,
               lo_value: torch.Tensor | None = None,
               split=None) -> torch.Tensor:
    """Right-face-indexed -> left-face-indexed along `direction`; periodic
    unless `lo_value` prescribes the -0 domain face."""
    axis = ELEM_AXIS[direction] + f_right.ndim + 1
    out = _roll(f_right, 1, axis, direction, split)
    if lo_value is not None:
        out = set_face(out, direction, 0, lo_value)
    return out


def _per_direction_jac(dg: DGParams | None, jac) -> tuple:
    if jac is None:
        if dg is None:
            raise ValueError("pass jac= (scalar or per-direction) when no "
                             "DGParams is given")
        return (dg.jac,) * 3
    if isinstance(jac, (tuple, list)):
        return tuple(jac)
    return (jac,) * 3


def surface_lift(du: torch.Tensor, flux_jump_right: torch.Tensor,
                 flux_jump_left: torch.Tensor, direction: int,
                 inv_w_end: tuple[float, float]) -> torch.Tensor:
    """du_i += (delta_iN / w_N) (F* - F)_right - (delta_i0 / w_0) (F* - F)_left"""
    axis = NODE_AXIS[direction] + du.ndim
    moved = torch.movedim(du, axis, -1).clone()
    inv_w0, inv_wn = inv_w_end
    moved[..., -1] += inv_wn * flux_jump_right
    moved[..., 0] += -inv_w0 * flux_jump_left
    return torch.movedim(moved, -1, axis)


def dg_gradient(q: torch.Tensor, dg: DGParams | None, d_matrix: torch.Tensor,
                inv_w_end: tuple[float, float], vol_derivs=None, *,
                jac=None, bc: tuple | None = None,
                split=None) -> torch.Tensor:
    """BR1-style DG gradient of nodal field q (..., K,K,K, n,n,n, C) with
    central interface values; returns (..., C, 3).  `bc[d]` is None
    (periodic) or `(q_lo, q_hi)` prescribed boundary face states; `split`
    the split of the periodic directions it splits (x, or x and y)."""
    jacs = _per_direction_jac(dg, jac)
    grads = []
    for d in range(3):
        vol = deriv_along(q, d_matrix, d) if vol_derivs is None else vol_derivs[d]
        q_left, q_right = neighbor_traces(q, d, split)
        q_star_right = 0.5 * (q_left + q_right)
        lo, hi = _face_slices(q, d)
        bc_d = bc[d] if bc is not None else None
        if bc_d is not None:
            q_star_right = set_face(q_star_right, d, -1, bc_d[1])
        q_star_left = left_faces(q_star_right, d,
                                 lo_value=bc_d[0] if bc_d is not None else None,
                                 split=split)
        g = surface_lift(vol, q_star_right - hi, q_star_left - lo, d, inv_w_end)
        grads.append(g * jacs[d])
    return torch.stack(grads, dim=-1)


def flux_differencing(prim: tuple, two_point_flux, d_matrix: torch.Tensor,
                      direction: int) -> torch.Tensor:
    """Split-form volume integral:  out_i = sum_j 2 D_ij F#(u_i, u_j)."""
    def pairwise(q, is_vec):
        a = q.ndim + NODE_AXIS[direction] + (0 if is_vec else 1)
        moved = torch.movedim(q, a, -2 if is_vec else -1)
        if is_vec:  # (..., m, C) -> (..., m_i, m_j, C)
            return moved[..., :, None, :], moved[..., None, :, :]
        return moved[..., :, None], moved[..., None, :]

    rho, vel, p, e = prim
    rho_a, rho_b = pairwise(rho, False)
    vel_a, vel_b = pairwise(vel, True)
    p_a, p_b = pairwise(p, False)
    e_a, e_b = pairwise(e, False)
    f_pair = two_point_flux((rho_a, vel_a, p_a, e_a), (rho_b, vel_b, p_b, e_b),
                            direction)
    out = 2.0 * torch.einsum("ij,...ijc->...ic", d_matrix, f_pair)
    return torch.movedim(out, -2, NODE_AXIS[direction] + out.ndim)


def dg_divergence(fluxes: tuple, fluxes_star: tuple, dg: DGParams | None,
                  d_matrix: torch.Tensor, inv_w_end: tuple[float, float], *,
                  jac=None, bc: tuple | None = None) -> torch.Tensor:
    """Strong-form DG divergence with prescribed interface fluxes; returns
    -div(F) in physical coordinates.  `bc[d]` is None or `(f_lo, f_hi)`
    prescribed boundary numerical fluxes."""
    jacs = _per_direction_jac(dg, jac)
    out = None
    for d in range(3):
        vol = deriv_along(fluxes[d], d_matrix, d)
        lo, hi = _face_slices(fluxes[d], d)
        f_star_right = fluxes_star[d]
        bc_d = bc[d] if bc is not None else None
        if bc_d is not None:
            f_star_right = set_face(f_star_right, d, -1, bc_d[1])
        f_star_left = left_faces(f_star_right, d,
                                 lo_value=bc_d[0] if bc_d is not None else None)
        div_d = surface_lift(vol, f_star_right - hi, f_star_left - lo, d,
                             inv_w_end) * jacs[d]
        out = div_d if out is None else out + div_d
    return -out


def quadrature_mean(q: torch.Tensor, dg: DGParams) -> torch.Tensor:
    """Volume average over the whole box: (..., Kx,Ky,Kz, n,n,n, C) -> (..., C)."""
    _, w = dg.nodes_weights()
    w = torch.as_tensor(w, dtype=q.dtype, device=q.device) * 0.5
    n_elem_total = q.shape[-7] * q.shape[-6] * q.shape[-5]
    q = torch.einsum("...xyzijkc,i,j,k->...c", q, w, w, w)
    return q / n_elem_total
