"""PyTorch port vs JAX reference: GLL operators, DGSEM operators and the
Navier-Stokes physics at float32 (including the prescribed-face `bc=` path).

Inputs are made with numpy from a seed and go through both packages.
Tolerance: both packages evaluate the same float32 formulas in a different
summation order (XLA vs ATen matmul/einsum), so results agree to a few
float32 ulps of the largest value; `rtol=atol=1e-5` relative to the
reference's magnitude sits well above that.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.cfd import dgsem as jdg
from repro.cfd import equations as jeq
from repro.cfd import gll as jgll
from repro_torch.cfd import dgsem as tdg
from repro_torch.cfd import equations as teq
from repro_torch.cfd import gll as tgll

TOL = 1e-5


def _close(got, want, tol=TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1.0)
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * scale)


def _state(rng, shape):
    """Conservative state with rho ~ 1, subsonic velocity, p ~ 7."""
    rho = 1.0 + 0.1 * rng.uniform(size=shape + (1,))
    vel = 0.3 * rng.standard_normal(shape + (3,))
    p = 7.0 + 0.5 * rng.uniform(size=shape + (1,))
    e = p / 0.4 + 0.5 * rho * np.sum(vel**2, -1, keepdims=True)
    return np.concatenate([rho, rho * vel, e], -1).astype(np.float32)


@pytest.mark.parametrize("n_poly", [1, 2, 3, 5, 7])
def test_gll_operators_exactly_equal(n_poly):
    """gll.py is a verbatim copy: nodes, weights and D are identical."""
    for a, b in zip(jgll.gll_nodes_weights(n_poly),
                    tgll.gll_nodes_weights(n_poly)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(jgll.lagrange_derivative_matrix(n_poly),
                                  tgll.lagrange_derivative_matrix(n_poly))
    x, _ = jgll.gll_nodes_weights(n_poly)
    eq = jgll.equispaced_nodes(n_poly + 1)
    np.testing.assert_array_equal(jgll.lagrange_interpolation_matrix(x, eq),
                                  tgll.lagrange_interpolation_matrix(x, eq))


@pytest.fixture(scope="module")
def mesh():
    """(prefix 2, K=(2,3,2), n=4, C=5) state and the operators."""
    rng = np.random.default_rng(0)
    dg = (2, 3)  # n_poly, n_elem (only n_poly matters for the operators)
    d = jgll.lagrange_derivative_matrix(dg[0] + 1).astype(np.float32)
    _, w = jgll.gll_nodes_weights(dg[0] + 1)
    u = _state(rng, (2, 2, 3, 2, 4, 4, 4))
    return dict(rng=rng, u=u, d=d, inv_w_end=(1.0 / w[0], 1.0 / w[-1]))


@pytest.mark.parametrize("direction", [0, 1, 2])
def test_deriv_traces_lift(mesh, direction):
    u, d = mesh["u"], mesh["d"]
    tu = torch.from_numpy(u)
    _close(tdg.deriv_along(tu, torch.from_numpy(d), direction),
           jdg.deriv_along(jnp.asarray(u), jnp.asarray(d), direction))
    for got, want in zip(tdg.neighbor_traces(tu, direction),
                         jdg.neighbor_traces(jnp.asarray(u), direction)):
        _close(got, want)
    lo, hi = jdg._face_slices(jnp.asarray(u), direction)
    du = np.array(jdg.deriv_along(jnp.asarray(u), jnp.asarray(d), direction))
    want = jdg.surface_lift(jnp.asarray(du), hi, lo, direction,
                            mesh["inv_w_end"])
    tlo, thi = tdg._face_slices(tu, direction)
    got = tdg.surface_lift(torch.from_numpy(du), thi, tlo, direction,
                           mesh["inv_w_end"])
    _close(got, want)


@pytest.mark.parametrize("direction", [0, 1, 2])
def test_set_face_and_left_faces(mesh, direction):
    u = mesh["u"]
    face = np.array(jdg._face_slices(jnp.asarray(u), direction)[1])
    slab = np.moveaxis(face, jdg.ELEM_AXIS[direction] + face.ndim + 1, 0)[0]
    slab = (slab + 1.0).astype(np.float32)
    for index in (0, -1):
        _close(tdg.set_face(torch.from_numpy(face), direction, index,
                            torch.from_numpy(slab)),
               jdg.set_face(jnp.asarray(face), direction, index,
                            jnp.asarray(slab)), tol=0.0)
    _close(tdg.left_faces(torch.from_numpy(face), direction),
           jdg.left_faces(jnp.asarray(face), direction), tol=0.0)
    _close(tdg.left_faces(torch.from_numpy(face), direction,
                          lo_value=torch.from_numpy(slab)),
           jdg.left_faces(jnp.asarray(face), direction,
                          lo_value=jnp.asarray(slab)), tol=0.0)


def _bc_tuple(face_shape_fn, rng, wall_dirs, lib):
    """Per-direction bc: prescribed (lo, hi) face slabs on `wall_dirs`."""
    out = []
    for d in range(3):
        if d not in wall_dirs:
            out.append(None)
            continue
        lo = rng.standard_normal(face_shape_fn(d)).astype(np.float32)
        hi = rng.standard_normal(face_shape_fn(d)).astype(np.float32)
        out.append((lib(lo), lib(hi)))
    return tuple(out)


@pytest.mark.parametrize("wall_dirs", [(), (1,), (0, 2)])
def test_dg_gradient_and_divergence(mesh, wall_dirs):
    """BR1 gradient and strong-form divergence, periodic and with prescribed
    boundary faces, on an anisotropic mesh with per-direction jac."""
    u, d, inv_w_end = mesh["u"], mesh["d"], mesh["inv_w_end"]
    jac = (0.7, 1.3, 2.1)
    q = u[..., 1:5]

    def face_shape(dd, arr=q):  # one face slab: node and element axis removed
        shp = list(arr.shape)
        del shp[jdg.NODE_AXIS[dd]]
        del shp[jdg.ELEM_AXIS[dd] + 1]  # one later axis is already gone
        return tuple(shp)

    seed = int(sum(wall_dirs)) + 7
    bc_j = _bc_tuple(face_shape, np.random.default_rng(seed), wall_dirs,
                     jnp.asarray)
    bc_t = _bc_tuple(face_shape, np.random.default_rng(seed), wall_dirs,
                     torch.from_numpy)
    bc_j = bc_j if wall_dirs else None
    bc_t = bc_t if wall_dirs else None
    want = jdg.dg_gradient(jnp.asarray(q), None, jnp.asarray(d), inv_w_end,
                           jac=jac, bc=bc_j)
    got = tdg.dg_gradient(torch.from_numpy(q), None, torch.from_numpy(d),
                          inv_w_end, jac=jac, bc=bc_t)
    _close(got, want)

    fluxes = [u * (dd + 1.0) for dd in range(3)]
    stars = [np.array(jdg.neighbor_traces(jnp.asarray(f), dd)[0]) * 0.9
             for dd, f in enumerate(fluxes)]

    def face_shape_u(dd):
        return face_shape(dd, u)

    bcf_j = _bc_tuple(face_shape_u, np.random.default_rng(seed + 1),
                      wall_dirs, jnp.asarray) if wall_dirs else None
    bcf_t = _bc_tuple(face_shape_u, np.random.default_rng(seed + 1),
                      wall_dirs, torch.from_numpy) if wall_dirs else None
    want = jdg.dg_divergence(tuple(jnp.asarray(f) for f in fluxes),
                             tuple(jnp.asarray(s) for s in stars), None,
                             jnp.asarray(d), inv_w_end, jac=jac, bc=bcf_j)
    got = tdg.dg_divergence(tuple(torch.from_numpy(f) for f in fluxes),
                            tuple(torch.from_numpy(s) for s in stars), None,
                            torch.from_numpy(d), inv_w_end, jac=jac, bc=bcf_t)
    _close(got, want)


@pytest.mark.parametrize("direction", [0, 1, 2])
def test_flux_differencing_and_fluxes(mesh, direction):
    u, d = mesh["u"], mesh["d"]
    ju, tu = jnp.asarray(u), torch.from_numpy(u)
    jr, jv, jp, _ = jeq.conservative_to_primitive(ju)
    tr, tv, tp, _ = teq.conservative_to_primitive(tu)
    jprim = (jr, jv, jp, ju[..., 4] / jr)
    tprim = (tr, tv, tp, tu[..., 4] / tr)
    _close(tdg.flux_differencing(tprim, teq.kennedy_gruber_flux,
                                 torch.from_numpy(d), direction),
           jdg.flux_differencing(jprim, jeq.kennedy_gruber_flux,
                                 jnp.asarray(d), direction))
    _close(teq.advective_flux(tu, direction), jeq.advective_flux(ju, direction))
    ul, ur = jdg.neighbor_traces(ju, direction)
    _close(teq.lax_friedrichs_flux(torch.from_numpy(np.array(ul)),
                                   torch.from_numpy(np.array(ur)), direction),
           jeq.lax_friedrichs_flux(ul, ur, direction))
    grad = mesh["rng"].standard_normal(u.shape[:-1] + (4, 3)).astype(np.float32)
    nu_t = np.abs(mesh["rng"].standard_normal(u.shape[:-1])).astype(np.float32)
    _close(teq.viscous_flux(tu, torch.from_numpy(grad), torch.from_numpy(nu_t),
                            teq.GasParams(mu=1.8e-3), direction),
           jeq.viscous_flux(ju, jnp.asarray(grad), jnp.asarray(nu_t),
                            jeq.GasParams(mu=1.8e-3), direction))


def test_pointwise_physics_and_quadrature(mesh):
    u = mesh["u"]
    ju, tu = jnp.asarray(u), torch.from_numpy(u)
    for got, want in zip(teq.conservative_to_primitive(tu),
                         jeq.conservative_to_primitive(ju)):
        _close(got, want)
    rho, vel, p, _ = jeq.conservative_to_primitive(ju)
    _close(teq.primitive_to_conservative(*(torch.from_numpy(np.array(x))
                                           for x in (rho, vel, p))),
           jeq.primitive_to_conservative(rho, vel, p))
    grad_v = mesh["rng"].standard_normal((50, 3, 3)).astype(np.float32)
    s = teq.strain_rate(torch.from_numpy(grad_v))
    _close(s, jeq.strain_rate(jnp.asarray(grad_v)))
    _close(teq.strain_magnitude(s),
           jeq.strain_magnitude(jeq.strain_rate(jnp.asarray(grad_v))))
    dg_j, dg_t = jdg.DGParams(3, 2), tdg.DGParams(3, 2)
    np.testing.assert_array_equal(dg_j.node_coords(), dg_t.node_coords())
    _close(tdg.quadrature_mean(tu, dg_t), jdg.quadrature_mean(ju, dg_j))
