"""PyTorch port vs JAX reference: the fused Navier-Stokes RHS.

The port's plain version (`repro_torch.kernels.rhs.navier_stokes_rhs_plain`,
which the CUDA kernel is held to on the card) runs against the JAX oracle
`repro.kernels.ref.navier_stokes_rhs_fused`, plus one interpret-mode call of
the Pallas kernel itself at the smallest shape.  The CUDA kernel has no CPU
mode: its own parity test is marked `cuda` and skips without a GPU.

Tolerances, relative to max |reference|:
  * float32 2e-5: the same float32 formulas in a different summation order
    (measured <= 2.6e-7 on these inputs);
  * bfloat16 4e-2, the JAX package's own bf16 gate: both sides compute in
    float32 from the same bf16 inputs, but their float32 results may round
    to neighbouring bf16 values (measured <= 1.6e-4).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.cfd.solver import HITConfig as JaxHITConfig
from repro.kernels import ref
from repro_torch.cfd import solver as tsolver
from repro_torch.cfd.solver import HITConfig
from repro_torch.kernels import rhs as trhs

TOL = {"float32": 2e-5, "bfloat16": 4e-2}


def _synthetic_state(rng, prefix, n_poly, n_elem):
    """Physically plausible conservative state: rho ~ 1, subsonic velocity,
    pressure well clear of vacuum."""
    n, k = n_poly + 1, n_elem
    mesh = tuple(prefix) + (k, k, k, n, n, n)
    rho = 1.0 + 0.1 * rng.uniform(size=mesh + (1,))
    vel = 0.3 * rng.standard_normal(mesh + (3,))
    p = 7.0 + 0.5 * rng.uniform(size=mesh + (1,))
    e = p / 0.4 + 0.5 * rho * np.sum(vel**2, -1, keepdims=True)
    return np.concatenate([rho, rho * vel, e], -1).astype(np.float32)


def _kwargs(cfg):
    ops = cfg.operators()
    return dict(inv_w_end=ops["inv_w_end"], jac=cfg.dg.jac,
                delta=cfg.delta_filter, mu=cfg.gas.mu, prandtl=cfg.prandtl,
                prandtl_turb=cfg.prandtl_turb, forcing_a0=cfg.forcing_a0,
                k_tke=cfg.k_tke)


def _inputs(prefix, n_poly, n_elem, seed=3):
    rng = np.random.default_rng(seed)
    u = _synthetic_state(rng, prefix, n_poly, n_elem)
    cs_elem = rng.uniform(0.0, 0.5, size=u.shape[:-4]).astype(np.float32)
    cs = np.broadcast_to(cs_elem[..., None, None, None], u.shape[:-1]).copy()
    return u, cs


def _rel_err(got, want):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("prefix,n_poly,n_elem", [
    ((), 3, 2),     # single mesh, reduced polynomial order
    ((3,), 3, 2),   # env batch
    ((2,), 2, 3),   # K=3 periodic exchange, n_poly=2
    ((), 5, 4),     # one paper-width 24-DOF mesh
])
def test_plain_fused_rhs_matches_jax_oracle(prefix, n_poly, n_elem, dtype):
    jcfg = JaxHITConfig(n_poly=n_poly, n_elem=n_elem, use_kernels=False)
    kw = _kwargs(jcfg)
    u, cs = _inputs(prefix, n_poly, n_elem)
    jops = jcfg.operators()
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = getattr(torch, dtype)
    ju, jcs = jnp.asarray(u).astype(jdt), jnp.asarray(cs).astype(jdt)
    oracle = jax.jit(functools.partial(ref.navier_stokes_rhs_fused, **kw))
    want = oracle(ju, jcs, jops["D"].astype(jdt), jops["w"].astype(jdt))
    # both sides get the identical (bf16-rounded) values
    tu = torch.from_numpy(np.array(ju.astype(jnp.float32))).to(tdt)
    tcs = torch.from_numpy(np.array(jcs.astype(jnp.float32))).to(tdt)
    ops = HITConfig(n_poly=n_poly, n_elem=n_elem).operators()
    got = trhs.navier_stokes_rhs_plain(tu, tcs, ops["D"].to(tdt),
                                       ops["w"].to(tdt), **kw)
    assert got.shape == u.shape and got.dtype == tdt
    # measured: float32 <= 2.6e-7, bfloat16 <= 1.6e-4
    assert _rel_err(got.float(), want.astype(jnp.float32)) <= TOL[dtype]


def test_pallas_kernel_interpret_matches_port():
    """The JAX package's Pallas kernel itself (interpret mode) at the
    smallest shape vs the port's plain version."""
    from repro.kernels.rhs import fused_navier_stokes_rhs

    jcfg = JaxHITConfig(n_poly=2, n_elem=2, use_kernels=True)
    kw = _kwargs(jcfg)
    u, cs = _inputs((), 2, 2, seed=5)
    jops = jcfg.operators()
    want = fused_navier_stokes_rhs(jnp.asarray(u), jnp.asarray(cs), jops["D"],
                                   jops["w"], interpret=True, **kw)
    ops = HITConfig(n_poly=2, n_elem=2).operators()
    got = trhs.navier_stokes_rhs_plain(torch.from_numpy(u),
                                       torch.from_numpy(cs), ops["D"],
                                       ops["w"], **kw)
    assert _rel_err(got, want) <= TOL["float32"]  # measured 1.0e-7


@pytest.mark.parametrize("n_poly,n_elem", [(3, 2), (2, 3)])
def test_staged_solver_rhs_matches_fused_plain(n_poly, n_elem):
    """The staged assembly (use_kernels=False) and the fused path agree;
    the fused path on a CPU tensor is the plain version, not the kernel."""
    u, cs = _inputs((2,), n_poly, n_elem, seed=11)
    tu, tcs = torch.from_numpy(u), torch.from_numpy(cs)
    staged = HITConfig(n_poly=n_poly, n_elem=n_elem, use_kernels=False)
    fused = HITConfig(n_poly=n_poly, n_elem=n_elem, use_kernels=True)
    before = trhs.fused_navier_stokes_rhs.launches
    r_staged = tsolver.navier_stokes_rhs(tu, tcs, staged, staged.operators())
    r_fused = tsolver.navier_stokes_rhs(tu, tcs, fused, fused.operators())
    # measured 0: on float32 CPU tensors both run `plain_rhs`
    assert _rel_err(r_fused, r_staged) <= TOL["float32"]
    # a CPU tensor never launches the kernel
    assert trhs.fused_navier_stokes_rhs.launches == before


def test_kernel_input_checks_raise():
    """What the kernel cannot take is refused before any launch."""
    u, cs = _inputs((1,), 2, 2)
    tu, tcs = torch.from_numpy(u), torch.from_numpy(cs)
    ops = HITConfig(n_poly=2, n_elem=2).operators()
    d, w = ops["D"], ops["w"]
    assert trhs._check_inputs(tu, tcs, d, w) == 3
    with pytest.raises(TypeError):
        trhs._check_inputs(tu.double(), tcs.double(), d, w)
    with pytest.raises(ValueError, match="contiguous"):
        trhs._check_inputs(tu, torch.from_numpy(cs[..., :1]).expand(tcs.shape),
                           d, w)
    with pytest.raises(ValueError, match="cs_nodes"):
        trhs._check_inputs(tu, tcs[..., :2], d, w)
    big = torch.zeros((1, 1, 1, 1, 9, 9, 9, 5))
    with pytest.raises(ValueError, match="n x n x n"):
        trhs._check_inputs(big, big[..., 0], torch.zeros(9, 9), torch.zeros(9))
    with pytest.raises(ValueError, match="no fused RHS"):
        trhs.fused_navier_stokes_rhs(tu.to("meta"), tcs.to("meta"), d, w,
                                     **_kwargs(HITConfig(n_poly=2, n_elem=2)))


def test_solver_rhs_dispatch(monkeypatch):
    """`use_kernels` alone picks the assembly: True (the default) calls the
    fused RHS once per evaluation, whatever the environment holds (the JAX
    package's REPRO_KERNELS is not read), and False never calls it."""
    calls = []
    fused = trhs.fused_navier_stokes_rhs

    def spy(*args, **kwargs):
        calls.append(1)
        return fused(*args, **kwargs)

    monkeypatch.setattr(tsolver.rhs_kernel, "fused_navier_stokes_rhs", spy)
    monkeypatch.setenv("REPRO_KERNELS", "ref")
    u, cs = _inputs((1,), 2, 2)
    tu, tcs = torch.from_numpy(u), torch.from_numpy(cs)
    cfg = HITConfig(n_poly=2, n_elem=2)
    assert cfg.use_kernels is True
    tsolver.navier_stokes_rhs(tu, tcs, cfg, cfg.operators())
    assert len(calls) == 1
    staged = HITConfig(n_poly=2, n_elem=2, use_kernels=False)
    tsolver.navier_stokes_rhs(tu, tcs, staged, staged.operators())
    assert len(calls) == 1


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("batch,n_poly,n_elem", [(16, 5, 4), (4, 7, 4),
                                                 (3, 2, 3)])
def test_cuda_kernel_matches_plain(batch, n_poly, n_elem, dtype):
    """The CUDA kernel vs its plain version on the card (chip_smoke.py's
    tolerances: float32 1e-4, bfloat16 4e-2 of max |plain|)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    cfg = HITConfig(n_poly=n_poly, n_elem=n_elem)
    u, cs = _inputs((batch,), n_poly, n_elem)
    tdt = getattr(torch, dtype)
    tu = torch.from_numpy(u).to("cuda", tdt)
    tcs = torch.from_numpy(cs).to("cuda", tdt)
    ops = cfg.operators("cuda")
    before = trhs.fused_navier_stokes_rhs.launches
    got = trhs.fused_navier_stokes_rhs(tu, tcs, ops["D"], ops["w"],
                                       **_kwargs(cfg))
    torch.cuda.synchronize()
    assert trhs.fused_navier_stokes_rhs.launches == before + 1
    want = trhs.navier_stokes_rhs_plain(tu, tcs, ops["D"], ops["w"],
                                        **_kwargs(cfg))
    tol = {"float32": 1e-4, "bfloat16": 4e-2}[dtype]
    assert _rel_err(got.float().cpu(), want.float().cpu()) <= tol
