"""PyTorch port vs JAX reference: the channel path's three component kernels.

Each plain version of the port (`dg_derivative3_plain`,
`smagorinsky_nut_plain`, `wall_model_tau_plain`, against which the CUDA
kernels are held on the card) runs against the JAX oracle in
`repro.kernels.ref` and against the Pallas kernel itself in interpret mode,
on the same numpy inputs.  The CUDA kernels have no CPU mode: their own
parity tests are marked `cuda` and skip without a GPU.

Tolerances are the JAX package's pinned per-kernel ones
(`tests/test_kernel_parity.py`): float32 paths compute the same formulas in
another summation order; bfloat16 ones cover the 8-bit mantissa of the
in/out casts (the oracle computes in bfloat16, the kernels and the port in
float32).  The measured error is written beside each.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref
from repro.kernels.dg_derivative import dg_derivative3 as pallas_dg3
from repro.kernels.smagorinsky import smagorinsky_nut as pallas_smag
from repro.kernels.wall_model import wall_model_tau as pallas_wm
from repro_torch.cfd import gll
from repro_torch.kernels import dg_derivative, smagorinsky, wall_model

TOL = {
    "dg_derivative3": {"float32": dict(rtol=2e-4, atol=1e-5),
                       "bfloat16": dict(rtol=4e-2, atol=4e-2)},
    "smagorinsky_nut": {"float32": dict(rtol=2e-5, atol=1e-7),
                        "bfloat16": dict(rtol=4e-2, atol=4e-3)},
    "wall_model_tau": {"float32": dict(rtol=1e-5, atol=1e-8),
                       "bfloat16": dict(rtol=4e-2, atol=4e-4)},
}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def _pair(x: np.ndarray, dtype: str):
    """The same values for both packages, rounded once to `dtype`."""
    j = jnp.asarray(x).astype(JDT[dtype])
    t = torch.from_numpy(np.array(j.astype(jnp.float32))).to(
        getattr(torch, dtype))
    return j, t


def _close(name, dtype, got, want):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **TOL[name][dtype])


# --- dg_derivative3 ---------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,c", [(3, 4), (3, 5), (4, 4), (4, 5), (6, 4),
                                 (6, 5)])
def test_dg_derivative3_plain_matches_oracle_and_pallas(n, c, dtype):
    """Measured max |d| over all six shapes: float32 7.6e-6 against both
    the oracle and the Pallas kernel (values up to ~60); bfloat16 0 against
    both (each rounds a float32 sum once)."""
    rng = np.random.default_rng(10 * n + c)
    u, tu = _pair(rng.standard_normal((7, n, n, n, c)).astype(np.float32),
                  dtype)
    d_np = gll.lagrange_derivative_matrix(n - 1).astype(np.float32)
    d, td = _pair(d_np, dtype)
    got = dg_derivative.dg_derivative3_plain(tu, td)
    want = ref.dg_derivative3(u, d)
    kernel = pallas_dg3(u, d, block_b=4, interpret=True)
    for g, w, k in zip(got, want, kernel):
        assert g.shape == tu.shape and g.dtype == tu.dtype
        _close("dg_derivative3", dtype, g, w)
        _close("dg_derivative3", dtype, g, k)


# --- smagorinsky_nut --------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("p", [1000, 2053])
def test_smagorinsky_plain_matches_oracle_and_pallas(p, dtype):
    """Ragged P (not a multiple of the Pallas block of 2048).  Measured max
    |d| / max |want|: float32 9.1e-8 against the oracle, 1.4e-7 against the
    Pallas kernel; bfloat16 0 against the Pallas kernel (float32 math in
    both), 1.2e-2 against the oracle (bfloat16 math)."""
    rng = np.random.default_rng(p)
    g, tg = _pair(2.0 * rng.standard_normal((p, 3, 3)).astype(np.float32),
                  dtype)
    cs, tcs = _pair(rng.uniform(0.0, 0.5, p).astype(np.float32), dtype)
    delta = 0.0833
    got = smagorinsky.smagorinsky_nut_plain(tg, tcs, delta)
    assert got.shape == (p,) and got.dtype == tg.dtype
    _close("smagorinsky_nut", dtype, got, ref.smagorinsky_nut(g, cs, delta))
    _close("smagorinsky_nut", dtype, got,
           pallas_smag(g, cs, delta, interpret=True))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("p", [1000, 2053])
def test_smagorinsky_plain_on_gradient_rows_view_matches_oracle(p, dtype):
    """The velocity rows of a (P, 4, 3) gradient, as the channel hands them
    over (a view with point stride 12), against the JAX oracle on the
    contiguous copy of the same rows: the pins above (measured as on the
    contiguous input, the same float32 math on the same values)."""
    rng = np.random.default_rng(p + 1)
    full = 2.0 * rng.standard_normal((p, 4, 3)).astype(np.float32)
    g, tg = _pair(full, dtype)
    cs, tcs = _pair(rng.uniform(0.0, 0.5, p).astype(np.float32), dtype)
    view = tg[:, 0:3, :]
    assert view.stride() == (12, 3, 1) and not view.is_contiguous()
    got = smagorinsky.smagorinsky_nut_plain(view, tcs, 0.0833)
    assert got.shape == (p,) and got.dtype == tg.dtype
    _close("smagorinsky_nut", dtype, got,
           ref.smagorinsky_nut(g[:, 0:3, :], cs, 0.0833))
    torch.testing.assert_close(got, smagorinsky.smagorinsky_nut_plain(
        view.contiguous(), tcs, 0.0833), rtol=0, atol=0)


# --- wall_model_tau ---------------------------------------------------------
REGIMES = {
    # viscous sublayer: y+ < 1, the inversion is the laminar stress
    "laminar": dict(y_m=1e-3, nu=5e-3, u_par=(1e-3, 5e-2)),
    # the channel's matching point (half the wall element) at the _hre
    # viscosity, up to y+ ~ 100: log layer
    "log": dict(y_m=0.25, nu=2e-3, u_par=(0.3, 1.6)),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("iters", [8, 12])
@pytest.mark.parametrize("regime", sorted(REGIMES))
def test_wall_model_plain_matches_oracle_and_pallas(regime, iters, dtype):
    """Same order of operations on both sides.  float32: the JAX pin
    (rtol 1e-5) holds in the log layer (measured 3.4e-7 elementwise).  In
    the viscous sublayer u+ ~ y+ comes out of the cancellation
    1 - exp(-y+/11) - ..., where one ulp of a different `exp` (XLA's against
    PyTorch's) moves tau by ~5e-6 relative: rtol 4e-5 there (measured
    1.02e-5 against the oracle, 1.0e-5 against the Pallas kernel, which
    share XLA's exp with each other).  bfloat16: measured 0."""
    r = REGIMES[regime]
    rng = np.random.default_rng(iters)
    shape = (3, 2, 2, 4, 4)  # (B, Kx, Kz, n, n) wall-face columns
    up, tup = _pair(rng.uniform(*r["u_par"], shape).astype(np.float32), dtype)
    rho, trho = _pair(rng.uniform(0.9, 1.1, shape).astype(np.float32), dtype)
    kw = dict(y_m=r["y_m"], nu=r["nu"], kappa=0.41, iters=iters)
    got = wall_model.wall_model_tau_plain(tup, trho, **kw)
    assert got.shape == shape and got.dtype == tup.dtype
    tol = dict(TOL["wall_model_tau"][dtype])
    if regime == "laminar" and dtype == "float32":
        tol["rtol"] = 4e-5
    for want in (ref.wall_model_tau(up, rho, **kw),
                 pallas_wm(up, rho, block_p=64, interpret=True, **kw)):
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32), **tol)
    if regime == "laminar":  # tau -> mu u_par / y_m
        np.testing.assert_allclose(
            got.float().numpy(),
            (trho * r["nu"] * tup / r["y_m"]).float().numpy(), rtol=2e-2)


def test_reichardt_uplus_matches_reference_formula():
    """numpy float64 (the reference profile's route): identical.  torch
    float32 against jnp float32 (the kernels' route; the formula cancels
    near y+ = 0 in float32 on both sides): atol 4e-6 on u+ of up to ~20
    (measured 1.9e-6 at y+ ~ 1e3, 1 ulp of u+ ~ 20)."""
    y_plus = np.geomspace(1e-3, 1e3, 257)
    np.testing.assert_array_equal(
        wall_model.reichardt_uplus(y_plus, 0.41, xp=np),
        ref.reichardt_uplus(y_plus, 0.41, xp=np))
    y32 = y_plus.astype(np.float32)
    got = wall_model.reichardt_uplus(torch.from_numpy(y32), 0.41).numpy()
    np.testing.assert_allclose(got, ref.reichardt_uplus(jnp.asarray(y32),
                                                        0.41),
                               rtol=0, atol=4e-6)


# --- the wrappers on the CPU ------------------------------------------------
def _kernel_cases():
    rng = np.random.default_rng(0)
    u = torch.from_numpy(rng.standard_normal((3, 4, 4, 4, 4)).astype(
        np.float32))
    d = torch.from_numpy(gll.lagrange_derivative_matrix(3).astype(np.float32))
    g = torch.from_numpy(rng.standard_normal((50, 3, 3)).astype(np.float32))
    cs = torch.full((50,), 0.1)
    up = torch.from_numpy(rng.uniform(0.1, 1.0, 40).astype(np.float32))
    rho = torch.ones(40)
    wm = dict(y_m=0.25, nu=5e-3, kappa=0.41, iters=8)
    return {
        "dg_derivative3": (dg_derivative.dg_derivative3,
                           dg_derivative.dg_derivative3_plain, (u, d), {}),
        "smagorinsky_nut": (smagorinsky.smagorinsky_nut,
                            smagorinsky.smagorinsky_nut_plain,
                            (g, cs, 0.05), {}),
        "wall_model_tau": (wall_model.wall_model_tau,
                           wall_model.wall_model_tau_plain, (up, rho), wm),
    }


@pytest.mark.parametrize("name", ["dg_derivative3", "smagorinsky_nut",
                                  "wall_model_tau"])
def test_cpu_tensor_takes_plain_version(name):
    """A CPU tensor runs the plain version (bit-identical) and never counts a
    launch; a tensor on another device type raises."""
    wrapper, plain, args, kw = _kernel_cases()[name]
    before = wrapper.launches
    got, want = wrapper(*args, **kw), plain(*args, **kw)
    for g, w in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    assert wrapper.launches == before
    meta = tuple(a.to("meta") if isinstance(a, torch.Tensor) else a
                 for a in args)
    with pytest.raises(ValueError, match="no .* kernel for device meta"):
        wrapper(*meta, **kw)


def test_dg_derivative3_input_checks_raise():
    u = torch.zeros((2, 4, 4, 4, 4))
    d = torch.zeros((4, 4))
    dg_derivative._check_inputs(u, d)
    with pytest.raises(TypeError):
        dg_derivative._check_inputs(u.double(), d)
    with pytest.raises(ValueError, match="contiguous"):
        dg_derivative._check_inputs(u.transpose(1, 2), d)
    with pytest.raises(ValueError, match=r"\(B, n, n, n, C\)"):
        dg_derivative._check_inputs(u[:, :, :3], d)
    with pytest.raises(ValueError, match="d_matrix"):
        dg_derivative._check_inputs(u, torch.zeros((3, 3)))
    big = torch.zeros((1, 24, 24, 24, 5))
    with pytest.raises(ValueError, match="shared memory"):
        dg_derivative._check_inputs(big, torch.zeros((24, 24)))
    # n = 16 with 5 channels (80 KB) is taken
    dg_derivative._check_inputs(torch.zeros((1, 16, 16, 16, 5)),
                                torch.zeros((16, 16)))


def test_smagorinsky_input_checks_raise():
    g = torch.zeros((10, 4, 3))
    cs = torch.zeros(10)
    smagorinsky._check_inputs(g[:, :3].contiguous(), cs)
    # the velocity rows of a (P, 4, 3) gradient, read in place
    smagorinsky._check_inputs(g[:, :3], cs)
    with pytest.raises(ValueError, match="strides"):
        # rows of 3 no longer contiguous: the kernel would read g transposed
        smagorinsky._check_inputs(g[:, :3].transpose(1, 2), cs)
    with pytest.raises(TypeError):
        smagorinsky._check_inputs(g[:, :3].contiguous().double(), cs)
    with pytest.raises(ValueError, match=r"\(P, 3, 3\)"):
        smagorinsky._check_inputs(g, cs)
    with pytest.raises(ValueError, match="cs must be"):
        smagorinsky._check_inputs(g[:, :3].contiguous(), cs[:9])


@pytest.mark.parametrize("layout", ["contiguous", "rows of (P, 4, 3)",
                                    "offset rows", "stride-0 cs",
                                    "one point"])
def test_smagorinsky_checks_take_views_and_hand_over_their_strides(layout):
    """What the kernel is handed for each view it takes: (s_p, s_c) in
    values, read in place (no copy)."""
    buf = torch.zeros(12 * 20 + 9)
    cs = torch.zeros(20)
    g, want = {
        "contiguous": (buf[:180].view(20, 3, 3), (9, 1)),
        "rows of (P, 4, 3)": (buf[:240].view(20, 4, 3)[:, :3], (12, 1)),
        "offset rows": (buf[9:249].view(20, 4, 3)[:, :3], (12, 1)),
        "stride-0 cs": (buf[:240].view(20, 4, 3)[:, :3], (12, 0)),
        "one point": (buf[12:24].view(1, 4, 3)[:, :3], (9, 0)),
    }[layout]
    if layout == "stride-0 cs":
        cs = torch.full((), 0.17).expand(20)
    cs = cs[:g.shape[0]]
    smagorinsky._check_inputs(g, cs)
    assert smagorinsky._strides(g, cs) == want
    assert g.untyped_storage().data_ptr() == buf.untyped_storage().data_ptr()


@pytest.mark.parametrize("strides", [(12, 1, 3), (6, 3, 1), (9, 1, 3)])
def test_smagorinsky_checks_raise_on_layouts_the_kernel_cannot_read(strides):
    """Rows of 3 must be contiguous and points must not overlap."""
    g = torch.zeros(400).as_strided((20, 3, 3), strides)
    with pytest.raises(ValueError, match="strides"):
        smagorinsky._check_inputs(g, torch.zeros(20))


@pytest.mark.parametrize("n", [1, 2, 3, 4, 5, 6, 7, 8, 9, 12, 16])
def test_dg_derivative3_pick_instance(n):
    """"tiled" for n = 2..8 (the channel's 4, HIT's 6, 32-DOF's 8) in both
    dtypes at the paths' C = 4 and 5; "generic" for n = 1 and above 8."""
    for dtype in (torch.float32, torch.bfloat16):
        for c in (1, 4, 5):
            want = "tiled" if 2 <= n <= 8 else "generic"
            assert dg_derivative.pick_instance(n, c, dtype) == want


def test_dg_derivative3_pick_instance_at_the_shared_memory_edge():
    """The tiled instance keeps two element buffers and D in one block's
    227 KB and takes C <= 64; beyond either the generic instance (one
    element buffer) takes the shape, whenever `_check_inputs` does."""
    f32, bf16 = torch.float32, torch.bfloat16
    assert dg_derivative.pick_instance(8, 56, f32) == "tiled"     # 229,632 B
    assert dg_derivative.pick_instance(8, 57, f32) == "generic"   # 233,728 B
    assert dg_derivative.pick_instance(8, 64, bf16) == "tiled"
    assert dg_derivative.pick_instance(8, 65, bf16) == "generic"
    assert dg_derivative.pick_instance(2, 65, f32) == "generic"
    for n in range(2, 9):
        for c in range(1, 120):
            u = torch.zeros((1, n, n, n, c), device="meta")
            try:
                dg_derivative._check_inputs(u, torch.zeros((n, n),
                                                           device="meta"))
            except ValueError:
                continue
            if dg_derivative.pick_instance(n, c, f32) == "tiled":
                assert 2 * 4 * n**3 * c + 4 * n * n <= dg_derivative.SMEM_BYTES


def test_dg_derivative3_tiled_range_mirrors_its_source():
    """`pick_instance` sends the tiled kernel only shapes its source was
    built for: the n of its switch and C up to its kMaxC."""
    import pathlib
    import re
    src = (pathlib.Path(dg_derivative.__file__).parent / "csrc"
           / dg_derivative.SOURCES["tiled"]).read_text()
    cases = {int(x) for x in re.findall(r"DG_N\((\d+)\);", src)}
    assert cases == set(dg_derivative.TILED_N)
    assert int(re.search(r"kMaxC = (\d+);", src).group(1)) == \
        dg_derivative.TILED_MAX_C


def test_dg_derivative3_checks_take_a_bf16_d():
    """The bf16 rollouts hand over a bf16 D; the tiled kernel reads it as
    stored."""
    u = torch.zeros((2, 4, 4, 4, 4), dtype=torch.bfloat16)
    for d_dtype in (torch.bfloat16, torch.float32):
        dg_derivative._check_inputs(u, torch.zeros((4, 4), dtype=d_dtype))


def test_wall_model_input_checks_raise():
    u = torch.zeros((4, 6, 5))  # conservative states: rho = u[..., 0]
    up = torch.ones((4, 6))
    wall_model._check_inputs(up, u[..., 0].contiguous())
    with pytest.raises(ValueError, match="contiguous"):
        # stride 5: a wrapper that passed it on would read momentum as rho
        wall_model._check_inputs(up, u[..., 0])
    with pytest.raises(ValueError, match="contiguous"):
        wall_model._check_inputs(up, torch.ones(()).expand(4, 6))
    with pytest.raises(ValueError, match="rho_w must be"):
        wall_model._check_inputs(up, torch.ones((4, 5)))
    with pytest.raises(TypeError):
        wall_model._check_inputs(up.double(), up.double())


# --- the CUDA kernels on the card -------------------------------------------
def _need_gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")


def _rel(got, want):
    got, want = got.float().cpu(), want.float().cpu()
    return float((got - want).abs().max() / want.abs().max())


CARD_TOL = {"float32": 1e-5, "bfloat16": 4e-2}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_dg_derivative3_matches_plain(dtype):
    """At the channel path's shape (16 envs x 36 elements, n=4, C=4),
    within chip_smoke.py's tolerances (float32 1e-4, bfloat16 4e-2 of
    max |plain|)."""
    _need_gpu()
    rng = np.random.default_rng(1)
    tdt = getattr(torch, dtype)
    u = torch.from_numpy(rng.standard_normal((576, 4, 4, 4, 4)).astype(
        np.float32)).to("cuda", tdt)
    d = torch.from_numpy(gll.lagrange_derivative_matrix(3).astype(
        np.float32)).to("cuda")
    before = dg_derivative.dg_derivative3.launches
    tiled = dg_derivative.dg_derivative3.instance_launches["tiled"]
    got = dg_derivative.dg_derivative3(u, d)
    torch.cuda.synchronize()
    assert dg_derivative.dg_derivative3.launches == before + 1
    assert dg_derivative.dg_derivative3.instance_launches["tiled"] == tiled + 1
    for g, w in zip(got, dg_derivative.dg_derivative3_plain(u, d)):
        assert _rel(g, w) <= {"float32": 1e-4, "bfloat16": 4e-2}[dtype]


def _dg_case(rng, b, n, c, dtype):
    """u (b, n, n, n, c) and D of n nodes, both in `dtype` on the card (the
    bf16 rollouts hand over a bf16 D)."""
    tdt = getattr(torch, dtype)
    u = torch.from_numpy(rng.standard_normal((b, n, n, n, c)).astype(
        np.float32)).to("cuda", tdt)
    d = torch.from_numpy(gll.lagrange_derivative_matrix(n - 1).astype(
        np.float32)).to("cuda", tdt)
    return u, d


def _dg_instance_matches_plain(u, d, kind, dtype):
    fn = dg_derivative.dg_derivative3
    before, by_kind = fn.launches, dict(fn.instance_launches)
    got = fn(u, d, instance=kind)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    assert fn.instance_launches == dict(by_kind, **{kind: by_kind[kind] + 1})
    for g, w in zip(got, dg_derivative.dg_derivative3_plain(u, d)):
        assert g.dtype == u.dtype and g.shape == u.shape
        assert _rel(g, w) <= {"float32": 1e-4, "bfloat16": 4e-2}[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("c", [1, 2, 3, 4, 5])
@pytest.mark.parametrize("n", [2, 3, 4, 5, 6, 7, 8])
def test_cuda_dg_derivative3_tiled_matches_plain(n, c, dtype):
    """Every n the tiled instance is built for, each channel width (pieces
    of 4, 2 and 1 values), ragged batches of 1 and 577 elements (a partial
    last tile), within chip_smoke.py's tolerances."""
    _need_gpu()
    assert dg_derivative.pick_instance(n, c, getattr(torch, dtype)) == "tiled"
    rng = np.random.default_rng(100 * n + c)
    for b in (1, 577):
        _dg_instance_matches_plain(*_dg_case(rng, b, n, c, dtype), "tiled",
                                   dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_dg_derivative3_tiled_takes_many_tiles_a_block(dtype):
    """More elements than the card holds blocks at once: each block walks
    over tiles through its two buffers (HIT's n = 6, 100,000 elements)."""
    _need_gpu()
    rng = np.random.default_rng(7)
    _dg_instance_matches_plain(*_dg_case(rng, 100_000, 6, 4, dtype), "tiled",
                               dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,c", [(9, 4), (4, 4)])
def test_cuda_dg_derivative3_generic_matches_plain(n, c, dtype):
    """The generic instance: the rule's pick at n = 9, and forced at the
    channel's n = 4 (as chip_smoke.py times it)."""
    _need_gpu()
    rng = np.random.default_rng(n)
    u, d = _dg_case(rng, 577, n, c, dtype)
    if n == 9:
        assert dg_derivative.pick_instance(n, c, u.dtype) == "generic"
    _dg_instance_matches_plain(u, d, "generic", dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_smagorinsky_matches_plain(dtype):
    _need_gpu()
    rng = np.random.default_rng(2)
    tdt = getattr(torch, dtype)
    p = 16 * 2304
    g = torch.from_numpy(rng.standard_normal((p, 3, 3)).astype(
        np.float32)).to("cuda", tdt)
    cs = torch.full((p,), 0.1, device="cuda", dtype=tdt)
    before = smagorinsky.smagorinsky_nut.launches
    got = smagorinsky.smagorinsky_nut(g, cs, 0.0833)
    torch.cuda.synchronize()
    assert smagorinsky.smagorinsky_nut.launches == before + 1
    assert _rel(got, smagorinsky.smagorinsky_nut_plain(g, cs, 0.0833)) <= \
        CARD_TOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("layout", ["rows of (P, 4, 3)", "offset rows",
                                    "unaligned rows", "stride-0 cs",
                                    "wide stride"])
@pytest.mark.parametrize("p", [16 * 2304, 1007])
def test_cuda_smagorinsky_reads_views_in_place(p, layout, dtype):
    """The velocity rows of a (P, 4, 3) gradient (s_p = 12, 16-byte aligned:
    staged), the same rows one point into a larger buffer (48 bytes: still
    aligned in float32, not in bf16), offset by 9 values (not 16-byte
    aligned: read value by value), with a stride-0 C_s, and with a point
    stride of 60 (more than the kernel stages); P of the channel path and a
    ragged one."""
    _need_gpu()
    rng = np.random.default_rng(p)
    tdt = getattr(torch, dtype)
    offset, s_p = {"offset rows": (12, 12), "unaligned rows": (9, 12),
                   "wide stride": (0, 60)}.get(layout, (0, 12))
    buf = torch.from_numpy(rng.standard_normal(offset + p * s_p).astype(
        np.float32)).to("cuda", tdt)
    g = buf[offset:].view(p, s_p // 3, 3)[:, :3]
    cs = (torch.full((), 0.17, dtype=tdt, device="cuda").expand(p)
          if layout == "stride-0 cs" else torch.from_numpy(
              rng.uniform(0.0, 0.5, p).astype(np.float32)).to("cuda", tdt))
    before = smagorinsky.smagorinsky_nut.launches
    got = smagorinsky.smagorinsky_nut(g, cs, 0.0833)
    torch.cuda.synchronize()
    assert smagorinsky.smagorinsky_nut.launches == before + 1
    assert _rel(got, smagorinsky.smagorinsky_nut_plain(
        g.contiguous(), cs.contiguous(), 0.0833)) <= CARD_TOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("iters", [8, 12])
@pytest.mark.parametrize("p", [16 * 144, 2 * 16 * 144])
def test_cuda_wall_model_matches_plain(iters, dtype, p):
    """One wall of the channel path (16 envs x 144 columns) and both walls
    in one batch, as the path calls it."""
    _need_gpu()
    rng = np.random.default_rng(3)
    tdt = getattr(torch, dtype)
    up = torch.from_numpy(np.geomspace(1e-3, 1.6, p).astype(
        np.float32)).to("cuda", tdt)
    rho = torch.from_numpy(rng.uniform(0.9, 1.1, p).astype(
        np.float32)).to("cuda", tdt)
    kw = dict(y_m=0.25, nu=2e-3, kappa=0.41, iters=iters)
    before = wall_model.wall_model_tau.launches
    got = wall_model.wall_model_tau(up, rho, **kw)
    torch.cuda.synchronize()
    assert wall_model.wall_model_tau.launches == before + 1
    assert _rel(got, wall_model.wall_model_tau_plain(up, rho, **kw)) <= \
        CARD_TOL[dtype]
