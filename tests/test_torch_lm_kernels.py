"""PyTorch port vs JAX reference: the LM path's two kernels.

The plain versions of the port (`mha_chunked` and `mha`,
`linear_scan_chunked` and `linear_scan_sequential`, against which the CUDA
kernels are held on the card) run against the JAX Pallas kernels in
interpret mode and against the oracles `ref.mha` / `ref.linear_scan`, on the
same numpy inputs.  The CUDA kernels have no CPU mode: their tests are
marked `cuda` and skip without a GPU.

Tolerances, relative to max |reference|:
  float32   2e-6: both sides compute the same float32 formulas in another
            order (the chunked scan's exp/log pair decays against the
            oracle's products); measured errors are written beside each
            test.
  bfloat16  2e-2: the math is float32 on both sides from the same bf16
            inputs, but a last-bit float32 difference can flip the final
            rounding to bf16 (2^-8 = 3.9e-3 of the value) and the
            reference's own rounding of the chunked intermediate differs.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref
from repro.kernels.flash_attention import flash_attention as pallas_fa
from repro.kernels.linear_scan import linear_scan as pallas_ls
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import linear_scan as ls
from repro_torch.kernels import ops
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

TOL = {"attention": {"float32": 2e-6, "bfloat16": 2e-2},
       "scan": {"float32": 2e-6, "bfloat16": 2e-2}}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def _pair(x: np.ndarray, dtype: str):
    """The same values for both packages, rounded once to `dtype`."""
    j = jnp.asarray(x).astype(JDT[dtype])
    t = torch.from_numpy(np.array(j.astype(jnp.float32))).to(
        getattr(torch, dtype))
    return j, t


def _rel(got: torch.Tensor, want) -> float:
    """max |got - want| / max |want|; `want` a JAX array or a tensor."""
    want = (want.float().cpu().numpy() if isinstance(want, torch.Tensor)
            else np.asarray(jnp.asarray(want).astype(jnp.float32)))
    return float(np.max(np.abs(got.float().cpu().numpy() - want))
                 / np.max(np.abs(want)))


# --- attention ----------------------------------------------------------------
# (b, hq, hkv, sq, skv, d, causal, window, softcap): GQA groups 1/2/5, causal
# on and off, window None/6, softcap None/30, Sq < Skv, ragged sizes, D 16/64
FLASH_CASES = [
    (2, 4, 4, 24, 24, 16, True, None, None),
    (2, 4, 2, 40, 40, 64, True, 6, None),
    (1, 5, 1, 37, 37, 16, True, 6, 30.0),
    (2, 4, 2, 33, 33, 64, False, None, None),
    (1, 10, 2, 29, 29, 16, False, 6, 30.0),
    (2, 4, 2, 9, 50, 64, True, None, None),
    (1, 5, 1, 7, 45, 16, True, 6, None),
    (1, 2, 2, 1, 19, 64, True, 6, 30.0),
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_plain_matches_pallas_and_oracle(case, dtype):
    """`mha_chunked` (the kernel's plain version, block_k=16 so several kv
    blocks and a ragged last one) and `mha` against the Pallas kernel
    (interpret mode, 16x16 blocks) and `ref.mha`.  Measured max over the
    grid: float32 6.7e-7, bfloat16 1.2e-3 of max |reference|."""
    b, hq, hkv, sq, skv, d, causal, window, softcap = case
    rng = np.random.default_rng(sum(case[:6]))
    q, tq = _pair(rng.standard_normal((b, hq, sq, d), np.float32), dtype)
    k, tk = _pair(rng.standard_normal((b, hkv, skv, d), np.float32), dtype)
    v, tv = _pair(rng.standard_normal((b, hkv, skv, d), np.float32), dtype)
    kw = dict(causal=causal, window=window, softcap=softcap)
    kernel = pallas_fa(q, k, v, block_q=16, block_k=16, interpret=True, **kw)
    oracle = ref.mha(q, k, v, **kw)
    chunked = fa.mha_chunked(tq, tk, tv, block_k=16, **kw)
    naive = fa.mha(tq, tk, tv, **kw)
    tol = TOL["attention"][dtype]
    for got in (chunked, naive):
        assert got.shape == tq.shape and got.dtype == tq.dtype
        assert _rel(got, kernel) <= tol
        assert _rel(got, oracle) <= tol


def test_flash_rows_without_keys_give_zero():
    """Sq > Skv under a causal mask: the first rows see no key.  The kernel
    contract (and `mha_chunked`) gives 0 there, as the Pallas kernel does;
    the other rows match it."""
    rng = np.random.default_rng(3)
    q, tq = _pair(rng.standard_normal((1, 2, 12, 16), np.float32), "float32")
    k, tk = _pair(rng.standard_normal((1, 2, 8, 16), np.float32), "float32")
    got = fa.mha_chunked(tq, tk, tk, block_k=4)
    want = pallas_fa(q, k, k, block_q=4, block_k=4, interpret=True)
    assert torch.all(got[:, :, :4] == 0)
    assert _rel(got, want) <= TOL["attention"]["float32"]


def test_attention_dispatch_forms_agree():
    """`ops.attention`'s three impls on the CPU: "kernel" (the wrapper's
    plain version), "chunked" and "naive" agree; an unknown impl raises."""
    rng = np.random.default_rng(4)
    q, k, v = (torch.from_numpy(rng.standard_normal(s, np.float32))
               for s in ((2, 4, 20, 16), (2, 2, 20, 16), (2, 2, 20, 16)))
    outs = [ops.attention(q, k, v, window=6, impl=impl, block_k=8)
            for impl in ("kernel", "chunked", "naive")]
    for o in outs[1:]:
        torch.testing.assert_close(o, outs[0], rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError):
        ops.attention(q, k, v, impl="flash")


def test_flash_instance_follows_dtype():
    """bf16 goes to the tensor-core kernel, float32 to the CUDA-core one;
    any other dtype raises, as `_check_inputs` does."""
    assert fa.instance(torch.bfloat16) == "tensor_core"
    assert fa.instance(torch.float32) == "cuda_core"
    assert set(fa.SOURCES) == set(fa.flash_attention.instance_launches)
    for dtype in (torch.float16, torch.float64):
        with pytest.raises(TypeError):
            fa.instance(dtype)


@pytest.mark.parametrize("d,dp", [(1, 64), (16, 64), (64, 64), (65, 128),
                                  (80, 128), (128, 128), (129, 256),
                                  (256, 256)])
def test_flash_head_dim_padding(d, dp):
    """D pads to the tensor-core instance 64, 128 or 256; D outside
    1..256 raises."""
    assert fa.padded_head_dim(d) == dp
    assert dp in fa.TC_TILES


def test_flash_head_dim_out_of_range():
    for d in (0, 257):
        with pytest.raises(ValueError):
            fa.padded_head_dim(d)


def test_flash_tc_tiles_match_the_cuda_source():
    """`TC_TILES` (what the wrapper passes and the kernel checks) is the
    `Tile` table of csrc/flash_attention_tc.cu: 64 query rows per consumer
    warpgroup, keys per tile; every box fits TMA's 256-row limit and the
    shared memory fits the card's 227 KB."""
    import pathlib
    import re

    src = (pathlib.Path(fa.__file__).parent / "csrc"
           / fa.SOURCES["tensor_core"]).read_text()
    table = {int(dp): (64 * int(nc), int(bn), int(stages))
             for dp, nc, bn, stages in re.findall(
                 r"struct Tile<(\d+)> \{\s*static constexpr int NC = (\d+), "
                 r"BN = (\d+), STAGES = (\d+);", src)}
    assert {dp: t[:2] for dp, t in table.items()} == fa.TC_TILES
    for dp, (bm, bn, stages) in table.items():
        assert bm <= 256 and bn <= 256 and bn % 16 == 0
        smem = 1024 + (bm + 2 * stages * bn) * dp * 2 + 8 * (1 + 3 * stages)
        assert smem <= 232448


def test_flash_tma_strides_of_model_views():
    """The model's q/k/v are (B, S, H, D) transposed to (B, H, S, D): TMA
    takes them as they are, with byte strides in (B, H, S) order; an axis
    of size 1 gets a stride TMA takes, whatever its own."""
    x = torch.zeros((2, 40, 5, 16), dtype=torch.bfloat16).transpose(1, 2)
    assert fa.tma_strides(x) == (40 * 5 * 16 * 2, 16 * 2, 5 * 16 * 2)
    one = torch.zeros((1, 40, 1, 64), dtype=torch.bfloat16).transpose(1, 2)
    sb, sh, ss = fa.tma_strides(one)
    assert ss == 64 * 2 and sb % 16 == 0 and sh % 16 == 0
    assert sb > 0 and sh > 0


@pytest.mark.parametrize("bad", ["odd_head_dim", "offset_base",
                                 "sliced_seq"])
def test_flash_tma_strides_raise_on_what_tma_cannot_take(bad):
    """A stride that is not a multiple of 16 bytes or a base that is not
    16-byte aligned raises ValueError, as `_check_inputs` does for a bf16
    CUDA call; nothing is copied."""
    base = torch.zeros((2, 4, 32, 24), dtype=torch.bfloat16)
    t = {"odd_head_dim": base[..., :12].reshape(2, 4, 32, 12)[..., :7]
         .contiguous(),
         "offset_base": base.flatten()[4:4 + 2 * 4 * 32 * 16].view(
             2, 4, 32, 16),
         "sliced_seq": base[:, :, :, :20].contiguous()[:, :, ::3]}[bad]
    if bad == "offset_base":
        assert t.data_ptr() % 16 == 8
    with pytest.raises(ValueError):
        fa.tma_strides(t)
    with pytest.raises(ValueError):
        fa._check_inputs(t, t, t, None, None)


# --- linear scan --------------------------------------------------------------
# (b, t, dk, dv, decay_before_read, with_u, with_s0, chunk): both reads,
# with and without u / s0, ragged T, T = 1
SCAN_CASES = [
    (3, 37, 16, 64, True, False, False, 8),
    (3, 37, 16, 64, True, False, True, 8),
    (2, 1, 16, 64, True, False, True, 8),
    (2, 40, 8, 16, False, True, True, 16),
    (2, 29, 8, 16, False, False, False, 8),
    (2, 1, 8, 16, False, True, True, 8),
]


def _scan_inputs(case, dtype):
    b, t, dk, dv, _, with_u, with_s0, _ = case
    rng = np.random.default_rng(sum(case[:4]))
    q = rng.standard_normal((b, t, dk), np.float32)
    k = 0.3 * rng.standard_normal((b, t, dk), np.float32)
    v = rng.standard_normal((b, t, dv), np.float32)
    w = np.exp(-rng.uniform(0.0, 0.7, (b, t, dk))).astype(np.float32)
    u = rng.standard_normal((dk,), np.float32) if with_u else None
    s0 = rng.standard_normal((b, dk, dv), np.float32) if with_s0 else None
    pairs = [_pair(x, dtype) for x in (q, k, v, w)]
    if u is not None:
        pairs.append(_pair(u, dtype))
    else:
        pairs.append((None, None))
    # s0 is float32 in every caller (the SSM state)
    pairs.append(_pair(s0, "float32") if s0 is not None else (None, None))
    return [p[0] for p in pairs], [p[1] for p in pairs]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", SCAN_CASES)
def test_scan_plain_matches_pallas_and_oracle(case, dtype):
    """`linear_scan` on a CPU tensor (the kernel's plain version:
    `linear_scan_chunked`, o cast to q's dtype) and `linear_scan_sequential`
    against the Pallas kernel (interpret mode) and `ref.linear_scan`: o and
    S_final.  Measured max over the grid, of max |reference|: float32 2.5e-7
    (o) and 1.7e-7 (S_final), the sequential form 2.7e-7; bfloat16 3.0e-3
    (o, rounded to bf16) and 1.7e-7 (S_final, float32)."""
    dbr, chunk = case[4], case[7]
    jx, tx = _scan_inputs(case, dtype)
    o_k, s_k = pallas_ls(*jx, decay_before_read=dbr, chunk=chunk,
                         interpret=True)
    o_r, s_r = ref.linear_scan(*jx, decay_before_read=dbr)
    o_p, s_p = ls.linear_scan(*tx, decay_before_read=dbr, chunk=chunk)
    o_s, s_s = ls.linear_scan_sequential(*tx, decay_before_read=dbr)
    assert o_p.dtype == tx[0].dtype and s_p.dtype == torch.float32
    assert o_s.dtype == torch.float32 and s_s.dtype == torch.float32
    tol = TOL["scan"][dtype]
    assert _rel(o_p, o_k) <= tol and _rel(s_p, s_k) <= tol
    assert _rel(o_p, o_r) <= tol and _rel(s_p, s_r) <= tol
    assert _rel(o_s, o_r) <= TOL["scan"]["float32"]
    assert _rel(s_s, s_r) <= TOL["scan"]["float32"]


def test_scan_mixed_operand_dtypes():
    """The SSM branch's mix: q and v bf16, k and w f32.  The plain version
    returns o in bf16 and S_final in f32, and matches the Pallas kernel fed
    the same mix within the bf16 tolerance."""
    rng = np.random.default_rng(7)
    shapes = ((4, 21, 16), (4, 21, 16), (4, 21, 64), (4, 21, 16))
    raw = [rng.standard_normal(s, np.float32) for s in shapes]
    raw[3] = np.exp(-np.abs(raw[3])).astype(np.float32)
    dts = ("bfloat16", "float32", "bfloat16", "float32")
    pairs = [_pair(x, dt) for x, dt in zip(raw, dts)]
    o_k, s_k = pallas_ls(*(p[0] for p in pairs), decay_before_read=True,
                         chunk=8, interpret=True)
    o_p, s_p = ls.linear_scan(*(p[1] for p in pairs), decay_before_read=True,
                              chunk=8)
    assert o_p.dtype == torch.bfloat16 and s_p.dtype == torch.float32
    assert _rel(o_p, o_k) <= TOL["scan"]["bfloat16"]
    assert _rel(s_p, s_k) <= TOL["scan"]["float32"]


def test_scan_dispatch_forms_agree():
    """`ops.gated_linear_scan`'s three impls on the CPU agree; "chunked" and
    "scan" return o in float32 as in the reference, "kernel" in q's dtype;
    an unknown impl raises."""
    jx, tx = _scan_inputs((2, 19, 8, 16, False, True, True, 8), "bfloat16")
    outs = {impl: ops.gated_linear_scan(*tx, impl=impl, chunk=8)
            for impl in ("kernel", "chunked", "scan")}
    assert outs["kernel"][0].dtype == torch.bfloat16
    assert outs["chunked"][0].dtype == outs["scan"][0].dtype == torch.float32
    torch.testing.assert_close(outs["chunked"][0], outs["scan"][0],
                               rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(outs["kernel"][1], outs["scan"][1],
                               rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError):
        ops.gated_linear_scan(*tx, impl="pallas")


# --- the chunked CUDA instance's algebra, emulated on the CPU -----------------
def _chunked_instance_emulation(q, k, v, w, u, s0, *, decay_before_read,
                                chunk):
    """Phases A-C of csrc/linear_scan_chunked.cu in PyTorch, float32:
    A each chunk's end state from zero, S_loc = sum_s (k_s * prod_{s<r}
    w_r) v_s^T, with the decays as running products of w taken backwards,
    and its decay product; B the carry over the chunk summaries, S_in(c+1)
    = diag(prod w_c) S_in(c) + S_loc(c); C each chunk's outputs by the step
    recurrence from S_in(c).  Padding beyond T: q = k = v = 0, w = 1."""
    b, t, dk = q.shape
    dv = v.shape[-1]
    nc = -(-t // chunk)
    pad = nc * chunk - t
    q, k, v, w = (torch.nn.functional.pad(x.float(), (0, 0, 0, pad),
                                          value=1.0 if x is w else 0.0)
                  for x in (q, k, v, w))
    q, k, v, w = (x.reshape(b, nc, chunk, -1) for x in (q, k, v, w))
    # A
    decay = torch.ones_like(w)
    d = torch.ones_like(w[:, :, 0])
    for s in range(chunk - 1, -1, -1):
        decay[:, :, s] = d
        d = d * w[:, :, s]
    s_loc = torch.einsum("bcsi,bcsj->bcij", k * decay, v)
    # B
    state = (torch.zeros((b, dk, dv)) if s0 is None else s0.float())
    s_in = []
    for c in range(nc):
        s_in.append(state)
        state = d[:, c, :, None] * state + s_loc[:, c]
    # C
    st = torch.stack(s_in, dim=1)
    ones = torch.ones(dk) if u is None else u.float()
    outs = []
    for s in range(chunk):
        kv = k[:, :, s, :, None] * v[:, :, s, None, :]
        if decay_before_read:
            st = w[:, :, s, :, None] * st + kv
            outs.append(torch.einsum("bci,bcij->bcj", q[:, :, s], st))
        else:
            outs.append(torch.einsum("bci,bcij->bcj", q[:, :, s],
                                     st + ones[:, None] * kv))
            st = w[:, :, s, :, None] * st + kv
    o = torch.stack(outs, dim=2).reshape(b, nc * chunk, dv)[:, :t]
    return o, state


# (b, t, dk, dv, decay_before_read, with_u, with_s0, chunk): both reads,
# u and s0 present and absent, ragged T, one chunk, a chunk plus one step,
# and the plans' chunks of hymba's (16, 64) and RWKV6's (64, 64) states
CHUNKED_CASES = [
    (3, 37, 16, 64, True, False, False, 8),
    (3, 37, 16, 64, True, False, True, 8),
    (2, 40, 8, 16, False, True, True, 16),
    (2, 29, 8, 16, False, False, False, 8),
    (2, 64, 16, 64, True, False, False, 64),
    (2, 65, 16, 64, True, False, True, 64),
    (2, 70, 64, 64, False, True, True, 32),
    (2, 45, 64, 64, False, False, False, 32),
]


@pytest.mark.parametrize("case", CHUNKED_CASES)
def test_chunked_instance_algebra_matches_oracle(case):
    """The chunked instance's three phases, emulated in float32, against
    `linear_scan_sequential` and the JAX oracle `ref.linear_scan`: o and
    S_final within the float32 pin of 2e-6 of max |reference| (measured
    <= 2.7e-7)."""
    dbr, chunk = case[4], case[7]
    jx, tx = _scan_inputs(case, "float32")
    o_e, s_e = _chunked_instance_emulation(*tx, decay_before_read=dbr,
                                           chunk=chunk)
    o_s, s_s = ls.linear_scan_sequential(*tx, decay_before_read=dbr)
    o_r, s_r = ref.linear_scan(*jx, decay_before_read=dbr)
    tol = TOL["scan"]["float32"]
    assert o_e.shape == o_s.shape and s_e.shape == s_s.shape
    assert _rel(o_e, o_s) <= tol and _rel(s_e, s_s) <= tol
    assert _rel(o_e, o_r) <= tol and _rel(s_e, s_r) <= tol


def test_scan_instance_rule_and_chunked_plan():
    """T of at least one chunk of 64 steps with dk <= 64 takes the chunked
    instance (hymba's prefills of 2,048 and 700 tokens, RWKV6's 64 x 64
    state); decode (T = 1), T below a chunk and dk above 64 take the step
    kernel.  The plans: hymba's (16, 64) one lane a column, 64 columns, 64
    steps a chunk; RWKV6's (64, 64) four lanes, 64 columns, 32 steps."""
    assert ls.pick_instance(1, 16) == "step"
    assert ls.pick_instance(63, 16) == "step"
    assert ls.pick_instance(64, 16) == "chunked"
    assert ls.pick_instance(700, 16) == "chunked"
    assert ls.pick_instance(2048, 16) == "chunked"
    assert ls.pick_instance(512, 64) == "chunked"
    assert ls.pick_instance(512, 65) == "step"
    assert ls.chunked_plan(16, 64) == (1, 64, 64)
    assert ls.chunked_plan(64, 64) == (4, 64, 32)
    assert ls.chunked_plan(8, 16) == (1, 32, 64)
    assert ls.chunked_plan(16, 1000) == (1, 256, 32)
    for dk, dv in ((1, 1), (16, 64), (33, 7), (64, 64), (64, 65535)):
        g, cols, chunk = ls.chunked_plan(dk, dv)
        assert 16 * g >= dk and 32 <= g * cols <= 256
        assert chunk * (18 * 16 * g + 4 * cols) <= ls.CHUNKED_SMEM_BUDGET
    with pytest.raises(ValueError):
        ls.chunked_plan(65, 64)


def test_chunked_scan_constants_match_the_cuda_source():
    """The layout constants `chunked_plan` reckons with are those of
    csrc/linear_scan_chunked.cu."""
    import pathlib
    import re

    src = (pathlib.Path(ls.__file__).parent / "csrc"
           / ls.SOURCES["chunked"]).read_text()
    consts = {name: int(eval(val)) for name, val in re.findall(
        r"constexpr int (k\w+) = ([\d *]+);", src)}
    assert consts["kRows"] == ls.CHUNKED_ROWS
    assert consts["kMaxDk"] == ls.CHUNKED_MAX_DK
    assert consts["kMaxThreads"] == ls.CHUNKED_MAX_THREADS
    assert consts["kMaxChunk"] == ls.CHUNKED_MAX_CHUNK
    assert consts["kSmemBudget"] == ls.CHUNKED_SMEM_BUDGET
    assert ls.SOURCES == {"step": "linear_scan.cu",
                          "chunked": "linear_scan_chunked.cu"}


# --- the CUDA kernels (on the card only) -------------------------------------
def _need_gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")


CARD_TOL = {"float32": 1e-4, "bfloat16": 4e-2}
# flash attention's bf16 instance (tensor cores, P rounded to bf16 before
# P V): chip_smoke.py's pin, 1.5e-2 (measured there up to 4.8e-3)
FLASH_CARD_TOL = {"float32": 1e-4, "bfloat16": 1.5e-2}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", FLASH_CASES + [
    (2, 25, 5, 300, 300, 64, True, 128, None),
    (1, 4, 2, 70, 70, 128, True, None, 50.0),
    (1, 4, 4, 65, 65, 80, False, None, None),
    (1, 2, 1, 40, 40, 256, True, 16, None),
    (1, 2, 1, 200, 200, 256, False, None, 30.0),
    (1, 5, 1, 2047, 2047, 64, True, 1024, None),
    (1, 4, 2, 130, 130, 128, True, None, None),
    (2, 4, 2, 12, 8, 64, True, None, None),
    (1, 25, 5, 129, 1100, 64, True, 1024, None)])
def test_cuda_flash_attention_matches_plain(case, dtype):
    """Each instance (bf16: tensor cores, float32: CUDA cores) vs
    `mha_chunked` on the card, within chip_smoke.py's gates (float32 1e-4,
    bfloat16 1.5e-2 of max |plain|); one launch per call, of its instance.
    The cases cover D 16 to 256 (80 padded to 128), S that is no multiple
    of any tile, and Sq > Skv (rows with no key give 0)."""
    _need_gpu()
    b, hq, hkv, sq, skv, d, causal, window, softcap = case
    rng = np.random.default_rng(sum(case[:6]))
    tdt = getattr(torch, dtype)
    q, k, v = (torch.from_numpy(rng.standard_normal(s, np.float32)).to(
        "cuda", tdt) for s in ((b, hq, sq, d), (b, hkv, skv, d),
                               (b, hkv, skv, d)))
    kw = dict(causal=causal, window=window, softcap=softcap)
    kind = fa.instance(tdt)
    before = fa.flash_attention.launches
    before_kind = fa.flash_attention.instance_launches[kind]
    got = fa.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == before + 1
    assert fa.flash_attention.instance_launches[kind] == before_kind + 1
    want = fa.mha_chunked(q, k, v, **kw)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert _rel(got, want) <= FLASH_CARD_TOL[dtype]
    if causal and sq > skv:
        assert torch.all(got[:, :, :sq - skv] == 0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [64, 80, 128])
def test_cuda_flash_attention_takes_the_models_views(d, dtype):
    """q, k, v as `models/attention.py:_qkv` hands them over: (B, S, H, D)
    projections transposed to (B, H, S, D), read in place by TMA (bf16)
    or by strided loads (float32)."""
    _need_gpu()
    rng = np.random.default_rng(d)
    tdt = getattr(torch, dtype)
    b, s, hq, hkv = 2, 333, 10, 2
    q, k, v = (torch.from_numpy(rng.standard_normal(shape, np.float32)).to(
        "cuda", tdt).transpose(1, 2) for shape in ((b, s, hq, d),
                                                   (b, s, hkv, d),
                                                   (b, s, hkv, d)))
    assert not q.is_contiguous()
    got = fa.flash_attention(q, k, v, window=100)
    torch.cuda.synchronize()
    want = fa.mha_chunked(q.contiguous(), k.contiguous(), v.contiguous(),
                          window=100)
    assert _rel(got, want) <= FLASH_CARD_TOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", SCAN_CASES + [
    (50, 300, 16, 64, True, False, True, 64),
    (8, 200, 64, 64, False, True, True, 64),
    (2, 20, 16, 1000, True, False, True, 64),
    (2, 17, 130, 33, False, True, True, 64)])
def test_cuda_linear_scan_matches_plain(case, dtype):
    """Kernel vs `linear_scan_chunked` on the card, within chip_smoke.py's
    gates; the extra cases tile a wide dv over many blocks and split dk
    over lanes."""
    _need_gpu()
    _, tx = _scan_inputs(case, dtype)
    tx = [x.cuda() if x is not None else None for x in tx]
    dbr = case[4]
    before = ls.linear_scan.launches
    o, s = ls.linear_scan(*tx, decay_before_read=dbr)
    torch.cuda.synchronize()
    assert ls.linear_scan.launches == before + 1
    o_p, s_p = ls.linear_scan_chunked(*tx, decay_before_read=dbr)
    assert o.dtype == tx[0].dtype and s.dtype == torch.float32
    assert _rel(o, o_p.to(o.dtype)) <= CARD_TOL[dtype]
    assert _rel(s, s_p) <= CARD_TOL["float32"]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CHUNKED_CASES + [
    (50, 300, 16, 64, True, False, True, 64),
    (8, 200, 64, 64, False, True, True, 64),
    (4, 700, 16, 64, True, False, True, 64),
    (2, 100, 16, 1000, True, False, True, 64),
    (3, 130, 8, 16, False, True, False, 64)])
def test_cuda_chunked_linear_scan_matches_plain(case, dtype):
    """The chunked instance, named, vs `linear_scan_chunked` on the card
    within chip_smoke.py's gates (float32 o 1e-4, bf16 o 4e-2, S_final
    1e-4 of max |plain|); at T >= 64 with dk <= 64 it is also the instance
    that the rule picks.  Below one chunk (T = 1, 29, 37, 40, 45) it runs a
    single ragged chunk."""
    _need_gpu()
    _, tx = _scan_inputs(case, dtype)
    tx = [x.cuda() if x is not None else None for x in tx]
    dbr = case[4]
    by_instance = ls.linear_scan.instance_launches
    before = dict(by_instance)
    o, s = ls.linear_scan(*tx, decay_before_read=dbr, instance="chunked")
    torch.cuda.synchronize()
    assert by_instance == dict(before, chunked=before["chunked"] + 1)
    o_p, s_p = ls.linear_scan_chunked(*tx, decay_before_read=dbr)
    assert o.dtype == tx[0].dtype and s.dtype == torch.float32
    assert _rel(o, o_p.to(o.dtype)) <= CARD_TOL[dtype]
    assert _rel(s, s_p) <= CARD_TOL["float32"]
    if case[1] >= 64:
        ls.linear_scan(*tx, decay_before_read=dbr)
        assert by_instance["chunked"] == before["chunked"] + 2


@pytest.mark.cuda
def test_cuda_wrappers_raise_on_what_the_kernels_do_not_take():
    _need_gpu()
    q = torch.randn((1, 2, 8, 16), device="cuda")
    with pytest.raises(TypeError):
        fa.flash_attention(q.half(), q.half(), q.half())
    with pytest.raises(TypeError):
        fa.flash_attention(q, q.bfloat16(), q)
    with pytest.raises(ValueError):
        big = torch.randn((1, 2, 8, 264), device="cuda")
        fa.flash_attention(big, big, big)
    with pytest.raises(ValueError):
        fa.flash_attention(q, q[:, :, :, :8], q)
    with pytest.raises(ValueError):  # head_dim not the unit-stride axis
        fa.flash_attention(q, q.transpose(2, 3).contiguous().transpose(2, 3),
                           q)
    # an input that requires grad: the kernel forward, the backward of
    # mha_chunked (it used to raise: the kernels were forward only)
    qg = q.clone().requires_grad_()
    out = fa.flash_attention(qg, q, q)
    grad = torch.randn_like(out)
    qp = q.clone().requires_grad_()
    assert _rel(torch.autograd.grad(out, qg, grad)[0],
                torch.autograd.grad(fa.mha_chunked(qp, q, q), qp, grad)[0]) \
        <= CARD_TOL["float32"]
    # bf16 views that TMA cannot read raise; nothing is copied
    h = torch.randn((1, 2, 32, 20), device="cuda").bfloat16()
    with pytest.raises(ValueError):  # rows 40 bytes apart
        fa.flash_attention(h[..., :16], h[..., :16], h[..., :16])
    with pytest.raises(ValueError):  # base 8 bytes past 16-byte alignment
        g = h.flatten()[4:4 + 2 * 32 * 16].view(1, 2, 32, 16)
        fa.flash_attention(g, g, g)
    x = torch.randn((2, 5, 16), device="cuda")
    v = torch.randn((2, 5, 64), device="cuda")
    with pytest.raises(TypeError):
        ls.linear_scan(x.half(), x, v, x)
    with pytest.raises(ValueError):
        ls.linear_scan(x, x, v[:, :4], x)
    with pytest.raises(ValueError):
        ls.linear_scan(x, x, v, x.transpose(0, 1).contiguous().transpose(0, 1))
    with pytest.raises(ValueError):
        ls.linear_scan(x, x, v, x, s0=torch.zeros((2, 16, 8), device="cuda"))
    xg, xp = x.clone().requires_grad_(), x.clone().requires_grad_()
    o, s_fin = ls.linear_scan(xg, xg, v, x)
    o_p, s_p = ls.linear_scan_chunked(xp, xp, v, x)
    go, gs = torch.randn_like(o), torch.randn_like(s_fin)
    assert _rel(torch.autograd.grad((o, s_fin), xg, (go, gs))[0],
                torch.autograd.grad((o_p, s_p), xp, (go, gs))[0]) \
        <= CARD_TOL["float32"]
    with torch.no_grad():
        o, _ = ls.linear_scan(x, x, v, x)
    assert o.shape == (2, 5, 64)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_kernel_gradients_match_plain(dtype):
    """On the card, through the autograd Functions: flash attention's
    gradients (kernel forward, `mha_chunked` backward) at a window whose
    rows have whole masked kv blocks (S > window + block_k) and globally,
    and the chunked scan's (GLA read, s0 and its gradient), against
    autograd through the plain forms, within the forward's pins."""
    _need_gpu()
    tdt = getattr(torch, dtype)
    gen = torch.Generator().manual_seed(2)
    for window in (64, None):
        q, k, v = (torch.randn(shape, generator=gen).to("cuda", tdt)
                   for shape in ((2, 4, 700, 64), (2, 2, 700, 64),
                                 (2, 2, 700, 64)))
        grad = torch.randn((2, 4, 700, 64), generator=gen).to("cuda", tdt)
        ins = [t.clone().requires_grad_() for t in (q, k, v)]
        plain = [t.clone().requires_grad_() for t in (q, k, v)]
        before = fa.flash_attention.launches
        got = torch.autograd.grad(fa.flash_attention(*ins, window=window),
                                  ins, grad)
        assert fa.flash_attention.launches == before + 1
        want = torch.autograd.grad(
            fa.mha_chunked(*plain, window=window), plain, grad)
        for a, b in zip(got, want):
            assert a.dtype == tdt
            assert _rel(a, b) <= FLASH_CARD_TOL[dtype]
    b, t, dk, dv = 50, 300, 16, 64
    qs = torch.randn((b, t, dk), generator=gen).to("cuda", tdt)
    ks = (0.25 * torch.randn((b, t, dk), generator=gen)).to("cuda")
    vs = torch.randn((b, t, dv), generator=gen).to("cuda", tdt)
    ws = torch.exp(-0.5 * torch.rand((b, t, dk), generator=gen)).to("cuda")
    s0 = torch.randn((b, dk, dv), generator=gen).to("cuda")
    go = torch.randn((b, t, dv), generator=gen).to("cuda", tdt)
    gs = torch.randn((b, dk, dv), generator=gen).to("cuda")
    ins = [x.clone().requires_grad_() for x in (qs, ks, vs, ws, s0)]
    plain = [x.clone().requires_grad_() for x in (qs, ks, vs, ws, s0)]
    before = dict(ls.linear_scan.instance_launches)
    o, s_fin = ls.linear_scan(*ins[:4], None, ins[4], decay_before_read=True)
    assert ls.linear_scan.instance_launches == dict(
        before, chunked=before["chunked"] + 1)
    got = torch.autograd.grad((o, s_fin), ins, (go, gs))
    o_p, s_p = ls.linear_scan_chunked(*plain[:4], None, plain[4],
                                      decay_before_read=True)
    want = torch.autograd.grad((o_p.to(tdt), s_p), plain, (go, gs))
    for a, w in zip(got, want):
        assert a.dtype == w.dtype
        assert _rel(a, w) <= CARD_TOL[dtype if a.dtype == tdt
                                      else "float32"]
