"""PyTorch port vs JAX reference: the hymba-1.5b serving path.

hymba reduced (8 layers in one group of 8, d_model 64, 5 query heads and 1
kv head of dim 16, window 16, SSM state 4) in float32, with the reference's
parameters carried across by `lm.load_jax_params`.  Token batches come from
the same numpy generator in both packages.  The JAX side runs jitted, with
its kernels in Pallas interpret mode where `attn_impl/scan_impl="kernel"`.

Tolerances, relative to max |reference|:
  float32 pieces and whole-slice logits: 1e-5.  Both packages compute the
      same float32 graph; they differ in summation order (matmuls, the
      chunked scan against the Pallas kernel's) and in transcendentals by
      an ulp.  Measured errors are written beside each test.
  bfloat16 logits: 1e-1.  Activations and weights are bf16 on both sides;
      PyTorch rounds every elementwise op to bf16, where XLA fuses chains in
      float32.  On these inputs the reference's own bf16 logits lie 4.5e-2
      (of max |logit|) from its float32 logits with the same bf16 weights,
      and the port's bf16 logits 4.4e-2 from the reference's: the pin is
      about twice that rounding noise.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro import nn as jnn
from repro.data import synthetic as jsynthetic
from repro.models import api as japi
from repro.models import attention as jattention
from repro.models import blocks as jblocks
from repro.models import lm as jlm
from repro.models import ssm as jssm
from repro_torch import configs, nn
from repro_torch.data import synthetic
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import linear_scan as ls
from repro_torch.models import api, attention, blocks, lm, ssm
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

ARCH = "hymba-1.5b"
F32_TOL = 1e-5
BF16_TOL = 1e-1
B, PROMPT, S = 2, 24, 40       # prompt longer than the window of 16


def _cfgs(**kw):
    """The same reduced config in both packages."""
    jcfg = dataclasses.replace(jconfigs.get_reduced(ARCH), remat=False, **kw)
    pcfg = dataclasses.replace(configs.get_reduced(ARCH), **kw)
    return jcfg, pcfg


def _rel(got: torch.Tensor, want) -> float:
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    return float(np.max(np.abs(got.float().numpy() - want))
                 / np.max(np.abs(want)))


def _np_tree(tree):
    return jax.tree.map(lambda x: np.asarray(x.astype(jnp.float32)), tree)


@pytest.fixture(scope="module")
def f32():
    """Reduced float32 configs, the reference's parameters in both packages,
    and one token batch."""
    jcfg, pcfg = _cfgs(dtype="float32")
    jparams = japi.init(jax.random.PRNGKey(0), jcfg)
    params = api.init(pcfg, device="cpu")
    lm.load_jax_params(params, _np_tree(jparams))
    batch = synthetic.lm_batch(0, B, S, pcfg.vocab)
    return jcfg, pcfg, jparams, params, batch["tokens"]


def _block_params(jparams, j=0):
    """Block b{j} of group 0 of the reference tree, and its port module."""
    return jax.tree.map(lambda a: a[0], jparams["layers"][f"b{j}"])


# --- configuration, data, weights ------------------------------------------
def test_config_and_registry_match_reference():
    """The port's hymba configs equal the reference's field by field, except
    the two impl defaults ("kernel" in the port); the registry holds every
    reference arch, the enc-dec whisper too, in the reference's order (the
    other archs' configs: `tests/test_torch_lm_families.py`,
    `tests/test_torch_whisper.py`)."""
    assert configs.ARCH_NAMES == jconfigs.ARCH_NAMES
    for get in ("get", "get_reduced"):
        ours = dataclasses.asdict(getattr(configs, get)(ARCH))
        theirs = dataclasses.asdict(getattr(jconfigs, get)(ARCH))
        assert ours.pop("attn_impl") == ours.pop("scan_impl") == "kernel"
        theirs.pop("attn_impl"), theirs.pop("scan_impl")
        assert ours == theirs
    assert configs.get("whisper-tiny").is_encdec
    with pytest.raises(KeyError, match="unknown arch"):
        configs.get("gpt-2")


def test_lm_batch_same_tokens_as_reference():
    ours = synthetic.lm_batch(5, 3, 17, 257)
    theirs = jsynthetic.lm_batch(5, 3, 17, 257)
    for key in ("tokens", "labels"):
        assert ours[key].dtype == torch.int64
        np.testing.assert_array_equal(ours[key].numpy(),
                                      np.asarray(theirs[key]))


def test_load_jax_params_covers_every_leaf(f32):
    """Reduced: every reference leaf lands in the port (values equal) and
    every port parameter is filled; a missing or surplus leaf raises."""
    _, _, jparams, params, _ = f32
    ours = dict(params.named_parameters())
    n_ref = sum(x.shape[0] if "layers" in path else 1
                for path, x in _flat(jparams))
    assert len(ours) == n_ref
    np.testing.assert_array_equal(
        ours["layers.0.b3.mixer.ssm.wdt.b"].numpy(),
        np.asarray(jparams["layers"]["b3"]["mixer"]["ssm"]["wdt"]["b"][0]))
    tree = _np_tree(jparams)
    del tree["layers"]["b7"]["ffn"]["wg"]
    with pytest.raises(KeyError):
        lm.load_jax_params(params, tree)
    tree = _np_tree(jparams)
    tree["extra"] = {"w": np.zeros((2,), np.float32)}
    with pytest.raises(KeyError):
        lm.load_jax_params(params, tree)


def _flat(tree, prefix=""):
    for key, val in tree.items():
        if isinstance(val, dict):
            yield from _flat(val, f"{prefix}{key}.")
        else:
            yield prefix + key, val


def test_full_width_param_shapes_match_reference():
    """hymba-1.5b at full width, by shape only (the port built on the meta
    device, the reference by `jax.eval_shape`): the same leaves with the
    same shapes once the group axis is sliced, 1,432,736,800 parameters."""
    cfg = configs.get(ARCH)
    with torch.device("meta"):
        params = lm.init(torch.Generator(), cfg)
    ours = {k: tuple(v.shape) for k, v in params.named_parameters()}
    ref = jax.eval_shape(lambda: japi.init(jax.random.PRNGKey(0),
                                           jconfigs.get(ARCH)))
    theirs = {}
    for path, leaf in _flat(ref):
        if path.startswith("layers."):
            for m in range(leaf.shape[0]):
                theirs[f"layers.{m}.{path[7:]}"] = tuple(leaf.shape[1:])
        else:
            theirs[path] = tuple(leaf.shape)
    assert ours == theirs
    assert sum(v.numel() for v in params.parameters()) == 1_432_736_800


def test_entry_points_need_a_gpu_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, pcfg = _cfgs()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        api.init(pcfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        api.init_caches(pcfg, 1, 8)
    params = api.init(pcfg, device="cpu")
    assert params["embed"]["table"].dtype == torch.float32
    caches = api.init_caches(pcfg, 1, 8, device="cpu")
    assert caches["layers"][0]["b7"]["mixer"]["attn"]["k"].shape == \
        (1, 1, 8, 16)


def test_init_casts_to_param_dtype():
    _, pcfg = _cfgs(param_dtype="bfloat16")
    params = api.init(pcfg, seed=3, device="cpu")
    assert {p.dtype for p in params.parameters()} == {torch.bfloat16}
    assert not any(p.requires_grad for p in params.parameters())


# --- pieces ------------------------------------------------------------------
def test_rmsnorm_rope_and_causal_conv(f32):
    """rmsnorm, the RoPE tables and rotation, the causal conv with and
    without a carried tail.  Measured max over them: 1.5e-7."""
    jcfg, _, jparams, params, _ = f32
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 7, 64), np.float32)
    jp = _block_params(jparams)
    got = nn.rmsnorm(params["layers"][0]["b0"]["norm1"], torch.from_numpy(x))
    assert _rel(got, jnn.rmsnorm(jp["norm1"], jnp.asarray(x))) <= F32_TOL
    pos = np.arange(40)
    cos, sin = attention.rope_table(torch.from_numpy(pos), 16, 10000.0)
    jcos, jsin = jattention.rope_table(jnp.asarray(pos), 16, 10000.0)
    assert _rel(cos, jcos) <= F32_TOL and _rel(sin, jsin) <= F32_TOL
    xh = rng.standard_normal((2, 5, 40, 16), np.float32)
    assert _rel(attention.apply_rope(torch.from_numpy(xh), cos, sin),
                jattention.apply_rope(jnp.asarray(xh), jcos, jsin)) <= F32_TOL
    xc = rng.standard_normal((2, 9, 80), np.float32)
    tail = rng.standard_normal((2, 3, 80), np.float32)
    conv = params["layers"][0]["b0"]["mixer"]["ssm"]["conv"]
    for t_np in (None, tail):
        got, got_tail = ssm._causal_conv(
            conv, torch.from_numpy(xc),
            None if t_np is None else torch.from_numpy(t_np))
        want, want_tail = jssm._causal_conv(
            jp["mixer"]["ssm"]["conv"], jnp.asarray(xc),
            None if t_np is None else jnp.asarray(t_np))
        assert _rel(got, want) <= F32_TOL
        assert _rel(got_tail, want_tail) <= F32_TOL


@pytest.mark.parametrize("impl", ["kernel", "chunked"])
def test_ssm_apply_seq_matches_reference(f32, impl):
    """The SSM branch of block b0 over a sequence from no state, then over
    a continuation from that state (the decode carry).  Measured max:
    3.8e-7 on both impls."""
    jcfg, pcfg, jparams, params, _ = f32
    jcfg = dataclasses.replace(jcfg, scan_impl=impl)
    pcfg = dataclasses.replace(pcfg, scan_impl=impl)
    rng = np.random.default_rng(1)
    x1, x2 = (rng.standard_normal((2, t, 64), np.float32) for t in (21, 5))
    jp = _block_params(jparams)["mixer"]["ssm"]
    pp = params["layers"][0]["b0"]["mixer"]["ssm"]
    out1, st1 = ssm.apply_seq(pp, pcfg, torch.from_numpy(x1))
    jout1, jst1 = jssm.apply_seq(jp, jcfg, jnp.asarray(x1))
    out2, st2 = ssm.apply_seq(pp, pcfg, torch.from_numpy(x2), st1)
    jout2, jst2 = jssm.apply_seq(jp, jcfg, jnp.asarray(x2), jst1)
    for got, want in ((out1, jout1), (st1["s"], jst1["s"]),
                      (st1["conv"], jst1["conv"]), (out2, jout2),
                      (st2["s"], jst2["s"]), (st2["conv"], jst2["conv"])):
        assert got.dtype == torch.float32
        assert _rel(got, want) <= F32_TOL


@pytest.mark.parametrize("window", [None, 16])
def test_attention_prefill_and_decode_match_reference(f32, window):
    """Prefill of 24 tokens into a cache of 30 (a ring buffer of 16 for the
    window: it wraps), then 3 decode steps; outputs and caches.  Measured
    max: 5.5e-7."""
    jcfg, pcfg, jparams, params, _ = f32
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 27, 64), np.float32)
    jp = _block_params(jparams)["mixer"]["attn"]
    pp = params["layers"][0]["b0"]["mixer"]["attn"]
    jcache = jattention.init_cache(jcfg, 2, 30, window=window,
                                   dtype=jnp.float32)
    cache = attention.init_cache(pcfg, 2, 30, window=window,
                                 dtype=torch.float32)
    out, cache = attention.prefill_attention(
        pp, pcfg, torch.from_numpy(x[:, :24]), cache, window=window)
    jout, jcache = jattention.prefill_attention(
        jp, jcfg, jnp.asarray(x[:, :24]), jcache, window=window)
    assert _rel(out, jout) <= F32_TOL
    for t in range(24, 27):
        for key in ("k", "v"):
            assert _rel(cache[key], jcache[key]) <= F32_TOL
        assert cache["pos"] == int(jcache["pos"]) == t
        out, cache = attention.decode_attention(
            pp, pcfg, torch.from_numpy(x[:, t:t + 1]), cache, window=window)
        jout, jcache = jattention.decode_attention(
            jp, jcfg, jnp.asarray(x[:, t:t + 1]), jcache, window=window)
        assert _rel(out, jout) <= F32_TOL


@pytest.mark.parametrize("ffn,norm,post_norms,parallel_block", [
    ("gelu_mlp", "layernorm", False, False),
    ("geglu", "rmsnorm", True, False),
    ("swiglu", "layernorm_nobias", False, True)])
def test_attention_block_variants_match_reference(ffn, norm, post_norms,
                                                  parallel_block):
    """The block assembly beyond hymba's: an attention-only mixer with each
    dense FFN, each norm, gemma-2's post norms and command-r's parallel
    block, in train mode, then prefill of 9 tokens and one decode step
    with the cache.  Measured max: 4.6e-7."""
    kw = dict(mixer="attn", ffn=ffn, norm=norm, post_norms=post_norms,
              parallel_block=parallel_block, dtype="float32")
    jcfg, pcfg = _cfgs(**kw)
    for cfg in (jcfg, pcfg):
        assert cfg.ffn == ffn
    jkind = jblocks.layer_kind(jcfg, 0)
    kind = blocks.layer_kind(pcfg, 0)
    jp = jblocks.init_block(jax.random.PRNGKey(3), jcfg, jkind)
    pp = nn.ParamTree(jax.tree.map(lambda a: torch.tensor(np.asarray(a)), jp))
    x = np.random.default_rng(4).standard_normal((2, 10, 64), np.float32)
    got, aux, _ = blocks.apply_block(pp, pcfg, kind, torch.from_numpy(x))
    want, _, _ = jblocks.apply_block(jp, jcfg, jkind, jnp.asarray(x))
    assert aux is None  # a dense FFN has no MoE losses
    assert _rel(got, want) <= F32_TOL
    cache = blocks.init_block_cache(pcfg, kind, 2, 10, torch.float32)
    jcache = jblocks.init_block_cache(jcfg, jkind, 2, 10, jnp.float32)
    got, _, cache = blocks.apply_block(pp, pcfg, kind,
                                       torch.from_numpy(x[:, :9]), "prefill",
                                       cache)
    want, _, jcache = jblocks.apply_block(jp, jcfg, jkind,
                                          jnp.asarray(x[:, :9]), "prefill",
                                          jcache)
    assert _rel(got, want) <= F32_TOL
    got, _, _ = blocks.apply_block(pp, pcfg, kind,
                                   torch.from_numpy(x[:, 9:]), "decode", cache)
    want, _, _ = jblocks.apply_block(jp, jcfg, jkind, jnp.asarray(x[:, 9:]),
                                     "decode", jcache)
    assert _rel(got, want) <= F32_TOL


# --- the slice ------------------------------------------------------------------
def _jax_serve(jcfg, jparams, tokens, cache_dtype):
    """Prefill logits, then the logits of teacher-forced decode steps."""
    pf = jax.jit(lambda p, t: japi.prefill(p, jcfg, {"tokens": t},
                                           cache_len=S,
                                           cache_dtype=cache_dtype))
    dec = jax.jit(lambda p, t, c: japi.decode_step(p, jcfg, t, c))
    toks = jnp.asarray(tokens.numpy())
    logits, caches = pf(jparams, toks[:, :PROMPT])
    out = [logits]
    for t in range(PROMPT, S):
        logits, caches = dec(jparams, toks[:, t], caches)
        out.append(logits)
    return np.stack([np.asarray(o.astype(jnp.float32)) for o in out], 1)


def _port_serve(pcfg, params, tokens, cache_dtype):
    logits, caches = api.prefill(params, pcfg, {"tokens": tokens[:, :PROMPT]},
                                 cache_len=S, cache_dtype=cache_dtype)
    out = [logits]
    for t in range(PROMPT, S):
        logits, caches = api.decode_step(params, pcfg, tokens[:, t], caches)
        out.append(logits)
    return torch.stack(out, 1)


@pytest.mark.parametrize("jax_impl", ["kernel", "chunked"])
def test_prefill_and_decode_logits_match_reference(f32, jax_impl):
    """The whole slice in float32: prefill of 24 tokens and 16 teacher-forced
    decode steps (the window of 16 wraps), the port on its default "kernel"
    impl (the plain versions on the CPU) and on "chunked", against the
    reference on `jax_impl` (Pallas interpret mode for "kernel").  Each
    decode step calls `linear_scan` once per layer; prefill calls each
    kernel wrapper once per layer.  Measured max: 1.8e-6 (reference on
    "kernel") and 2.3e-6 (on "chunked") of max |logit|."""
    jcfg, pcfg, jparams, params, tokens = f32
    jcfg = dataclasses.replace(jcfg, attn_impl=jax_impl, scan_impl=jax_impl)
    want = _jax_serve(jcfg, jparams, tokens, jnp.float32)
    for impl in ("kernel", "chunked"):
        cfg = dataclasses.replace(pcfg, attn_impl=impl, scan_impl=impl)
        got = _port_serve(cfg, params, tokens, torch.float32)
        assert got.shape == want.shape and got.dtype == torch.float32
        assert _rel(got, want) <= F32_TOL


def test_bf16_serving_matches_reference(f32):
    """bf16 weights and activations (the serving artifact) and bf16 caches,
    both packages on the "kernel" impl: prefill and 16 decode steps.
    Measured max: 4.4e-2 of max |logit| (see the module docstring)."""
    _, _, jparams, _, tokens = f32
    jcfg, pcfg = _cfgs(dtype="bfloat16", param_dtype="bfloat16",
                       attn_impl="kernel", scan_impl="kernel")
    jparams = jax.tree.map(lambda x: x.astype(jnp.bfloat16), jparams)
    params = api.init(pcfg, device="cpu")
    lm.load_jax_params(params, _np_tree(jparams))
    assert params["head"]["w"].dtype == torch.bfloat16
    want = _jax_serve(jcfg, jparams, tokens, jnp.bfloat16)
    got = _port_serve(pcfg, params, tokens, torch.bfloat16)
    assert torch.isfinite(got).all()
    assert _rel(got, want) <= BF16_TOL


def test_model_hands_the_kernels_what_their_cuda_wrappers_take(
        f32, monkeypatch):
    """On the card the wrappers check their inputs and raise on what the
    kernels do not take (dtype, shape, strides, grad, and for bf16
    attention TMA's 16-byte bases and strides).  Here, on the CPU, run
    those checks on every call the model makes in prefill and decode
    (where T = 1 once made the scan's w a stride-0 view), in float32 and
    in bf16 as served, then the plain version."""
    _, pcfg, _, params, tokens = f32
    seen = []

    def checked(module, name):
        plain = getattr(module, name)

        def call(*args, **kw):
            if name == "flash_attention":
                module._check_inputs(*args[:3], kw.get("window"),
                                     kw.get("softcap"))
            else:
                module._check_inputs(*args[:4], *(list(args[4:]) + [None,
                                                                    None])[:2])
            seen.append(name)
            return plain(*args, **kw)

        monkeypatch.setattr(module, name, call)

    checked(fa, "flash_attention")
    checked(ls, "linear_scan")
    logits, caches = lm.prefill(params, pcfg, tokens[:, :PROMPT],
                                cache_len=PROMPT + 2)
    lm.decode_step(params, pcfg, torch.argmax(logits, -1), caches)
    assert seen.count("flash_attention") == 8
    assert seen.count("linear_scan") == 16
    # bf16 as served: every attention call goes to the tensor-core instance,
    # whose checks include the TMA layout of the model's transposed views
    tma_checked = []
    tma_strides = fa.tma_strides
    monkeypatch.setattr(fa, "tma_strides", lambda t, name="tensor": (
        tma_checked.append(name), tma_strides(t, name))[1])
    cfg16 = dataclasses.replace(pcfg, dtype="bfloat16",
                                param_dtype="bfloat16")
    params16 = api.init(cfg16, device="cpu")
    logits, caches = lm.prefill(params16, cfg16, tokens[:, :PROMPT],
                                cache_len=PROMPT + 2)
    lm.decode_step(params16, cfg16, torch.argmax(logits, -1), caches)
    assert seen.count("flash_attention") == 16
    assert tma_checked == ["q", "k", "v"] * 8


def test_decode_matches_teacher_forcing(f32):
    """Within the port, as the reference's
    `tests/test_models_smoke.py::test_decode_matches_teacher_forcing`:
    prefill 5 tokens and decode to 12 (window 6: the ring buffer wraps);
    the logits equal the train-mode forward's at every position.  Measured
    max: 1.4e-6 of max |logit|."""
    _, pcfg, _, params, tokens = f32
    cfg = dataclasses.replace(pcfg, window=6)
    s, prompt = 12, 5
    with torch.no_grad():
        hidden, _, _ = lm.forward_hidden(params, cfg,
                                      lm.embed_tokens(params, cfg,
                                                      tokens[:, :s]))
        want = lm.logits_for(params, cfg, hidden)[:, prompt - 1:]
    logits, caches = lm.prefill(params, cfg, tokens[:, :prompt],
                                cache_len=s, cache_dtype=torch.float32)
    got = [logits]
    for t in range(prompt, s):
        logits, caches = lm.decode_step(params, cfg, tokens[:, t], caches)
        got.append(logits)
    got = torch.stack(got, 1)
    assert float((got - want).abs().max() / want.abs().max()) <= F32_TOL


def test_greedy_generate_matches_reference(f32):
    """`lm.greedy_generate` (bf16 caches, as in the reference) gives the
    reference's tokens wherever the port's top-2 logit gap at that step is
    above 100 x the float32 tolerance of the logits; it calls each kernel
    wrapper once per layer in prefill and `linear_scan` once per layer per
    decode step.  Measured: all 2 x 10 tokens equal, the smallest gap
    1.1e-2 of max |logit|."""
    jcfg, pcfg, jparams, params, tokens = f32
    n_new = 10
    prompt = tokens[:, :PROMPT]
    want = np.asarray(jax.jit(lambda p, t: jlm.greedy_generate(
        p, jcfg, t, n_new))(jparams, jnp.asarray(prompt.numpy())))
    fa_before, ls_before = fa.flash_attention.launches, ls.linear_scan.launches
    got = lm.greedy_generate(params, pcfg, prompt, n_new)
    # CPU tensors take the plain versions: no kernel launch
    assert (fa.flash_attention.launches, ls.linear_scan.launches) == \
        (fa_before, ls_before)
    assert got.shape == (B, n_new) and got.dtype == torch.int64
    # the port's own logits along its tokens, for the gaps
    logits, caches = lm.prefill(params, pcfg, prompt,
                                cache_len=PROMPT + n_new)
    gaps = []
    for t in range(n_new):
        top2 = torch.topk(logits, 2, dim=-1).values
        gaps.append((top2[:, 0] - top2[:, 1]) / logits.abs().amax(-1))
        if t + 1 < n_new:
            logits, caches = lm.decode_step(params, pcfg, got[:, t], caches)
    gaps = torch.stack(gaps, 1)
    for row in range(B):
        for t in range(n_new):
            if got[row, t] != int(want[row, t]):
                assert gaps[row, t] <= 100 * F32_TOL
                break
