"""PyTorch port vs JAX reference: the enc-dec whisper-tiny (`models.encdec`).

whisper-tiny reduced (2 encoder + 2 decoder layers, d_model 64, 4 heads of
16, 24 source frames) in float32, with the reference's parameters carried
across by `encdec.load_jax_params` and the batches (tokens and the stub
frontend's frames) from the same numpy generators.  The reference runs on
its plain "chunked" attention; the port on its default "kernel" impl,
whose wrapper takes the plain `mha_chunked` on CPU tensors (through the
`FlashAttention` Function where a gradient is taken).  The `cuda`-marked
case holds the flash kernels at whisper's own shapes on the card.

Tolerances, each stated where it is used:
  encoder states, cross KV, logits: 1e-5 of max |value| (float32 across
      two frameworks).
  bf16 serving: 1e-1 of max |logit|, as the decoder-only families.
  loss: 1e-6 relative.  Gradients: 1e-4 of each leaf's max |gradient|;
      the key projections' biases have a gradient of exactly zero (a bias
      on every key adds q . b to all logits of a row, which the softmax
      drops), so both packages hold rounding noise there, and those leaves
      are held below 1e-6 of the largest gradient of the tree instead.
  three Adam steps: as hymba's (`tests/test_torch_lm_train.py`): params
      within lr absolutely, moments within 5e-4 of each leaf's max (the
      zero-gradient leaves: below 1e-6 of the tree's largest).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro import optim as joptim
from repro.data import synthetic as jsynthetic
from repro.models import api as japi
from repro.models import encdec as jencdec
from repro_torch import configs, optim
from repro_torch.data import synthetic
from repro_torch.kernels import flash_attention as fa
from repro_torch.launch import train as train_cli
from repro_torch.models import api, encdec, lm
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

ARCH = "whisper-tiny"
B, S, PROMPT = 2, 12, 5
F32_TOL = 1e-5
BF16_TOL = 1e-1
LOSS_TOL = 1e-6
GRAD_TOL = 1e-4
ZERO_TOL = 1e-6     # of the tree's largest gradient: the key biases
LR = 3e-4
MOMENT_TOL = 5e-4


def _cfgs(**kw):
    """The same reduced float32 config in both packages: the reference on
    its chunked attention and without remat (the same numbers), the port
    as it runs."""
    jcfg = dataclasses.replace(jconfigs.get_reduced(ARCH), remat=False,
                               dtype="float32", attn_impl="chunked", **kw)
    pcfg = dataclasses.replace(configs.get_reduced(ARCH), dtype="float32",
                               **kw)
    return jcfg, pcfg


def _np_tree(tree):
    return jax.tree.map(lambda x: np.asarray(x.astype(jnp.float32)), tree)


def _by_name(tree) -> dict:
    return {n: np.asarray(leaf) for n, leaf in encdec.jax_param_leaves(tree)}


def _rel(got: torch.Tensor, want) -> float:
    want = np.asarray(want, dtype=np.float32)
    return float(np.max(np.abs(got.detach().float().numpy() - want))
                 / max(np.max(np.abs(want)), 1e-30))


def _is_key_bias(name: str) -> bool:
    return name.endswith("wk.b")


def _jbatch(batch: dict) -> dict:
    return {k: jnp.asarray(v.numpy().astype(
        np.int32 if v.dtype == torch.int64 else np.float32))
        for k, v in batch.items()}


@pytest.fixture(scope="module")
def ref():
    """The reference's reduced float32 parameters, the port's with them
    carried over, and one batch (frames, tokens, labels)."""
    jcfg, pcfg = _cfgs()
    jparams = japi.init(jax.random.PRNGKey(0), jcfg)
    params = api.init(pcfg, device="cpu")
    encdec.load_jax_params(params, _np_tree(jparams))
    return jcfg, pcfg, jparams, params, synthetic.make_batch_for(pcfg, 0, B,
                                                                 S)


def _jax_serve(jcfg, jparams, batch, cache_dtype):
    """Prefill logits of the first PROMPT tokens, then those of the
    teacher-forced decode steps to S (jitted: one compile of each)."""
    jb = _jbatch(batch)
    pf = jax.jit(lambda p, f, t: japi.prefill(
        p, jcfg, {"frames": f, "tokens": t}, cache_len=S,
        cache_dtype=cache_dtype))
    dec = jax.jit(lambda p, t, c: japi.decode_step(p, jcfg, t, c))
    logits, caches = pf(jparams, jb["frames"], jb["tokens"][:, :PROMPT])
    out = [logits]
    for t in range(PROMPT, S):
        logits, caches = dec(jparams, jb["tokens"][:, t], caches)
        out.append(logits)
    return np.stack([np.asarray(o.astype(jnp.float32)) for o in out], 1)


@pytest.fixture(scope="module")
def jax_serve_f32(ref):
    """The reference's float32 serving logits (prefill + decode steps)."""
    jcfg, _, jparams, _, batch = ref
    return _jax_serve(jcfg, jparams, batch, jnp.float32)


@pytest.fixture(scope="module")
def jax_grads(ref):
    """The reference's loss, metrics and gradient of every parameter."""
    jcfg, _, jparams, _, batch = ref
    return jax.jit(jax.value_and_grad(jencdec.lm_loss, has_aux=True),
                   static_argnums=1)(jparams, jcfg, _jbatch(batch))


def _port_serve(pcfg, params, batch, cache_dtype):
    logits, caches = api.prefill(
        params, pcfg, {"frames": batch["frames"],
                       "tokens": batch["tokens"][:, :PROMPT]},
        cache_len=S, cache_dtype=cache_dtype)
    out = [logits]
    for t in range(PROMPT, S):
        logits, caches = api.serve_step(params, pcfg, batch["tokens"][:, t],
                                        caches)
        out.append(logits)
    return torch.stack(out, 1)


# --- configuration, data, weights ---------------------------------------------
def test_config_registered_as_in_the_reference():
    """whisper-tiny and its reduced form equal the reference's field by
    field but the two impl defaults; the registry is the reference's."""
    assert configs.ARCH_NAMES == jconfigs.ARCH_NAMES
    for get in ("get", "get_reduced"):
        ours = dataclasses.asdict(getattr(configs, get)(ARCH))
        theirs = dataclasses.asdict(getattr(jconfigs, get)(ARCH))
        assert ours.pop("attn_impl") == ours.pop("scan_impl") == "kernel"
        theirs.pop("attn_impl"), theirs.pop("scan_impl")
        assert ours == theirs
    assert configs.get(ARCH).is_encdec
    assert configs.all_configs()[ARCH] == configs.get(ARCH)


def test_frames_and_stream_are_bitwise_the_reference():
    """`make_batch_for` gives whisper's frames from a generator of their
    own, bitwise the reference's, beside the same tokens and labels; so
    does every batch of a `TokenStream`."""
    jcfg, pcfg = _cfgs()
    ours = synthetic.make_batch_for(pcfg, 3, B, 20)
    theirs = jsynthetic.make_batch_for(jcfg, 3, B, 20)
    assert set(ours) == set(theirs) == {"tokens", "labels", "frames"}
    assert ours["frames"].dtype == torch.float32
    assert ours["frames"].shape == (B, pcfg.max_source_positions,
                                    pcfg.d_model)
    stream = synthetic.TokenStream(pcfg, B, 20, seed=2)
    jstream = jsynthetic.TokenStream(jcfg, B, 20, seed=2)
    for a, b in [(ours, theirs)] + [(stream.next(), jstream.next())
                                    for _ in range(2)]:
        for key in a:
            np.testing.assert_array_equal(a[key].numpy(), np.asarray(b[key]))


def test_load_jax_params_raises_on_an_unmatched_leaf(ref):
    """Every leaf of both trees must be matched: a reference tree with a
    leaf missing, one with a leaf the port lacks, or one of another shape
    is refused."""
    jcfg, pcfg, jparams, _, _ = ref
    params = api.init(pcfg, device="cpu")
    tree = _np_tree(jparams)
    missing = jax.tree.map(lambda x: x, tree)
    del missing["decoder"]["xattn"]["wk"]["b"]
    with pytest.raises(KeyError, match="not in the reference tree"):
        encdec.load_jax_params(params, missing)
    extra = jax.tree.map(lambda x: x, tree)
    extra["decoder"]["xattn"]["wk"]["extra"] = extra["decoder"]["xattn"][
        "wk"]["b"]
    with pytest.raises(KeyError, match="no counterpart"):
        encdec.load_jax_params(params, extra)
    bad = jax.tree.map(lambda x: x, tree)
    bad["enc_pos"]["table"] = bad["enc_pos"]["table"][:-1]
    with pytest.raises(ValueError, match="enc_pos.table"):
        encdec.load_jax_params(params, bad)


# --- the forward path ------------------------------------------------------------
def test_encode_and_cross_kv_match_reference(ref):
    """The encoder's states (learned positions, bidirectional attention,
    GELU MLP, final LayerNorm) and each decoder layer's cross KV."""
    jcfg, pcfg, jparams, params, batch = ref
    frames = batch["frames"]
    want = jencdec.encode(jparams, jcfg, jnp.asarray(frames.numpy()))
    with torch.no_grad():
        got = encdec.encode(params, pcfg, frames)
        assert got.shape == want.shape and got.dtype == torch.float32
        assert _rel(got, want) <= F32_TOL
        cross = encdec.cross_kv(params, pcfg, got)
    jcross = jax.vmap(lambda p_l: jencdec._cross_kv(p_l["xattn"], jcfg,
                                                    want))(
        jparams["decoder"])
    assert len(cross) == pcfg.n_layers
    for i, kv in enumerate(cross):
        for key in ("k", "v"):
            assert kv[key].shape == (B, pcfg.kv_heads,
                                     pcfg.max_source_positions, pcfg.hd)
            assert _rel(kv[key], jcross[key][i]) <= F32_TOL


@pytest.mark.parametrize("impl", ["kernel", "chunked"])
def test_prefill_and_decode_logits_match_reference(ref, jax_serve_f32,
                                                   impl):
    """The whole serving path in float32: the frames encoded, a prompt of 5
    tokens prefilled and 7 teacher-forced decode steps, through
    `api.prefill` / `api.serve_step`, the port on `impl`.  Measured max:
    4.7e-7 of max |logit| (both impls)."""
    _, pcfg, _, params, batch = ref
    want = jax_serve_f32
    got = _port_serve(dataclasses.replace(pcfg, attn_impl=impl), params,
                      batch, torch.float32)
    assert got.shape == want.shape and got.dtype == torch.float32
    assert _rel(got, want) <= F32_TOL


def test_bf16_serving_matches_reference(ref):
    """bf16 weights, activations and caches in both packages: prefill and
    7 decode steps.  Measured: the port 1.0e-2 of max |logit| from the
    reference's bf16; the reference's own bf16 run is 9.0e-3 from its
    float32, so the two bf16 runs differ by what bf16 itself costs."""
    jcfg, pcfg, jparams, _, batch = ref
    jcfg16 = dataclasses.replace(jcfg, dtype="bfloat16",
                                 param_dtype="bfloat16")
    pcfg16 = dataclasses.replace(pcfg, dtype="bfloat16",
                                 param_dtype="bfloat16")
    jparams16 = jax.tree.map(lambda x: x.astype(jnp.bfloat16), jparams)
    params16 = api.init(pcfg16, device="cpu")
    encdec.load_jax_params(params16, _np_tree(jparams16))
    assert params16["embed"]["table"].dtype == torch.bfloat16
    want = _jax_serve(jcfg16, jparams16, batch, jnp.bfloat16)
    got = _port_serve(pcfg16, params16, batch, torch.bfloat16)
    assert torch.isfinite(got).all()
    assert _rel(got, want) <= BF16_TOL


def test_decode_matches_teacher_forcing(ref):
    """Within the port, as the reference's
    `tests/test_models_smoke.py::test_decode_matches_teacher_forcing`
    [whisper-tiny]: prefill 5 tokens and decode to 12; the logits equal the
    train-mode decoder's at every position.  Measured max: 3.5e-7 of max
    |logit|."""
    _, pcfg, _, params, batch = ref
    tokens = batch["tokens"]
    with torch.no_grad():
        enc = encdec.encode(params, pcfg, batch["frames"])
        hidden, _ = encdec.decode_hidden(
            params, pcfg, tokens, 0,
            {"cross": encdec.cross_kv(params, pcfg, enc)}, "train")
        want = lm.logits_for(params, pcfg, hidden)[:, PROMPT - 1:]
    got = _port_serve(pcfg, params, batch, torch.float32)
    assert float((got - want).abs().max() / want.abs().max()) <= F32_TOL


def test_greedy_generate_and_api_dispatch(ref):
    """`lm.greedy_generate(..., frames=)` runs whisper through
    `encdec.greedy_generate`: each token the argmax of the teacher-forced
    logits of the tokens before it.  `api.init_caches` refuses an enc-dec
    config (its caches come from prefill), and `lm`'s decoder-only entry
    points refuse whisper."""
    _, pcfg, _, params, batch = ref
    prompt = batch["tokens"][:, :PROMPT]
    toks = lm.greedy_generate(params, pcfg, prompt, 4,
                              frames=batch["frames"])
    assert toks.shape == (B, 4) and toks.dtype == torch.int64
    forced = {"frames": batch["frames"],
              "tokens": torch.cat([prompt, toks[:, :3]], 1)}
    logits, caches = api.prefill(params, pcfg, forced)
    enc = encdec.encode(params, pcfg, batch["frames"])
    with torch.no_grad():
        hidden, _ = encdec.decode_hidden(
            params, pcfg, forced["tokens"], 0,
            {"cross": encdec.cross_kv(params, pcfg, enc)}, "train")
        want = torch.argmax(lm.logits_for(params, pcfg, hidden), -1)
    assert torch.equal(toks, want[:, PROMPT - 1:])
    assert torch.equal(torch.argmax(logits, -1), toks[:, 3])
    with pytest.raises(ValueError, match="prefill"):
        api.init_caches(pcfg, B, S, device="cpu")
    with pytest.raises(ValueError, match="enc-dec"):
        lm.init(torch.Generator().manual_seed(0), pcfg)


def test_model_hands_the_kernels_what_their_cuda_wrappers_take(
        ref, monkeypatch):
    """On the card the flash wrapper checks its inputs and raises on what
    the kernels do not take; for bf16, TMA's 16-byte bases and strides.
    Here run those checks on every call whisper makes in prefill (each
    encoder layer, each decoder layer's self- and cross-attention) and in
    a decode step (the cross-attention: Sq = 1 against the cross KV's
    transposed views), in float32 and in bf16 as served."""
    _, pcfg, _, params, batch = ref
    seen = []
    plain = fa.flash_attention

    def call(q, k, v, **kw):
        fa._check_inputs(q, k, v, kw.get("window"), kw.get("softcap"))
        seen.append((q.shape[2], k.shape[2], kw["causal"]))
        return plain(q, k, v, **kw)

    monkeypatch.setattr(fa, "flash_attention", call)
    tma_checked = []
    tma_strides = fa.tma_strides
    monkeypatch.setattr(fa, "tma_strides", lambda t, name="tensor": (
        tma_checked.append(name), tma_strides(t, name))[1])
    src = pcfg.max_source_positions
    per_prefill = ([(src, src, False)] * pcfg.encoder_layers
                   + [(PROMPT, PROMPT, True), (PROMPT, src, False)]
                   * pcfg.n_layers)
    per_decode = [(1, src, False)] * pcfg.n_layers
    cfg16 = dataclasses.replace(pcfg, dtype="bfloat16",
                                param_dtype="bfloat16")
    for cfg, p in ((pcfg, params), (cfg16, api.init(cfg16, device="cpu"))):
        seen.clear()
        logits, caches = api.prefill(
            p, cfg, {"frames": batch["frames"],
                     "tokens": batch["tokens"][:, :PROMPT]},
            cache_len=PROMPT + 2)
        api.decode_step(p, cfg, torch.argmax(logits, -1), caches)
        assert seen == per_prefill + per_decode
    # only the bf16 run reaches the tensor-core instance's TMA checks
    assert tma_checked == ["q", "k", "v"] * len(per_prefill + per_decode)


def test_remat_is_bitwise_no_remat_and_runs_each_attention_twice(
        ref, monkeypatch):
    """Remat recomputes each encoder and decoder layer in the backward
    pass: the loss and every gradient are bitwise those without it, and
    the flash forward runs twice per attention (forward + recompute), once
    without.  On the card these are a training step's launches: per layer
    one of the encoder, two of the decoder (causal self-, non-causal
    cross-attention)."""
    _, pcfg, jparams, _, batch = ref
    params = api.init(pcfg, device="cpu")
    encdec.load_jax_params(params, _np_tree(jparams))
    params.requires_grad_(True)
    calls = []
    plain = fa._forward

    def counted(*args, **kw):
        calls.append(kw["causal"])
        return plain(*args, **kw)

    monkeypatch.setattr(fa, "_forward", counted)
    out = {}
    for remat in (True, False):
        cfg = dataclasses.replace(pcfg, remat=remat)
        calls.clear()
        loss, _ = encdec.lm_loss(params, cfg, batch)
        out[remat] = (loss, torch.autograd.grad(loss,
                                                list(params.parameters())))
        per = 2 if remat else 1
        assert calls.count(False) == per * (pcfg.encoder_layers
                                            + pcfg.n_layers)
        assert calls.count(True) == per * pcfg.n_layers
    assert torch.equal(out[True][0], out[False][0])
    for a, b in zip(out[True][1], out[False][1]):
        assert torch.equal(a, b)


# --- training ---------------------------------------------------------------------
@pytest.mark.parametrize("impl", ["kernel", "chunked"])
def test_lm_loss_and_gradients_match_reference(ref, jax_grads, impl):
    """`api.loss` and the gradient of every parameter against
    `jax.value_and_grad(repro.models.encdec.lm_loss)`, the port on `impl`
    with remat, as it trains.  Measured: loss equal to the last bit;
    gradients 2.0e-6 of each leaf's max at most; the key biases' gradients
    7.6e-9 of the largest at most, in either package."""
    _, pcfg, jparams, _, batch = ref
    (jloss, jmetrics), jgrads = jax_grads
    params = api.init(pcfg, device="cpu")
    encdec.load_jax_params(params, _np_tree(jparams))
    params.requires_grad_(True)
    cfg = dataclasses.replace(pcfg, attn_impl=impl)
    loss, metrics = api.loss(params, cfg, batch)
    named = dict(params.named_parameters())
    grads = dict(zip(named, torch.autograd.grad(loss, list(named.values()))))
    assert abs(float(loss.detach()) - float(jloss)) \
        <= LOSS_TOL * abs(float(jloss))
    assert float(metrics["tokens"]) == float(jmetrics["tokens"]) == B * S
    want = _by_name(jgrads)
    assert want.keys() == grads.keys()
    top = max(float(np.abs(w).max()) for w in want.values())
    for name, w in want.items():
        if _is_key_bias(name):
            assert float(grads[name].abs().max()) <= ZERO_TOL * top, name
            assert float(np.abs(w).max()) <= ZERO_TOL * top, name
        else:
            assert _rel(grads[name], w) <= GRAD_TOL, name


def test_three_train_steps_match_reference(ref):
    """Three `api.train_step`s (Adam, lr 3e-4, global-norm clip 1.0) on
    three batches of the stream against the reference's jitted
    `encdec.train_step`: loss and gradient norm each step, then params,
    both moments and the step count."""
    jcfg, pcfg, jparams, _, _ = ref
    params = api.init(pcfg, device="cpu")
    encdec.load_jax_params(params, _np_tree(jparams))
    opt = optim.adam_init(list(params.parameters()))
    jopt = joptim.adam_init(jparams)
    step = jax.jit(jencdec.train_step, static_argnums=(3,))
    jstream = jsynthetic.TokenStream(jcfg, B, S, seed=4)
    stream = synthetic.TokenStream(pcfg, B, S, seed=4)
    for _ in range(3):
        jparams, jopt, jm = step(jparams, jopt, jstream.next(), jcfg)
        params, opt, m = api.train_step(params, opt, stream.next(), pcfg)
        for key in ("loss", "grad_norm"):
            assert abs(float(m[key]) - float(jm[key])) \
                <= 1e-5 * abs(float(jm[key])), key
    assert int(opt.step) == int(jopt.step) == 3
    ours = dict(params.named_parameters())
    for name, want in _by_name(jparams).items():
        assert float(np.abs(ours[name].detach().numpy() - want).max()) \
            <= LR, name
    names = list(ours)
    for theirs, mine in ((jopt.m, opt.m), (jopt.v, opt.v)):
        mine = dict(zip(names, mine))
        want = _by_name(theirs)
        top = max(float(np.abs(w).max()) for w in want.values())
        for name, w in want.items():
            assert mine[name].dtype == torch.float32
            if _is_key_bias(name):
                assert float(mine[name].abs().max()) <= ZERO_TOL * top, name
            else:
                assert _rel(mine[name], w) <= MOMENT_TOL, name


def test_train_cli_trains_whisper_on_the_cpu(tmp_path):
    """`python -m repro_torch.launch.train --arch whisper-tiny --reduced
    --device cpu`: the stream's frames reach the loss; 2 steps, then a
    resumed third equal to an uninterrupted run's, bit for bit."""
    common = ["--arch", ARCH, "--reduced", "--device", "cpu", "--batch", "2",
              "--seq", "16"]
    straight = train_cli.main(common + [
        "--steps", "3", "--checkpoint-dir", str(tmp_path / "a")])
    train_cli.main(common + ["--steps", "2", "--checkpoint-dir",
                             str(tmp_path / "b")])
    resumed = train_cli.main(common + [
        "--steps", "3", "--resume", "--checkpoint-dir", str(tmp_path / "b")])
    assert [r["step"] for r in resumed] == [2]
    for key in ("loss", "grad_norm"):
        assert resumed[0][key] == straight[2][key]
    assert all(np.isfinite(r["loss"]) for r in straight)


# --- the flash kernels at whisper's shapes (on the card only) -------------------
FLASH_CARD_TOL = {"float32": 1e-4, "bfloat16": 1.5e-2}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("sq", [1, 1500])
def test_cuda_flash_attention_at_whisper_shapes(sq, dtype):
    """Each flash instance, non-causal, at (1, 6, Sq, 1500, 64): the
    decode step's cross-attention (Sq = 1) and the encoder (Sq = 1500, no
    multiple of either tile), against `mha_chunked`, within chip_smoke.py's
    gates (float32 1e-4, bfloat16 1.5e-2 of max |plain|)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    rng = np.random.default_rng(sq)
    tdt = getattr(torch, dtype)
    q, k, v = (torch.from_numpy(rng.standard_normal(s, np.float32)).to(
        "cuda", tdt) for s in ((1, 6, sq, 64), (1, 6, 1500, 64),
                               (1, 6, 1500, 64)))
    before = fa.flash_attention.launches
    got = fa.flash_attention(q, k, v, causal=False)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == before + 1
    want = fa.mha_chunked(q, k, v, causal=False)
    assert got.shape == want.shape and got.dtype == want.dtype
    assert _rel(got.cpu(), want.cpu().float().numpy()) <= \
        FLASH_CARD_TOL[dtype]
