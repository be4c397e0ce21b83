"""PyTorch port vs JAX reference: the LM training path (hymba-1.5b).

hymba reduced (8 layers in one group of 8, d_model 64, window 16) in
float32, with the reference's parameters carried across by
`lm.load_jax_params` and token batches from the same numpy generator.  The
JAX side runs jitted, its kernels in Pallas interpret mode where
`attn_impl/scan_impl="kernel"`.  The port's two kernel wrappers run through
their autograd Functions on CPU tensors too (the forward is the plain
version there), so these tests hold their backward, the vjp of the plain
chunked forms.

Tolerances, each stated where it is used:
  loss: 1e-6 relative; the same float32 graph in another summation order.
  gradients: 1e-4 of each leaf's max |gradient|; measured 1.2e-5 (the SSM
      branch's dt bias, whose gradient sums many small terms).
  three Adam steps: params within lr (3e-4) absolutely, measured 6.0e-5;
      Adam normalises each entry's step, so an entry whose gradient is
      near zero steps by up to lr in one package and less in the other.
      Moments within 5e-4 of each leaf's max, measured 8.1e-5.
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
from repro.kernels import ops as jops
from repro.models import api as japi
from repro.models import lm as jlm
from repro_torch import configs, optim
from repro_torch.data import synthetic
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import linear_scan as ls
from repro_torch.kernels import ops
from repro_torch.launch import train as train_cli
from repro_torch.models import api, lm
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

ARCH = "hymba-1.5b"
B, S = 2, 40                    # longer than the window of 16
LOSS_TOL = 1e-6
GRAD_TOL = 1e-4
LR = 3e-4
MOMENT_TOL = 5e-4


def _cfgs(**kw):
    """The same reduced float32 config in both packages (the JAX side
    without remat: the same numbers, a faster compile)."""
    jcfg = dataclasses.replace(jconfigs.get_reduced(ARCH), remat=False,
                               dtype="float32", **kw)
    pcfg = dataclasses.replace(configs.get_reduced(ARCH), dtype="float32",
                               **kw)
    return jcfg, pcfg


def _np_tree(tree):
    return jax.tree.map(lambda x: np.asarray(x.astype(jnp.float32)), tree)


def _port_view(tree, prefix=""):
    """(port parameter name, numpy leaf) for a tree shaped like the
    reference's params (each block leaf stacked over the groups)."""
    for key, val in tree.items():
        if isinstance(val, dict):
            yield from _port_view(val, f"{prefix}{key}.")
        elif prefix.startswith("layers."):
            for m in range(val.shape[0]):
                yield f"layers.{m}.{prefix[7:]}{key}", np.asarray(val[m])
        else:
            yield prefix + key, np.asarray(val)


def _jbatch(batch: dict) -> dict:
    return {k: jnp.asarray(v.numpy().astype(np.int32))
            for k, v in batch.items()}


@pytest.fixture(scope="module")
def ref():
    """The reference's parameters and one token batch."""
    jcfg, _ = _cfgs()
    return japi.init(jax.random.PRNGKey(0), jcfg), \
        synthetic.lm_batch(0, B, S, jcfg.vocab)


def _port_params(jparams, pcfg):
    params = api.init(pcfg, device="cpu")
    lm.load_jax_params(params, _np_tree(jparams))
    return params


def _rel(got: torch.Tensor, want: np.ndarray) -> float:
    return float(np.abs(got.detach().numpy() - want).max()
                 / max(np.abs(want).max(), 1e-30))


# --- loss and gradients ---------------------------------------------------------
@pytest.mark.parametrize("impl", ["kernel", "chunked"])
def test_lm_loss_and_gradients_match_reference(ref, impl):
    """`lm_loss` and the gradient of every parameter against
    `jax.value_and_grad(repro.models.lm.lm_loss)`, both packages on
    `impl` (the port with remat, as it trains)."""
    jparams, batch = ref
    jcfg, pcfg = _cfgs(attn_impl=impl, scan_impl=impl)
    (jloss, jmetrics), jgrads = jax.jit(
        jax.value_and_grad(jlm.lm_loss, has_aux=True),
        static_argnums=1)(jparams, jcfg, _jbatch(batch))
    params = _port_params(jparams, pcfg).requires_grad_(True)
    loss, metrics = lm.lm_loss(params, pcfg, batch)
    named = dict(params.named_parameters())
    grads = dict(zip(named, torch.autograd.grad(loss, list(named.values()))))
    assert abs(float(loss.detach()) - float(jloss)) \
        <= LOSS_TOL * abs(float(jloss))
    assert float(metrics["tokens"]) == float(jmetrics["tokens"]) == B * S
    assert float(metrics["moe_lb"]) == float(metrics["router_z"]) == 0.0
    leaves = list(_port_view(jgrads))
    assert len(leaves) == len(grads)
    for name, want in leaves:
        assert _rel(grads[name], want) <= GRAD_TOL, name


def test_three_train_steps_match_reference(ref):
    """Three `train_step`s (Adam, lr 3e-4, global-norm clip 1.0) on three
    batches of the stream, against the reference's jitted `train_step`:
    loss and gradient norm each step, then params, both moments and the
    step count."""
    jparams, _ = ref
    jcfg, pcfg = _cfgs(attn_impl="chunked", scan_impl="chunked")
    params = _port_params(jparams, pcfg)
    opt = optim.adam_init(list(params.parameters()))
    jopt = joptim.adam_init(jparams)
    step = jax.jit(jlm.train_step, static_argnums=(3,))
    jstream = jsynthetic.TokenStream(jcfg, B, S, seed=4)
    stream = synthetic.TokenStream(pcfg, B, S, seed=4)
    for _ in range(3):
        jparams, jopt, jm = step(jparams, jopt, jstream.next(), jcfg)
        params, opt, m = lm.train_step(params, opt, stream.next(), pcfg)
        for key in ("loss", "grad_norm"):
            assert abs(float(m[key]) - float(jm[key])) \
                <= 1e-5 * abs(float(jm[key])), key
    assert int(opt.step) == int(jopt.step) == 3
    names = [n for n, _ in params.named_parameters()]
    ours = dict(params.named_parameters())
    for name, want in _port_view(jparams):
        assert float(np.abs(ours[name].detach().numpy() - want).max()) \
            <= LR, name
    for theirs, mine in ((jopt.m, opt.m), (jopt.v, opt.v)):
        mine = dict(zip(names, mine))
        for name, want in _port_view(theirs):
            assert mine[name].dtype == torch.float32
            assert _rel(mine[name], want) <= MOMENT_TOL, name


def test_remat_is_bitwise_no_remat_and_runs_each_kernel_twice(
        ref, monkeypatch):
    """Remat recomputes each group's forward in the backward pass: the loss
    and every gradient are bitwise those without it, and each kernel's
    forward runs twice per layer (forward + recompute), once without.  On
    the card these are the launch counts of a training step."""
    jparams, batch = ref
    _, pcfg = _cfgs()
    params = _port_params(jparams, pcfg).requires_grad_(True)
    calls = {"fa": 0, "ls": 0}

    def counted(module, key):
        plain = module._forward

        def call(*args, **kw):
            calls[key] += 1
            return plain(*args, **kw)

        monkeypatch.setattr(module, "_forward", call)

    counted(fa, "fa")
    counted(ls, "ls")
    out = {}
    for remat in (True, False):
        cfg = dataclasses.replace(pcfg, remat=remat)
        calls.update(fa=0, ls=0)
        loss, _ = lm.lm_loss(params, cfg, batch)
        out[remat] = (loss, torch.autograd.grad(loss,
                                                list(params.parameters())))
        per_layer = 2 if remat else 1
        assert calls == {"fa": per_layer * pcfg.n_layers,
                         "ls": per_layer * pcfg.n_layers}
    assert torch.equal(out[True][0], out[False][0])
    for a, b in zip(out[True][1], out[False][1]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("rows", [2, 1])
def test_training_hands_the_kernels_what_their_cuda_wrappers_take(
        ref, monkeypatch, rows):
    """On the card the wrappers check their inputs (dtype, shape, strides,
    TMA's layout for bf16 attention).  Here run those checks on every
    kernel call of a bf16 training step, as the card trains (bf16 compute,
    float32 masters), forward and remat recompute, then the plain version;
    at batch 2 and at batch 1, where the SSM's head reshapes were strided
    views that the scan kernel refused (and a batch-1 prefill)."""
    _, batch = ref
    batch = {k: v[:rows] for k, v in batch.items()}
    _, pcfg = _cfgs()
    cfg = dataclasses.replace(pcfg, dtype="bfloat16")
    seen = []

    def checked(module, check):
        plain = module._forward

        def call(*args, **kw):
            check(*args, **kw)
            seen.append(module.__name__)
            return plain(*args, **kw)

        monkeypatch.setattr(module, "_forward", call)

    checked(fa, lambda q, k, v, **kw: fa._check_inputs(
        q, k, v, kw["window"], kw["softcap"]))
    checked(ls, lambda *a, **kw: ls._check_inputs(*a))
    params = api.init(cfg, device="cpu")
    opt = optim.adam_init(list(params.parameters()))
    _, _, metrics = lm.train_step(params, opt, batch, cfg)
    assert np.isfinite(float(metrics["loss"]))
    assert seen.count(fa.__name__) == seen.count(ls.__name__) \
        == 2 * cfg.n_layers
    lm.prefill(params, cfg, batch["tokens"], cache_len=S + 1)
    assert seen.count(ls.__name__) == 3 * cfg.n_layers


# --- the kernel wrappers' backward against the reference's custom vjps ---------
@pytest.mark.parametrize("case", [
    ((2, 4, 2, 40, 40, 16), dict(window=16)),
    ((2, 4, 2, 40, 40, 16), {}),
    ((1, 6, 3, 9, 30, 8), dict(softcap=5.0)),
])
def test_flash_attention_gradient_matches_reference(case):
    """`fa.flash_attention` (its Function: plain forward on the CPU, the
    vjp of `mha_chunked` backward) against `jax.vjp` of
    `ops.attention(impl="kernel")` (Pallas interpret forward, the
    reference's recompute-from-`mha_chunked` backward): 1e-5 of max."""
    (b, hq, hkv, sq, skv, d), kw = case
    rng = np.random.default_rng(3)
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((b, hq, sq, d), (b, hkv, skv, d), (b, hkv, skv, d)))
    g = rng.standard_normal((b, hq, sq, d)).astype(np.float32)
    out, vjp = jax.vjp(lambda *a: jops.attention(*a, impl="kernel", **kw),
                       *map(jnp.asarray, (q, k, v)))
    want = vjp(jnp.asarray(g))
    tq, tk, tv = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    got_out = fa.flash_attention(tq, tk, tv, **kw)
    assert _rel(got_out, np.asarray(out)) <= 1e-5
    got = torch.autograd.grad(got_out, (tq, tk, tv), torch.tensor(g))
    for a, w in zip(got, want):
        assert _rel(a, np.asarray(w)) <= 1e-5


@pytest.mark.parametrize("dbr,with_u", [(True, False), (False, True),
                                        (False, False)])
def test_linear_scan_gradient_matches_reference(dbr, with_u):
    """`ls.linear_scan` (its Function) against `jax.vjp` of
    `ops.gated_linear_scan(impl="kernel")`, cotangents on o and S_final,
    with s0: 1e-5 of max.  With `u=None` the reference's kernel path reads
    u = 0 (ROADMAP queue C), the port no scaling, so that case compares
    with the reference's "chunked" impl, which reads it as the port does."""
    b, t, dk, dv = 3, 40, 4, 8
    rng = np.random.default_rng(5)
    q, k = (rng.standard_normal((b, t, dk)).astype(np.float32)
            for _ in range(2))
    v = rng.standard_normal((b, t, dv)).astype(np.float32)
    w = (0.5 + 0.5 * rng.random((b, t, dk))).astype(np.float32)
    u = rng.standard_normal((dk,)).astype(np.float32)
    s0 = rng.standard_normal((b, dk, dv)).astype(np.float32)
    go = rng.standard_normal((b, t, dv)).astype(np.float32)
    gs = rng.standard_normal((b, dk, dv)).astype(np.float32)
    impl = "kernel" if with_u or dbr else "chunked"
    args = [q, k, v, w, u, s0] if with_u else [q, k, v, w, s0]

    def jfn(*a):
        if not with_u:
            a = (*a[:4], None, a[4])
        return jops.gated_linear_scan(*a, decay_before_read=dbr, impl=impl)

    (o, s), vjp = jax.vjp(jfn, *map(jnp.asarray, args))
    want = vjp((jnp.asarray(go), jnp.asarray(gs)))
    targs = [torch.tensor(x, requires_grad=True) for x in args]
    tu = targs[4] if with_u else None
    got_o, got_s = ls.linear_scan(*targs[:4], tu, targs[-1],
                                  decay_before_read=dbr, chunk=8)
    assert _rel(got_o, np.asarray(o)) <= 1e-5
    assert _rel(got_s, np.asarray(s)) <= 1e-5
    got = torch.autograd.grad((got_o, got_s), targs,
                              (torch.tensor(go), torch.tensor(gs)))
    for a, w_ in zip(got, want):
        assert _rel(a, np.asarray(w_)) <= 1e-5


def test_ops_dispatch_differentiates_every_impl():
    """`ops.attention` / `ops.gated_linear_scan` on "kernel" (the
    Functions) and on the plain forms give the same gradients on the CPU
    (2e-6 of max: the same math, other block sizes)."""
    gen = torch.Generator().manual_seed(1)
    q = torch.randn((1, 2, 20, 8), generator=gen, requires_grad=True)
    kv = torch.randn((1, 1, 20, 8), generator=gen, requires_grad=True)
    grads = [torch.autograd.grad(ops.attention(q, kv, kv, window=8, impl=i,
                                               block_k=7).sum(), (q, kv))
             for i in ("kernel", "chunked", "naive")]
    for other in grads[1:]:
        for a, b in zip(grads[0], other):
            assert float((a - b).abs().max()) <= 2e-6 * float(b.abs().max())
    x = torch.randn((2, 20, 4), generator=gen, requires_grad=True)
    w = torch.rand((2, 20, 4), generator=gen)
    vv = torch.randn((2, 20, 6), generator=gen)
    grads = [torch.autograd.grad(ops.gated_linear_scan(
        x, x, vv, w, decay_before_read=True, impl=i, chunk=8)[0].sum(), x)[0]
        for i in ("kernel", "chunked", "scan")]
    for other in grads[1:]:
        assert float((grads[0] - other).abs().max()) \
            <= 2e-6 * float(other.abs().max())


# --- loss pieces, data, optimizer ------------------------------------------------
def test_chunked_ce_matches_a_full_softmax():
    """`chunked_ce` over chunks of 16 (the last one ragged, 40 = 2 x 16 +
    8) with a mask, against cross-entropy over the whole (B, S, V) logits:
    1e-6 relative, with and without remat."""
    _, pcfg = _cfgs()
    params = api.init(pcfg, seed=2, device="cpu")
    gen = torch.Generator().manual_seed(0)
    hidden = torch.randn((B, S, pcfg.d_model), generator=gen)
    labels = torch.randint(0, pcfg.vocab, (B, S), generator=gen)
    mask = (torch.rand((B, S), generator=gen) > 0.2).float()
    logits = lm.logits_for(params, pcfg, hidden)
    nll = torch.nn.functional.cross_entropy(
        logits.reshape(-1, pcfg.vocab), labels.reshape(-1), reduction="none")
    want = float((nll * mask.reshape(-1)).sum())
    for remat in (True, False):
        cfg = dataclasses.replace(pcfg, loss_chunk=16, remat=remat)
        got, count = lm.chunked_ce(params, cfg, hidden, labels, mask)
        assert abs(float(got) - want) <= 1e-6 * abs(want)
        assert float(count) == float(mask.sum())


def test_token_stream_matches_reference():
    """`TokenStream` batches, cursor and state round trip equal the
    reference's; `make_batch_for` gives the reference's enc-dec batch
    (whisper's frames beside the tokens) and vision batch (tokens, labels
    and llava's patches)."""
    jcfg, pcfg = _cfgs()
    ours = synthetic.TokenStream(pcfg, 3, 17, seed=7)
    theirs = jsynthetic.TokenStream(jcfg, 3, 17, seed=7)
    for _ in range(3):
        a, b = ours.next(), theirs.next()
        for key in ("tokens", "labels"):
            assert a[key].dtype == torch.int64
            np.testing.assert_array_equal(a[key].numpy(), np.asarray(b[key]))
    assert ours.state_dict() == theirs.state_dict() == {"seed": 7,
                                                        "cursor": 3}
    other = synthetic.TokenStream(pcfg, 3, 17)
    other.load_state_dict(ours.state_dict())
    np.testing.assert_array_equal(other.next()["tokens"].numpy(),
                                  np.asarray(theirs.next()["tokens"]))
    encdec = {"encoder_layers": 2, "max_source_positions": 6}
    ours = synthetic.make_batch_for(dataclasses.replace(pcfg, **encdec), 0,
                                    1, 8)
    theirs = jsynthetic.make_batch_for(dataclasses.replace(jcfg, **encdec),
                                       0, 1, 8)
    assert set(ours) == set(theirs) == {"tokens", "labels", "frames"}
    assert ours["frames"].shape == (1, 6, pcfg.d_model)
    for key in ours:
        np.testing.assert_array_equal(ours[key].numpy(),
                                      np.asarray(theirs[key]))
    vision = {"vision_dim": 8, "vision_tokens": 5}
    ours = synthetic.make_batch_for(dataclasses.replace(pcfg, **vision), 4,
                                    2, 20)
    theirs = jsynthetic.make_batch_for(dataclasses.replace(jcfg, **vision),
                                       4, 2, 20)
    assert set(ours) == set(theirs) == {"tokens", "labels", "patches"}
    assert ours["patches"].shape == (2, 5, 8) and ours["tokens"].shape == (
        2, 15)
    for key in ours:
        np.testing.assert_array_equal(ours[key].numpy(),
                                      np.asarray(theirs[key]))


@pytest.mark.parametrize("weight_decay,grad_clip", [(0.0, None), (0.1, 1.0),
                                                    (0.01, 0.05)])
def test_adam_update_matches_reference(weight_decay, grad_clip):
    """Three `adam_update`s on float32 leaves (the clip active at 0.05)
    against `repro.optim.adam_update`: 1e-7 absolute on params and
    moments (measured: 1.5e-8); a norm handed in (as `train_step` does)
    gives bitwise what the clip computes itself; bf16 params keep float32
    moments."""
    rng = np.random.default_rng(0)
    shapes = [(5, 3), (7,), (2, 2, 2)]
    start = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    tp = [torch.tensor(p) for p in start]
    state = optim.adam_init(tp)
    tp_n = [torch.tensor(p) for p in start]
    state_n = optim.adam_init(tp_n)
    jp = [jnp.asarray(p) for p in start]
    jstate = joptim.adam_init(jp)
    kw = dict(lr=1e-2, weight_decay=weight_decay, grad_clip=grad_clip)
    for _ in range(3):
        gs = [rng.standard_normal(s).astype(np.float32) for s in shapes]
        optim.adam_update(optim.AdamConfig(**kw), tp,
                          [torch.tensor(g) for g in gs], state)
        tg = [torch.tensor(g) for g in gs]
        optim.adam_update(optim.AdamConfig(**kw), tp_n, tg, state_n,
                          norm=optim.global_norm(tg))
        jp, jstate = joptim.adam_update(joptim.AdamConfig(**kw), jp,
                                        [jnp.asarray(g) for g in gs], jstate)
    assert int(state.step) == int(jstate.step) == 3
    for mine, theirs in ((tp, jp), (state.m, jstate.m), (state.v, jstate.v)):
        for a, b in zip(mine, theirs):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                       atol=1e-7)
    for a, b in zip(tp + state.m + state.v, tp_n + state_n.m + state_n.v):
        assert torch.equal(a, b)
    bf = [torch.tensor(p).bfloat16() for p in start]
    bstate = optim.adam_init(bf)
    optim.adam_update(optim.AdamConfig(**kw), bf,
                      [torch.ones(s) for s in shapes], bstate)
    assert {p.dtype for p in bf} == {torch.bfloat16}
    assert {m.dtype for m in bstate.m + bstate.v} == {torch.float32}


def test_schedules_match_reference():
    for ours, theirs in (
            (optim.constant_schedule(2e-3), joptim.constant_schedule(2e-3)),
            (optim.cosine_schedule(1e-3, 10), joptim.cosine_schedule(1e-3, 10)),
            (optim.linear_warmup_cosine(1e-3, 3, 10),
             joptim.linear_warmup_cosine(1e-3, 3, 10))):
        for step in (0, 2, 3, 5, 12):
            got = ours(torch.tensor(step, dtype=torch.int32))
            want = theirs(jnp.asarray(step, jnp.int32))
            assert got.dtype == torch.float32
            assert float(got) == float(want), step


# --- the entry point -------------------------------------------------------------
def test_train_cli_resumes_where_it_stopped(tmp_path):
    """`python -m repro_torch.launch.train --reduced --device cpu`: 2 steps
    and a checkpoint, then `--resume` to 3 steps; the resumed step's loss
    and gradient norm equal an uninterrupted 3-step run's, bit for bit
    (params, Adam state and the stream's cursor come back)."""
    common = ["--reduced", "--device", "cpu", "--batch", "2", "--seq", "24"]
    straight = train_cli.main(common + [
        "--steps", "3", "--checkpoint-dir", str(tmp_path / "a")])
    first = train_cli.main(common + [
        "--steps", "2", "--checkpoint-dir", str(tmp_path / "b")])
    resumed = train_cli.main(common + [
        "--steps", "3", "--resume", "--checkpoint-dir", str(tmp_path / "b")])
    assert [r["step"] for r in first] == [0, 1]
    assert [r["step"] for r in resumed] == [2]
    for key in ("loss", "grad_norm"):
        assert [r[key] for r in first] == [r[key] for r in straight[:2]]
        assert resumed[0][key] == straight[2][key]
    assert all(np.isfinite(r["loss"]) for r in straight)


def test_train_entry_points_need_a_gpu_unless_asked(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_cli.main(["--reduced", "--steps", "1",
                        "--checkpoint-dir", str(tmp_path)])
