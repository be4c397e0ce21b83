"""PyTorch port vs JAX reference: rwkv6's layers (`models/rwkv.py`), the
MoE FFN (`models/moe.py`), and the loss and gradients of an RWKV and an
MoE model.

Reduced configs in float32, the reference's parameters carried across,
inputs from a seeded numpy generator.  The reference's scan runs on its
Pallas kernel in interpret mode (`scan_impl="kernel"`), its attention on
the chunked form.

The explicit zero u.  rwkv6's bonus is per head, so `time_mix` scans with
a zero u and adds (r . (u_h k)) v itself.  The reference's kernel path
passes u = 0 to its kernel when handed u=None; its "chunked" and "scan"
forms read u=None as no scaling and add the current token's k v a second
time (ROADMAP, queue C, `src/repro/kernels/ops.py:165-170`).  The port
passes an explicit zero, so its kernel and plain forms agree with each
other and with the reference's kernel path; `test_the_explicit_zero_u`
pins all three and the reference's extra term.

Tolerances, each stated where it is used: float32 pieces 1e-5 of max
|reference| (measured beside each test); the loss 1e-6 relative and the
gradients 1e-4 of each leaf's max |gradient|, the pins of
`tests/test_torch_lm_train.py`, plus on each leaf the port's own spread
under one ulp of its parameters, which at rwkv6's init is of the pin's
size (`test_rwkv6_gradient_at_init_is_ill_conditioned`).
"""
import contextlib
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.kernels import ops as jops
from repro.models import lm as jlm
from repro.models import moe as jmoe
from repro.models import rwkv as jrwkv
from repro_torch import configs, nn
from repro_torch.data import synthetic
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import linear_scan as ls
from repro_torch.kernels import ops
from repro_torch.models import api, lm, moe, rwkv
from torch_lm_reference import by_port_name, cfgs, jbatch, models, rel
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

F32_TOL = 1e-5
LOSS_TOL = 1e-6
GRAD_TOL = 1e-4
MOE_ARCHS = ["deepseek-moe-16b", "moonshot-v1-16b-a3b"]


def _t(tree):
    """A reference parameter tree as a port `ParamTree` (float32)."""
    return nn.ParamTree(jax.tree.map(
        lambda a: torch.tensor(np.asarray(a, np.float32)), tree))


# --- rwkv6 ----------------------------------------------------------------------
@pytest.fixture(scope="module")
def rwkv_layers():
    """rwkv6 reduced: the reference's time- and channel-mix parameters, with
    a random u and decay base (the reference inits them constant) so that
    the bonus and varied decays act."""
    jcfg, pcfg = cfgs("rwkv6-1.6b")
    rng = np.random.default_rng(0)
    jt = jrwkv.init_time_mix(jax.random.PRNGKey(0), jcfg)
    jt["u_bonus"] = jnp.asarray(rng.standard_normal(64, np.float32))
    jt["decay_base"] = jnp.asarray(rng.uniform(-3.0, 1.0, 64)
                                   .astype(np.float32))
    jc = jrwkv.init_channel_mix(jax.random.PRNGKey(1), jcfg)
    return jcfg, pcfg, jt, jc


@pytest.mark.parametrize("impl", ["kernel", "chunked"])
def test_time_mix_matches_reference_with_state_carried(rwkv_layers, impl):
    """`time_mix` over 21 tokens from no state, then 5 more from the WKV
    state and shift it left (and 1, a decode step), against the
    reference's on its Pallas kernel: outputs, states, shifts.  Measured
    max: 3.5e-7."""
    jcfg, pcfg, jt, _ = rwkv_layers
    pcfg = dataclasses.replace(pcfg, scan_impl=impl)
    pt = _t(jt)
    rng = np.random.default_rng(1)
    xs = [rng.standard_normal((2, t, 64), np.float32) for t in (21, 5, 1)]
    state, jstate = (None, None), (None, None)
    jmix = jax.jit(jrwkv.time_mix, static_argnums=1)
    for x in xs:
        out, wkv, shift = rwkv.time_mix(pt, pcfg, torch.from_numpy(x),
                                        *state)
        jout, jwkv, jshift = jmix(jt, jcfg, jnp.asarray(x), *jstate)
        for got, want in ((out, jout), (wkv, jwkv), (shift, jshift)):
            assert got.dtype == torch.float32
            assert got.shape == want.shape
            assert rel(got, want) <= F32_TOL
        state, jstate = (wkv, shift), (jwkv, jshift)


def test_channel_mix_matches_reference_with_shift_carried(rwkv_layers):
    """`channel_mix` over 9 tokens, then 3 from the carried shift.
    Measured max: 1.2e-8."""
    jcfg, pcfg, _, jc = rwkv_layers
    pc = _t(jc)
    rng = np.random.default_rng(2)
    shift, jshift = None, None
    for t in (9, 3):
        x = rng.standard_normal((2, t, 64), np.float32)
        out, shift = rwkv.channel_mix(pc, pcfg, torch.from_numpy(x), shift)
        jout, jshift = jrwkv.channel_mix(jc, jcfg, jnp.asarray(x), jshift)
        assert rel(out, jout) <= F32_TOL
        assert rel(shift, jshift) <= F32_TOL


def test_the_explicit_zero_u():
    """The RWKV read with u = 0: the port's kernel path (its plain version
    on the CPU), its "chunked" and its "scan" forms agree, and equal the
    reference's kernel path handed u=None (its Pallas kernel, with u = 0);
    the reference's "chunked" with u=None exceeds them by exactly the
    current token's (q . k) v, the term a u=None read adds (queue C).
    Measured: 3.3e-7 between the port and the reference's kernel; the
    extra term more than half of the outputs' scale."""
    rng = np.random.default_rng(3)
    b, t, dk, dv = 3, 19, 16, 16
    q, k, v = (rng.standard_normal((b, t, d), np.float32)
               for d in (dk, dk, dv))
    w = rng.uniform(0.5, 1.0, (b, t, dk)).astype(np.float32)
    s0 = rng.standard_normal((b, dk, dv), np.float32)
    tq, tk, tv, tw, ts0 = map(torch.from_numpy, (q, k, v, w, s0))
    zero = torch.zeros(dk)
    outs = {impl: ops.gated_linear_scan(tq, tk, tv, tw, zero, ts0,
                                        decay_before_read=False, impl=impl,
                                        chunk=8)
            for impl in ("kernel", "chunked", "scan")}
    jq, jk, jv, jw, js0 = map(jnp.asarray, (q, k, v, w, s0))
    jo, js = jops.gated_linear_scan(jq, jk, jv, jw, None, js0,
                                    decay_before_read=False, impl="kernel",
                                    chunk=8)
    for o, s in outs.values():
        assert rel(o, jo) <= F32_TOL and rel(s, js) <= F32_TOL
    assert torch.equal(outs["kernel"][0], outs["chunked"][0])
    jo_chunked, _ = jops.gated_linear_scan(jq, jk, jv, jw, None, js0,
                                           decay_before_read=False,
                                           impl="chunked", chunk=8)
    extra = np.sum(q * k, axis=-1, keepdims=True) * v
    assert rel(outs["chunked"][0] + torch.from_numpy(extra),
                jo_chunked) <= F32_TOL
    assert np.max(np.abs(extra)) > 0.5 * np.max(np.abs(np.asarray(jo)))
    # the port reads u=None as the reference's plain forms do
    none, _ = ops.gated_linear_scan(tq, tk, tv, tw, None, ts0,
                                    decay_before_read=False,
                                    impl="chunked", chunk=8)
    assert rel(none, jo_chunked) <= F32_TOL


# --- MoE ------------------------------------------------------------------------
@pytest.mark.parametrize("arch", MOE_ARCHS)
@pytest.mark.parametrize("group", [1, 2, 7, 48, 64, 4096])
def test_capacity_matches_reference(arch, group):
    for get in ("get", "get_reduced"):
        for factor in (0.25, 1.25, 4.0):
            cfg = dataclasses.replace(getattr(configs, get)(arch),
                                      moe_capacity_factor=factor)
            jcfg = dataclasses.replace(getattr(jconfigs, get)(arch),
                                       moe_capacity_factor=factor)
            assert moe._capacity(group, cfg) == jmoe._capacity(group, jcfg)


@pytest.fixture(scope="module", params=MOE_ARCHS)
def moe_layer(request):
    """An MoE arch's reduced configs and the reference's MoE parameters."""
    jcfg, pcfg = cfgs(request.param)
    jp = jmoe.init(jax.random.PRNGKey(2), jcfg)
    return jcfg, pcfg, jp


def test_route_matches_reference(moe_layer):
    """Router logits in float32, softmax, top-k (renormalised for
    moonshot, not for deepseek), the load-balance and z losses, over 2
    groups of 64 tokens.  Indices equal; gates and losses measured within
    3.8e-7."""
    jcfg, pcfg, jp = moe_layer
    x = np.random.default_rng(4).standard_normal((2, 64, 64), np.float32)
    gates, idx, aux = moe._route(_t(jp), pcfg, torch.from_numpy(x))
    jgates, jidx, jaux = jmoe._route(jp, jcfg, jnp.asarray(x))
    assert idx.dtype == torch.int64
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    assert rel(gates, jgates) <= F32_TOL
    assert rel(aux, jaux) <= F32_TOL and bool((aux > 0).all())
    summed = gates.sum(-1)
    assert bool(torch.allclose(summed, torch.ones_like(summed))) \
        == pcfg.norm_topk


def _dense(cfg, gates, slot, keep, group):
    """The port's slots as the reference's dense (G, T, E, C) dispatch and
    combine tensors."""
    e, cap = cfg.n_experts, moe._capacity(group, cfg)
    oh = torch.nn.functional.one_hot(slot, e * cap + 1)[..., :e * cap]
    oh = oh * keep[..., None]
    disp = oh.sum(2).reshape(*slot.shape[:2], e, cap).float()
    comb = (oh * gates[..., None]).sum(2).reshape(*slot.shape[:2], e, cap)
    return disp, comb


@pytest.mark.parametrize("factor", [1.25, 0.25])
def test_dispatch_matches_reference_and_drops_the_same_tokens(moe_layer,
                                                              factor):
    """The slots of the reference's routing (2 groups of 64 tokens) as its
    one-hot dispatch and combine tensors: equal, with the capacity factor
    at 1.25 and at 0.25, where experts overflow their 8 slots and the
    k-major order decides which choices drop.  Measured: dispatch and
    combine equal."""
    jcfg, pcfg, jp = moe_layer
    jcfg = dataclasses.replace(jcfg, moe_capacity_factor=factor)
    pcfg = dataclasses.replace(pcfg, moe_capacity_factor=factor)
    x = np.random.default_rng(5).standard_normal((2, 64, 64), np.float32)
    jgates, jidx, _ = jmoe._route(jp, jcfg, jnp.asarray(x))
    gates = torch.tensor(np.asarray(jgates))
    idx = torch.tensor(np.asarray(jidx).astype(np.int64))
    slot, keep = moe._dispatch(pcfg, idx, 64)
    disp, comb = _dense(pcfg, gates, slot, keep, 64)
    jdisp, jcomb = jmoe._dispatch_combine(jcfg, jgates, jidx, 64)
    np.testing.assert_array_equal(disp.numpy(), np.asarray(jdisp))
    assert rel(comb, jcomb) <= F32_TOL
    dropped = int((~keep).sum())
    assert (dropped > 0) == (factor < 1.0), dropped
    assert int(disp.sum()) == int(keep.sum())
    assert float(disp.sum(dim=1).max()) <= 1.0   # one token a slot


@pytest.mark.parametrize("factor", [1.25, 0.25])
def test_moe_matches_reference(moe_layer, factor):
    """`moe.experts` fed the reference's (gates, indices), and `moe.apply`
    with its own routing (indices equal first), against the reference's
    `moe.apply` on 2 x 32 tokens (one group of 64), with and without
    overflow.  Measured max: 3.0e-7."""
    jcfg, pcfg, jp = moe_layer
    jcfg = dataclasses.replace(jcfg, moe_capacity_factor=factor)
    pcfg = dataclasses.replace(pcfg, moe_capacity_factor=factor)
    pp = _t(jp)
    x = np.random.default_rng(6).standard_normal((2, 32, 64), np.float32)
    want, jaux = jmoe.apply(jp, jcfg, jnp.asarray(x))
    jgates, jidx, _ = jmoe._route(jp, jcfg, jnp.asarray(x).reshape(1, 64,
                                                                    64))
    tx = torch.from_numpy(x)
    fed = moe.experts(pp, pcfg, tx, torch.tensor(np.asarray(jgates)),
                      torch.tensor(np.asarray(jidx).astype(np.int64)))
    assert fed.shape == (2, 32, 64) and rel(fed, want) <= F32_TOL
    gates, idx, _ = moe.route(pp, pcfg, tx)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    out, aux = moe.apply(pp, pcfg, tx)
    assert rel(out, want) <= F32_TOL and rel(aux, jaux) <= F32_TOL


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_whole_model_routes_as_the_reference_then_its_logits_match(
        arch, monkeypatch):
    """Prefill of 2 x 24 tokens and 2 decode steps through the whole
    reduced model (dense prefix + MoE layers): every MoE layer's routing
    indices equal the reference's (a flipped near-tie would show here,
    with the top-k margin in the message), then the logits within 1e-5 of
    max |logit|.  The reference runs with its layers unrolled, its router's
    indices read back by a host callback.  Measured: indices equal;
    logits 7.7e-7."""
    jcfg, pcfg = cfgs(arch, scan_layers=False)
    jparams, params = models(arch)
    seen, jseen = [], []

    def record(route):
        def call(p, cfg, x):
            gates, idx, aux = route(p, cfg, x)
            seen.append(idx)
            return gates, idx, aux
        return call

    def jrecord(route):
        def call(p, cfg, x):
            gates, idx, aux = route(p, cfg, x)
            jax.debug.callback(lambda i: jseen.append(np.asarray(i)), idx,
                               ordered=True)
            return gates, idx, aux
        return call

    monkeypatch.setattr(moe, "_route", record(moe._route))
    monkeypatch.setattr(jmoe, "_route", jrecord(jmoe._route))
    tokens = synthetic.lm_batch(1, 2, 26, pcfg.vocab)["tokens"]
    jtok = jnp.asarray(tokens.numpy().astype(np.int32))
    logits, caches = lm.prefill(params, pcfg, tokens[:, :24], cache_len=26,
                                cache_dtype=torch.float32)
    jlogits, jcaches = jax.jit(lambda p, t: jlm.prefill(
        p, jcfg, t, cache_len=26, cache_dtype=jnp.float32))(jparams,
                                                            jtok[:, :24])
    got, want = [logits], [jlogits]
    jdec = jax.jit(lambda p, t, c: jlm.decode_step(p, jcfg, t, c))
    for t in (24, 25):
        logits, caches = lm.decode_step(params, pcfg, tokens[:, t], caches)
        jlogits, jcaches = jdec(jparams, jtok[:, t], jcaches)
        got.append(logits)
        want.append(jlogits)
    jax.effects_barrier()
    n_moe = pcfg.n_layers - pcfg.first_dense_layers
    assert len(seen) == len(jseen) == 3 * n_moe
    for i, (idx, jidx) in enumerate(zip(seen, jseen)):
        assert np.array_equal(idx.numpy(), np.asarray(jidx)), \
            f"routing call {i} differs"
    assert rel(torch.stack(got, 1),
                np.stack([np.asarray(w) for w in want], 1)) <= F32_TOL


# --- loss and gradients -----------------------------------------------------------
# (arch, batch seed, tokens a row): test_torch_lm_train.py's batch, a second
# rwkv6 batch, deepseek's tokens in one MoE group of 64
LOSS_GRAD_CASES = [pytest.param("rwkv6-1.6b", 0, 40, id="rwkv6-1.6b"),
                   pytest.param("rwkv6-1.6b", 2, 32, id="rwkv6-1.6b-seed2"),
                   pytest.param("deepseek-moe-16b", 0, 32,
                                id="deepseek-moe-16b")]


def _port_grads(params, pcfg, batch):
    """(loss, metrics, {name: gradient}) of the port's `lm_loss`."""
    params.requires_grad_(True)
    loss, metrics = lm.lm_loss(params, pcfg, batch)
    named = dict(params.named_parameters())
    grads = torch.autograd.grad(loss, list(named.values()))
    return (float(loss.detach()), {k: v.detach() for k, v in metrics.items()},
            dict(zip(named, grads)))


@contextlib.contextmanager
def _one_ulp(params, seed: int):
    """Each parameter one float32 ulp above or below its value, the side
    drawn from `seed`; restored on exit."""
    gen = torch.Generator().manual_seed(seed)
    plist = list(params.parameters())
    saved = [p.detach().clone() for p in plist]
    with torch.no_grad():
        for p in plist:
            up = torch.rand(p.shape, generator=gen) < 0.5
            p.copy_(torch.nextafter(p, torch.where(up, torch.inf, -torch.inf)))
    try:
        yield
    finally:
        with torch.no_grad():
            for p, s in zip(plist, saved):
                p.copy_(s)


@functools.lru_cache(maxsize=None)
def _loss_and_grads(arch: str, seed: int, t: int):
    """The reference's and the port's float32 loss and gradients on one
    batch, and the port's own spread: for each leaf the larger move of its
    gradient, over two one-ulp nudges of the parameters (`_one_ulp`), as a
    fraction of the leaf's max |gradient|."""
    jcfg, pcfg = cfgs(arch)
    jparams, params = models(arch)
    batch = synthetic.lm_batch(seed, 2, t, pcfg.vocab)
    (jloss, jm), jgrads = jax.jit(
        jax.value_and_grad(jlm.lm_loss, has_aux=True),
        static_argnums=1)(jparams, jcfg, jbatch(batch))
    want = by_port_name(jgrads, len(params["layers"]))
    loss, metrics, grads = _port_grads(params, pcfg, batch)
    spread = dict.fromkeys(grads, 0.0)
    for draw in (1, 2):
        with _one_ulp(params, draw):
            nudged = _port_grads(params, pcfg, batch)[2]
        for name, g in nudged.items():
            spread[name] = max(spread[name], rel(g, grads[name].numpy()))
    return (batch, (float(jloss), jax.tree.map(float, jm), want),
            (loss, metrics, grads), spread)


@pytest.mark.parametrize("arch, seed, t", LOSS_GRAD_CASES)
def test_lm_loss_and_gradients_match_reference(arch, seed, t):
    """`lm_loss` (the port with remat, as it trains; rwkv6's scan through
    its autograd Function) and the gradient of every parameter against
    `jax.value_and_grad(repro.models.lm.lm_loss)`, deepseek's load-balance
    and router z losses now non-zero and equal.  The loss within 1e-6
    relative; each leaf's gradient within 1e-4 of its max |gradient| plus
    the port's own spread on that leaf, what one ulp of the parameters
    moves it by (`_loss_and_grads`): at rwkv6's init that spread is of the
    pin's size (`test_rwkv6_gradient_at_init_is_ill_conditioned`).
    Measured, the largest leaf error (its spread): rwkv6 seed 0 3.4e-5
    (2.8e-5), seed 2 1.07e-4 on layer 0's u_bonus (1.25e-4), deepseek
    2.5e-6 (1.9e-6); losses 1.4e-7 and 2.2e-7 relative (rwkv6), equal
    (deepseek)."""
    pcfg = cfgs(arch)[1]
    _, (jloss, jm, want), (loss, metrics, grads), spread = _loss_and_grads(
        arch, seed, t)
    assert abs(loss - jloss) <= LOSS_TOL * abs(jloss)
    for key in ("moe_lb", "router_z"):
        got = float(metrics[key])
        assert (got > 0) == (pcfg.ffn == "moe")
        assert abs(got - jm[key]) <= LOSS_TOL * max(abs(jm[key]), 1e-30)
    assert set(want) == set(grads)
    for name, w in want.items():
        err = rel(grads[name], w)
        assert err <= GRAD_TOL + spread[name], (name, err, spread[name])


def test_rwkv6_gradient_at_init_is_ill_conditioned(monkeypatch):
    """Why rwkv6's gradient at its init moves with the last bits of its
    inputs, checked on the second batch (seed 2, 2 x 32, reduced):

    * u = 0 and the WKV state starts at zero, so every layer's group norm
      sees exactly zero at position 0, where its backward scales by
      1/sqrt(eps) = 316: the u_bonus leaves carry most of the squared
      gradient norm (measured 0.936 in float32; more than 99% of it from
      position 0, a scratch decomposition);
    * one ulp of the parameters moves the port's own u_bonus gradient by
      at least 0.4 of GRAD_TOL (measured 1.25e-4 of the leaf's max): the
      1.07e-4 between the packages on this batch is of that size;
    * in bf16 the reference's own gradient (its chunked form handed the
      port's explicit zero u; its kernel path's VJP raises in bf16,
      ROADMAP queue C) departs from its float32 u_bonus norm by more than
      5%, ten times chip_smoke's TOL_TRAIN_GRAD_NORM, and so does the
      port's (measured +18.7% and -13.1%; the two bf16 readings 37%
      apart).  A bf16 gradient norm of this model at its init is not a
      quantity two paths can agree on to 0.5%."""
    arch = "rwkv6-1.6b"
    jcfg, pcfg = cfgs(arch)
    jparams, params = models(arch)
    batch, (_, _, want), (_, _, grads), spread = _loss_and_grads(arch, 2, 32)

    def u_norm(g: dict) -> float:
        return float(np.sqrt(sum(np.sum(np.square(np.asarray(v, np.float64)))
                                 for k, v in g.items() if "u_bonus" in k)))

    total = float(np.sqrt(sum(np.sum(np.square(v.double().numpy()))
                              for v in grads.values())))
    assert u_norm(grads) ** 2 / total ** 2 > 0.9
    seen = []
    layernorm = nn.layernorm

    def recorded(p, x, **kw):
        if x.ndim == 4:                       # the group norm (B, T, H, hd)
            seen.append(x.detach()[:, 0])
        return layernorm(p, x, **kw)

    monkeypatch.setattr(nn, "layernorm", recorded)
    with torch.no_grad():
        lm.lm_loss(params, pcfg, batch)
    monkeypatch.undo()
    assert len(seen) == pcfg.n_layers
    assert all(bool((x == 0).all()) for x in seen)
    assert max(s for k, s in spread.items() if "u_bonus" in k) \
        >= 0.4 * GRAD_TOL
    # bf16: the port, and the reference with an explicit zero u
    scan = jrwkv.kops.gated_linear_scan

    def zero_u(q, k, v, w, u=None, s0=None, **kw):
        return scan(q, k, v, w, jnp.zeros((q.shape[-1],), jnp.float32)
                    if u is None else u, s0, **kw)

    monkeypatch.setattr(jrwkv.kops, "gated_linear_scan", zero_u)
    _, jgrads16 = jax.jit(jax.value_and_grad(jlm.lm_loss, has_aux=True),
                          static_argnums=1)(
        jparams, dataclasses.replace(jcfg, dtype="bfloat16",
                                     scan_impl="chunked"), jbatch(batch))
    grads16 = _port_grads(params, dataclasses.replace(pcfg,
                                                      dtype="bfloat16"),
                          batch)[2]
    ref16 = by_port_name(jgrads16, len(params["layers"]))
    for got16, got32 in ((ref16, want), (grads16, grads)):
        assert abs(u_norm(got16) / u_norm(got32) - 1.0) > 0.05


# --- what the model hands the kernels ------------------------------------------------
FAMILY_ARCHS = ["gemma2-27b", "starcoder2-7b", "h2o-danube-1.8b",
                "command-r-35b", "llava-next-mistral-7b", "rwkv6-1.6b",
                "moonshot-v1-16b-a3b", "deepseek-moe-16b"]


def _head_geometry(arch: str, **kw):
    """The reduced config with the full config's heads (head dim 80 or 128,
    GQA groups of 2 to 9), so that the kernels see each arch's views."""
    full = configs.get(arch)
    return dataclasses.replace(
        configs.get_reduced(arch), n_heads=full.n_heads,
        kv_heads=full.kv_heads, head_dim=full.head_dim,
        d_model=full.head_dim if full.mixer == "rwkv" else 64,
        attn_scale=full.attn_scale, **kw)


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_model_hands_the_kernels_what_their_cuda_wrappers_take(
        arch, monkeypatch):
    """On the card the wrappers check their inputs and raise on what the
    kernels do not take (dtype, shape, strides; for bf16 attention TMA's
    16-byte bases and strides).  Here run those checks on every call each
    arch makes in a bf16 prefill of 2 x 64 tokens (one whole scan chunk,
    two MoE groups) and a decode step, at the full config's head geometry, then the plain
    version: flash attention once per attention layer in prefill, the
    scan once per rwkv6 layer in prefill and in decode."""
    seen, tma = [], []

    def checked(module, name):
        plain = getattr(module, name)

        def call(*args, **kw):
            if name == "flash_attention":
                module._check_inputs(*args[:3], kw.get("window"),
                                     kw.get("softcap"))
                for t, label in zip(args[:3], "qkv"):
                    tma.append(fa.tma_strides(t, label))
            else:
                module._check_inputs(*args[:6])
            seen.append(name)
            return plain(*args, **kw)

        monkeypatch.setattr(module, name, call)

    checked(fa, "flash_attention")
    checked(ls, "linear_scan")
    cfg = _head_geometry(arch, dtype="bfloat16", param_dtype="bfloat16",
                         n_layers=configs.get_reduced(arch).n_layers)
    params = api.init(cfg, device="cpu")
    batch = synthetic.make_batch_for(cfg, 0, 2, 64 + cfg.vision_tokens * bool(
        cfg.vision_dim))
    logits, caches = api.prefill(params, cfg, batch,
                                 cache_len=batch["tokens"].shape[1]
                                 + cfg.vision_tokens * bool(cfg.vision_dim)
                                 + 1)
    api.decode_step(params, cfg, torch.argmax(logits, -1), caches)
    n = cfg.n_layers
    if cfg.mixer == "rwkv":
        assert seen == ["linear_scan"] * (2 * n)
    else:
        assert seen == ["flash_attention"] * n and len(tma) == 3 * n


# --- on the card ----------------------------------------------------------------------
CARD_TOL = 1e-4     # float32 kernel vs plain: chip_smoke.py's TOL


def _need_gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


@pytest.mark.cuda
@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_cuda_each_arch_kernel_path_matches_plain(arch):
    """Each arch at the full config's head geometry on the card, float32:
    prefill of 2 x 64 tokens and 2 decode steps on the kernel path
    (flash attention's CUDA-core instance; the scan's chunked instance at
    prefill, its step instance at decode) against the plain path, within
    chip_smoke.py's float32 TOL, with one launch a layer and call."""
    _need_gpu()
    cfg = _head_geometry(arch, dtype="float32")
    params = api.init(cfg, device="cuda")
    batch = {k: v.cuda() for k, v in synthetic.make_batch_for(
        cfg, 0, 2, 66 + cfg.vision_tokens * bool(cfg.vision_dim)).items()}
    n_img = cfg.vision_tokens * bool(cfg.vision_dim)

    def run(impl):
        c = dataclasses.replace(cfg, attn_impl=impl, scan_impl=impl)
        logits, caches = api.prefill(
            params, c, {**batch, "tokens": batch["tokens"][:, :64]},
            cache_len=n_img + 66, cache_dtype=torch.float32)
        out = [logits]
        for t in (64, 65):
            logits, caches = api.decode_step(params, c,
                                             batch["tokens"][:, t], caches)
            out.append(logits)
        return torch.stack(out, 1)

    before = (fa.flash_attention.launches, ls.linear_scan.launches)
    got = run("kernel")
    torch.cuda.synchronize()
    launched = (fa.flash_attention.launches - before[0],
                ls.linear_scan.launches - before[1])
    n = cfg.n_layers
    assert launched == ((0, 3 * n) if cfg.mixer == "rwkv" else (n, 0))
    want = run("chunked")
    err = float((got - want).abs().max() / want.abs().max())
    assert err <= CARD_TOL, err
