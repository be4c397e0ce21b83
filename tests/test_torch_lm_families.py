"""PyTorch port vs JAX reference: every decoder-only architecture family
beside hymba (gemma-2, starcoder2, h2o-danube, command-r, llava, rwkv6 and
the two MoE models), each at its reduced config in float32.

Both packages use `get_reduced(arch)` (the JAX side without remat), the
reference's parameters are carried across by `lm.load_jax_params`, and
token batches (and llava's patches) come from the same numpy generator.
The reference runs jitted on its plain chunked attention
(`attn_impl="chunked"`) and, for rwkv6, on its Pallas scan kernel in
interpret mode (`scan_impl="kernel"`, the path that passes the explicit
zero u the port passes; see `tests/test_torch_rwkv_moe.py`).  The port runs
on its default "kernel" impls, which on CPU tensors are the kernels' plain
versions.

Tolerance: 1e-5 of max |reference logit|.  Both packages compute the same
float32 graph in another summation order (matmuls, the chunked attention
and scan against the reference's forms); measured maxima are written
beside each test.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.data import synthetic as jsynthetic
from repro.models import api as japi
from repro.models import lm as jlm
from repro_torch import configs
from repro_torch.data import synthetic
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import linear_scan as ls
from repro_torch.models import api, lm
from torch_lm_reference import (by_port_name, cfgs, jbatch, models, np_tree,
                                rel)
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

ARCHS = ["gemma2-27b", "starcoder2-7b", "h2o-danube-1.8b", "command-r-35b",
         "llava-next-mistral-7b", "rwkv6-1.6b", "moonshot-v1-16b-a3b",
         "deepseek-moe-16b"]
F32_TOL = 1e-5
B, PROMPT, N_DECODE = 2, 24, 3   # the prompt is longer than the windows (16)


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    """(arch, reduced configs, the reference's params, the port's params
    carried over, one batch of PROMPT + N_DECODE tokens)."""
    arch = request.param
    jcfg, pcfg = cfgs(arch)
    jparams, params = models(arch)
    batch = synthetic.make_batch_for(pcfg, 0, B, PROMPT + N_DECODE
                                     + pcfg.vision_tokens * bool(
                                         pcfg.vision_dim))
    return arch, jcfg, pcfg, jparams, params, batch


# --- configuration and registry ----------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_config_registry_and_cells_match_reference(arch):
    """The port's full and reduced configs equal the reference's field by
    field, except the two impl defaults ("kernel" in the port), and its
    copy of `configs.shapes` gives the same cells and long-context
    verdicts."""
    for get in ("get", "get_reduced"):
        ours = dataclasses.asdict(getattr(configs, get)(arch))
        theirs = dataclasses.asdict(getattr(jconfigs, get)(arch))
        assert ours.pop("attn_impl") == ours.pop("scan_impl") == "kernel"
        theirs.pop("attn_impl"), theirs.pop("scan_impl")
        assert ours == theirs
    assert configs.all_configs()[arch] == configs.get(arch)
    cfg, jcfg = configs.get(arch), jconfigs.get(arch)
    assert configs.long_context_ok(cfg) == jconfigs.long_context_ok(jcfg)
    assert [(s.name, s.seq_len, s.global_batch, s.kind, ok, why)
            for s, ok, why in configs.cells(cfg)] == \
        [(s.name, s.seq_len, s.global_batch, s.kind, ok, why)
         for s, ok, why in jconfigs.cells(jcfg)]


# --- weights -------------------------------------------------------------------
def test_load_jax_params_covers_every_leaf(model):
    """Every reference leaf (the dense prefix's list and llava's projector
    included) lands in the port with its value, and every port parameter
    is filled; a missing or a surplus leaf raises."""
    arch, _, pcfg, jparams, params, _ = model
    ours = dict(params.named_parameters())
    leaves = dict(by_port_name(np_tree(jparams), len(params["layers"])))
    assert set(ours) == set(leaves)
    for name, want in leaves.items():
        np.testing.assert_array_equal(ours[name].numpy(), want)
    assert ("prefix.0.ffn.wg.w" in ours) == (pcfg.ffn == "moe")
    assert ("projector.w2.b" in ours) == bool(pcfg.vision_dim)
    tree = np_tree(jparams)
    del tree["final_norm"]["scale"]
    with pytest.raises(KeyError):
        lm.load_jax_params(params, tree)
    tree = np_tree(jparams)
    tree["extra"] = {"w": np.zeros((2,), np.float32)}
    with pytest.raises(KeyError):
        lm.load_jax_params(params, tree)


# --- serving -------------------------------------------------------------------
def _jax_serve(jcfg, jparams, batch):
    """Reference: prefill logits, then those of teacher-forced decode steps."""
    jb = jbatch(batch)
    cache_len = jb["tokens"].shape[1] + (
        jb["patches"].shape[1] if "patches" in jb else 0)
    pf = jax.jit(lambda p, b: japi.prefill(
        p, jcfg, {k: v[:, :PROMPT] if k == "tokens" else v
                  for k, v in b.items()},
        cache_len=cache_len, cache_dtype=jnp.float32))
    dec = jax.jit(lambda p, t, c: japi.decode_step(p, jcfg, t, c))
    logits, caches = pf(jparams, jb)
    out = [logits]
    for t in range(PROMPT, PROMPT + N_DECODE):
        logits, caches = dec(jparams, jb["tokens"][:, t], caches)
        out.append(logits)
    return np.stack([np.asarray(o) for o in out], 1)


def _port_serve(pcfg, params, batch):
    tokens = batch["tokens"]
    cache_len = tokens.shape[1] + (batch["patches"].shape[1]
                                   if "patches" in batch else 0)
    logits, caches = api.prefill(
        params, pcfg, {**batch, "tokens": tokens[:, :PROMPT]},
        cache_len=cache_len, cache_dtype=torch.float32)
    out = [logits]
    for t in range(PROMPT, PROMPT + N_DECODE):
        logits, caches = api.decode_step(params, pcfg, tokens[:, t], caches)
        out.append(logits)
    return torch.stack(out, 1)


def test_prefill_and_decode_logits_match_reference(model):
    """Prefill of 24 tokens (after llava's 16 image tokens) and 3
    teacher-forced decode steps, float32 caches (the windows of 16 wrap),
    against the reference's.  Measured max over the eight archs: 3.4e-6 of
    max |logit| (gemma2; rwkv6, against the Pallas scan, 1.7e-6)."""
    _, jcfg, pcfg, jparams, params, batch = model
    want = _jax_serve(jcfg, jparams, batch)
    got = _port_serve(pcfg, params, batch)
    assert got.shape == want.shape and got.dtype == torch.float32
    assert rel(got, want) <= F32_TOL


def test_decode_matches_teacher_forcing(model):
    """Within the port, as the reference's
    `tests/test_models_smoke.py::test_decode_matches_teacher_forcing`: the
    logits of prefill and decode steps equal the train-mode forward's at
    every position (the ring buffers, RWKV states and MoE groups of one
    token at decode included).  As there, the MoE archs run at full
    capacity: which choices a group drops depends on the group (training
    groups the whole batch, decode routes one token), so the two paths
    agree only where nothing drops.  Measured max: 1.1e-6 of max |logit|."""
    _, _, pcfg, _, params, batch = model
    if pcfg.ffn == "moe":
        pcfg = dataclasses.replace(
            pcfg, moe_capacity_factor=float(pcfg.n_experts) / pcfg.top_k)
    tokens, patches = batch["tokens"], batch.get("patches")
    with torch.no_grad():
        x = lm._embed_input(params, pcfg, tokens, patches)
        n_img = x.shape[1] - tokens.shape[1]
        hidden, _, _ = lm.forward_hidden(params, pcfg, x)
        want = lm.logits_for(params, pcfg,
                             hidden)[:, n_img + PROMPT - 1:]
    logits, caches = lm.prefill(params, pcfg, tokens[:, :PROMPT], patches,
                                cache_len=x.shape[1],
                                cache_dtype=torch.float32)
    got = [logits]
    for t in range(PROMPT, tokens.shape[1]):
        logits, caches = lm.decode_step(params, pcfg, tokens[:, t], caches)
        got.append(logits)
    got = torch.stack(got, 1)
    assert got.shape == want.shape
    assert float((got - want).abs().max() / want.abs().max()) <= F32_TOL


def test_greedy_generate_runs_on_the_plain_versions_on_the_cpu(model):
    """`greedy_generate` (bf16 caches) of 4 tokens, llava with its
    patches: int64 tokens in range; on CPU tensors no kernel launches."""
    _, _, pcfg, _, params, batch = model
    before = (fa.flash_attention.launches, ls.linear_scan.launches)
    out = lm.greedy_generate(params, pcfg, batch["tokens"][:, :PROMPT], 4,
                             patches=batch.get("patches"))
    assert (fa.flash_attention.launches, ls.linear_scan.launches) == before
    assert out.shape == (B, 4) and out.dtype == torch.int64
    assert bool(((out >= 0) & (out < pcfg.vocab)).all())


# --- llava -----------------------------------------------------------------------
def test_llava_batch_projector_and_loss_match_reference():
    """llava: `make_batch_for` gives the reference's tokens, labels and
    patches (the text cut to seq - vision_tokens); the projected image
    tokens and the loss over the text positions behind them match.
    Measured: projector 1.3e-7, loss equal."""
    arch = "llava-next-mistral-7b"
    jcfg, pcfg = cfgs(arch)
    ours = synthetic.make_batch_for(pcfg, 3, B, 40)
    theirs = jsynthetic.make_batch_for(jcfg, 3, B, 40)
    assert set(ours) == set(theirs) == {"tokens", "labels", "patches"}
    assert ours["tokens"].shape == (B, 40 - pcfg.vision_tokens)
    for key in ours:
        np.testing.assert_array_equal(ours[key].numpy(),
                                      np.asarray(theirs[key]))
    jparams, params = models(arch)
    img = lm.project_patches(params, pcfg, ours["patches"])
    assert img.shape == (B, pcfg.vision_tokens, pcfg.d_model)
    assert rel(img, jlm.project_patches(jparams, jcfg,
                                         theirs["patches"])) <= F32_TOL
    jloss, _ = jax.jit(jlm.lm_loss, static_argnums=1)(jparams, jcfg, theirs)
    loss, metrics = api.loss(params, pcfg, ours)
    assert float(metrics["tokens"]) == B * (40 - pcfg.vision_tokens)
    assert abs(float(loss) - float(jloss)) <= 1e-6 * abs(float(jloss))
