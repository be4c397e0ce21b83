"""PyTorch port vs JAX reference: trained-controller serving (`serve/`).

The batcher's host-side contracts are the reference's tests
(`tests/test_serve.py`) run against the port's batcher.  The service is
held to the JAX `ControllerService` on the same parameters (carried across
with `multitask.load_jax_params`) and the same numpy observations, for
every registered scenario: actions and values within 1e-6 of max (the same
float32 dense layers; the two libraries' matmuls sum in another order).
Within the port it is bitwise: batch-1 rows equal batch-N rows, and a
`FleetRunner` checkpoint serves exactly its policy's `actor_mean` on the
same padded batch.  The `cuda`-marked tests hold the CUDA graphs on the
card.
"""
import json
import os

import jax
import numpy as np
import pytest
import torch

from repro import envs as jenvs
from repro import serve as jserve
from repro.fleet import multitask as jmt
from repro_torch import envs, fleet, resolve_device, serve
from repro_torch.core import checkpoints
from repro_torch.fleet import multitask
from repro_torch.fleet.pipeline import FleetRunnerConfig
from repro_torch.serve import (DEFAULT_BUCKETS, ControllerService,
                               RequestBatcher, bucket_for)
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

SCENARIOS = ("hit_les_reduced", "burgers_reduced")
SERVE_TOL = 1e-6


def _mcfg(names=SCENARIOS) -> multitask.MultiTaskConfig:
    return multitask.MultiTaskConfig.from_envs(
        [(n, envs.make(n)) for n in names])


def _rand_obs(mcfg, name: str, n: int, seed: int = 1) -> np.ndarray:
    head = mcfg.head(name)
    shape = (n, head.n_elements, *head.spatial, head.channels)
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _params(mcfg, seed: int = 0):
    return multitask.MultiTaskPolicy(
        mcfg, torch.Generator().manual_seed(seed)).params


def _service(names=SCENARIOS, **kwargs) -> ControllerService:
    mcfg = _mcfg(names)
    return ControllerService(_params(mcfg), mcfg, **kwargs)


def _padded(obs: np.ndarray, bucket: int) -> np.ndarray:
    """The batcher's padding: the last real row repeated up to `bucket`."""
    return np.concatenate([obs, np.repeat(obs[-1:], bucket - len(obs), 0)])


def _trained_checkpoint(tmpdir, n_iterations: int = 2):
    """A short reduced fleet run on the CPU that leaves a checkpoint after
    every iteration; returns the runner (its policy is the serving
    reference)."""
    runner = fleet.make_fleet_runner(
        SCENARIOS, total_envs=4, device="cpu", use_artifacts=False,
        run_cfg=FleetRunnerConfig(
            n_iterations=n_iterations, eval_every=100,
            checkpoint_every=1, async_checkpoint=False,
            checkpoint_dir=str(tmpdir), bank_size=4))
    runner.train(resume=False)
    assert checkpoints.latest_step(str(tmpdir)) == n_iterations
    return runner


# --- bucket selection (the reference's tests) -----------------------------------
def test_bucket_for_minimal_and_deterministic():
    for n in range(1, DEFAULT_BUCKETS[-1] + 1):
        b = bucket_for(n)
        assert b >= n
        assert all(s < n for s in DEFAULT_BUCKETS if s < b)
        assert bucket_for(n) == b
    assert bucket_for(3, (2, 5, 9)) == 5
    assert DEFAULT_BUCKETS == jserve.DEFAULT_BUCKETS


def test_bucket_for_rejects_out_of_range():
    for n in (0, -2, DEFAULT_BUCKETS[-1] + 1):
        with pytest.raises(ValueError):
            bucket_for(n)


# --- batcher (deterministic pins, the reference's tests) ------------------------
def _row(v: float, shape=(2, 3)) -> np.ndarray:
    return np.full(shape, v, np.float32)


def test_batcher_fifo_order_and_chunking():
    b = RequestBatcher(("a", "b"), buckets=(1, 2, 4), max_slots=32)
    uids = [b.submit("a", _row(i)) for i in range(6)]  # 6 > cap 4: chunks
    uid_b = b.submit("b", _row(99.0))
    batches = b.flush()
    assert [x.scenario for x in batches] == ["a", "a", "b"]
    assert batches[0].uids == tuple(uids[:4]) and batches[0].n_valid == 4
    assert batches[1].uids == tuple(uids[4:]) and batches[1].n_valid == 2
    assert batches[1].bucket == 2
    assert batches[2].uids == (uid_b,) and batches[2].bucket == 1
    for batch in batches:
        for i, uid in enumerate(batch.uids):
            np.testing.assert_array_equal(
                batch.obs[i],
                _row(float(uid)) if batch.scenario == "a" else _row(99.0))
    assert b.n_pending == 0 and b.flush() == []


def test_batcher_padding_repeats_last_real_row():
    b = RequestBatcher(("a",), buckets=(4,), max_slots=8)
    for i in range(3):
        b.submit("a", _row(float(i)))
    (batch,) = b.flush()
    assert batch.bucket == 4 and batch.n_valid == 3
    np.testing.assert_array_equal(batch.obs[3], batch.obs[2])
    assert len(batch.uids) == len(batch.slots) == 3


def test_batcher_slot_recycling_lowest_first():
    b = RequestBatcher(("a",), buckets=(1, 2, 4), max_slots=4)
    b.submit("a", _row(0))
    b.submit("a", _row(1))
    (batch,) = b.flush()
    assert batch.slots == (0, 1)
    b.release(0)
    assert b.n_free_slots == 3
    b.submit("a", _row(2))
    (batch2,) = b.flush()
    assert batch2.slots == (0,)
    with pytest.raises(ValueError):
        b.release(2)
    with pytest.raises(ValueError):
        b.release(99)


def test_batcher_backpressure_and_unknown_scenario():
    b = RequestBatcher(("a",), buckets=(1, 2), max_slots=2)
    b.submit("a", _row(0))
    b.submit("a", _row(1))
    with pytest.raises(RuntimeError, match="no free request slots"):
        b.submit("a", _row(2))
    with pytest.raises(KeyError, match="unknown scenario"):
        b.submit("nope", _row(0))
    (batch,) = b.flush()
    for s in batch.slots:
        b.release(s)
    assert b.submit("a", _row(3)) == 2


def test_batcher_rejects_bad_buckets():
    for bad in ((), (2, 1), (1, 1, 2), (0, 1)):
        with pytest.raises((ValueError, IndexError)):
            RequestBatcher(("a",), buckets=bad)


# --- batcher (hypothesis properties, the reference's) ----------------------------
def test_batcher_interleaving_properties():
    """Arbitrary submit interleavings: per-scenario FIFO uid order survives
    batching, every request appears exactly once, bucket selection is the
    pure minimal bucket; the same batches as the reference's batcher."""
    pytest.importorskip("hypothesis")
    from hypothesis import given, settings, strategies as st

    @settings(max_examples=150, deadline=None)
    @given(plan=st.lists(st.sampled_from(["a", "b", "c"]),
                         min_size=1, max_size=40))
    def prop(plan):
        b = RequestBatcher(("a", "b", "c"), buckets=(1, 2, 4, 8),
                           max_slots=64)
        jb = jserve.RequestBatcher(("a", "b", "c"), buckets=(1, 2, 4, 8),
                                   max_slots=64)
        submitted = {"a": [], "b": [], "c": []}
        for i, scen in enumerate(plan):
            submitted[scen].append(b.submit(scen, _row(float(i))))
            jb.submit(scen, _row(float(i)))
        batches, jbatches = b.flush(), jb.flush()
        seen = {"a": [], "b": [], "c": []}
        for batch, jbatch in zip(batches, jbatches, strict=True):
            assert batch.bucket == bucket_for(batch.n_valid, (1, 2, 4, 8))
            assert len(batch.uids) == batch.n_valid <= batch.bucket
            assert batch.obs.shape[0] == batch.bucket
            assert (batch.scenario, batch.uids, batch.slots) == \
                (jbatch.scenario, jbatch.uids, jbatch.slots)
            np.testing.assert_array_equal(batch.obs, jbatch.obs)
            seen[batch.scenario].extend(batch.uids)
        assert seen == submitted
        assert b.n_free_slots == 64 - len(plan)

    prop()


def test_batcher_slot_pool_bounded_property():
    """Any submit/flush+release schedule keeps outstanding slots <=
    max_slots, refuses loudly at the bound, and recycles released ids."""
    pytest.importorskip("hypothesis")
    from hypothesis import given, settings, strategies as st

    @settings(max_examples=100, deadline=None)
    @given(ops=st.lists(st.sampled_from(["submit", "drain"]),
                        min_size=1, max_size=30))
    def prop(ops):
        cap = 4
        b = RequestBatcher(("a",), buckets=(1, 2, 4), max_slots=cap)
        outstanding = 0
        for op in ops:
            if op == "submit":
                if outstanding == cap:
                    with pytest.raises(RuntimeError):
                        b.submit("a", _row(0.0))
                else:
                    b.submit("a", _row(0.0))
                    outstanding += 1
            else:
                for batch in b.flush():
                    for s in batch.slots:
                        b.release(s)
                        outstanding -= 1
            assert b.n_free_slots == cap - outstanding
        all_slots = [s for batch in b.flush() for s in batch.slots]
        assert all(0 <= s < cap for s in all_slots)

    prop()


def test_serve_batch1_equals_batchN_property():
    """Bitwise, on the CPU: a row served alone (bucket 1) equals the same
    row served in any batch of up to 8 (buckets 1-8, padded)."""
    pytest.importorskip("hypothesis")
    from hypothesis import given, settings, strategies as st

    svc = _service(("burgers_reduced",), buckets=(1, 2, 4, 8), max_slots=32)
    obs = _rand_obs(svc.mcfg, "burgers_reduced", 8)
    singles = np.stack([svc.serve_batch("burgers_reduced", obs[i:i + 1])[0]
                        for i in range(8)])

    @settings(max_examples=25, deadline=None)
    @given(rows=st.lists(st.integers(min_value=0, max_value=7),
                         min_size=1, max_size=8))
    def prop(rows):
        got = svc.serve_batch("burgers_reduced", obs[rows])
        np.testing.assert_array_equal(got, singles[rows])

    prop()


def test_actor_mean_gradient_is_finite_at_saturated_logits():
    """The logistic of `actor_mean` at logits of +-200 (float32 and bf16):
    the action sits at its bound and the gradient of every parameter is
    finite (a `1 / (1 + exp(-x))` gives NaN below about -88.7, where exp
    overflows), and equals torch.sigmoid's to 1e-6 relative on logits in
    [-30, 30]."""
    x = torch.tensor([-200.0, -100.0, -88.8, 0.0, 88.8, 100.0, 200.0])
    for dtype in (torch.float32, torch.bfloat16):
        xs = x.to(dtype).requires_grad_()
        y = multitask._logistic(xs)
        (g,) = torch.autograd.grad(y.sum(), xs)
        assert torch.isfinite(y).all() and torch.isfinite(g).all(), dtype
        assert y[0] == 0 and y[-1] == 1 and g[0] == 0 and g[-1] == 0
    grid = torch.linspace(-30.0, 30.0, 1201, dtype=torch.float64)
    want = torch.sigmoid(grid)
    got = multitask._logistic(grid.float()).double()
    assert torch.allclose(got, want, rtol=1e-6, atol=0)

    mcfg = _mcfg(("burgers_reduced",))
    params = _params(mcfg)
    head = params["heads"]["burgers_reduced"]
    with torch.no_grad():  # every logit is the bias: +200, then -200
        head["actor_out"]["w"].zero_()
    obs = torch.from_numpy(_rand_obs(mcfg, "burgers_reduced", 2))
    leaves = [p.requires_grad_() for p in params.parameters()]
    for sign in (1.0, -1.0):
        with torch.no_grad():
            head["actor_out"]["b"].copy_(sign * 200.0)
        mean = multitask.actor_mean(params, mcfg, "burgers_reduced", obs)
        h = mcfg.head("burgers_reduced")
        assert torch.all(mean == (h.act_high if sign > 0 else h.act_low))
        grads = torch.autograd.grad(mean.sum(), leaves, allow_unused=True)
        assert all(torch.isfinite(g).all() for g in grads if g is not None)


# --- service against the reference ---------------------------------------------
def test_service_matches_reference_every_registered_scenario():
    """The port's service and the JAX `ControllerService` on the same
    parameters and observations, every registered scenario, at 3 requests
    (bucket 4, one pad row) and 5 (bucket 8 of the ladder 1, 2, 4, 8):
    actions and values within 1e-6 of max."""
    names = envs.registered()
    assert set(names) == set(jenvs.registered())
    jmcfg = jmt.MultiTaskConfig.from_envs(
        [(n, jenvs.make(n)) for n in names])
    jparams = jmt.init(jax.random.PRNGKey(7), jmcfg)
    mcfg = _mcfg(names)
    policy = multitask.MultiTaskPolicy(mcfg)
    multitask.load_jax_params(policy, jax.tree.map(np.asarray, jparams))
    svc = ControllerService(policy.params, mcfg, buckets=(1, 2, 4, 8),
                            max_slots=16)
    jsvc = jserve.ControllerService(jparams, jmcfg, buckets=(1, 2, 4, 8),
                                    max_slots=16)
    for name in names:
        assert mcfg.head(name) == multitask.HeadSpec(**vars(jmcfg.head(name)))
        for n in (3, 5):
            obs = _rand_obs(mcfg, name, n, seed=11)
            uids = [svc.submit(name, row) for row in obs]
            juids = [jsvc.submit(name, row) for row in obs]
            got, want = svc.flush(), jsvc.flush()
            acts = np.stack([got[u].action for u in uids])
            jacts = np.stack([want[u].action for u in juids])
            vals = np.array([got[u].value for u in uids])
            jvals = np.array([want[u].value for u in juids])
            assert acts.dtype == np.float32 and acts.shape == jacts.shape
            for a, b in ((acts, jacts), (vals, jvals)):
                assert np.abs(a - b).max() <= SERVE_TOL * np.abs(b).max(), \
                    name
    assert svc.stats() == jsvc.stats()


def test_served_actions_are_actor_mean_on_the_padded_batch():
    """Through submit/pad/dispatch/slice, bitwise `actor_mean` of the same
    parameters on the padded batch, for every registered scenario."""
    names = envs.registered()
    mcfg = _mcfg(names)
    params = _params(mcfg, seed=7)
    svc = ControllerService(params, mcfg, buckets=(1, 2, 4), max_slots=16)
    for name in names:
        obs = _rand_obs(mcfg, name, 3, seed=11)
        got = svc.serve_batch(name, obs)
        with torch.no_grad():
            want = multitask.actor_mean(params, mcfg, name, torch.from_numpy(
                _padded(obs, 4)))[:3].numpy()
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, want)


def test_flush_results_and_telemetry():
    svc = _service(buckets=(1, 2, 4), max_slots=16)
    uids = {}
    for name in SCENARIOS:
        for i in range(3):
            uids[svc.submit(name, _rand_obs(svc.mcfg, name, 1, seed=i)[0])] \
                = name
    results = svc.flush()
    assert set(results) == set(uids)
    for uid, res in results.items():
        assert res.uid == uid and res.scenario == uids[uid]
        head = svc.mcfg.head(res.scenario)
        assert res.action.shape == (head.n_elements,)
        assert np.isfinite(res.action).all() and np.isfinite(res.value)
    stats = svc.stats()
    for name in SCENARIOS:  # 3 requests -> one padded bucket-4 batch each
        assert stats[name] == {"requests": 3, "batches": 1}
    assert svc.flush() == {}
    assert svc.batcher.n_free_slots == 16
    assert svc.captures == {}  # the CPU runs eagerly


def test_submit_shape_checked_at_the_edge():
    svc = _service()
    good = _rand_obs(svc.mcfg, "burgers_reduced", 1)[0]
    with pytest.raises(ValueError, match="observation shape"):
        svc.submit("burgers_reduced", good[:-1])
    with pytest.raises(KeyError):
        svc.submit("not_registered", good)
    assert svc.batcher.n_pending == 0


def test_service_owns_its_parameters():
    """The service serves a copy: training the policy on afterwards does not
    move what it serves (a captured graph reads its params by address)."""
    mcfg = _mcfg(("burgers_reduced",))
    params = _params(mcfg)
    svc = ControllerService(params, mcfg)
    obs = _rand_obs(mcfg, "burgers_reduced", 2)
    before = svc.serve_batch("burgers_reduced", obs)
    with torch.no_grad():
        for p in params.parameters():
            p.add_(1.0)
    np.testing.assert_array_equal(svc.serve_batch("burgers_reduced", obs),
                                  before)


# --- checkpoint -> serve ---------------------------------------------------------
def test_checkpoint_serve_bit_identical_to_trained_policy(tmp_path):
    """Reduced fleet run on the CPU -> checkpoint -> `load_service`: the
    restored params ARE the trained params, and the served actions equal
    the runner's `actor_mean` on the same padded batch, bit for bit."""
    runner = _trained_checkpoint(tmp_path / "ckpt")
    svc = serve.load_service(str(tmp_path / "ckpt"), device="cpu",
                             max_slots=16)
    assert svc.scenarios == SCENARIOS
    trained = dict(runner.policy.params.named_parameters())
    restored = dict(svc.params.named_parameters())
    assert trained.keys() == restored.keys()
    for name, p in trained.items():
        assert torch.equal(p.detach(), restored[name]), name
    for name in SCENARIOS:
        obs = _rand_obs(svc.mcfg, name, 3, seed=5)
        got = svc.serve_batch(name, obs)
        with torch.no_grad():
            want = runner.policy.head(name).actor_mean(
                torch.from_numpy(_padded(obs, 4)))[:3].numpy()
        np.testing.assert_array_equal(got, want)


def test_load_policy_provenance_and_specific_step(tmp_path):
    """A specific step and the newest; provenance from the meta; the
    optimizer and broker leaves are never read."""
    runner = _trained_checkpoint(tmp_path / "ckpt")
    ckpt = str(tmp_path / "ckpt")
    policy = serve.load_policy(ckpt, 1, device="cpu")
    assert policy.step == 1
    assert policy.scenarios == SCENARIOS
    assert policy.meta["scenarios"] == list(SCENARIOS)
    assert policy.meta["d_embed"] == policy.mcfg.d_embed == 32
    assert policy.meta["iteration"] == 1
    newest = serve.load_policy(ckpt, device="cpu")
    assert newest.step == 2
    a = dict(newest.params.named_parameters())
    for name, p in runner.policy.params.named_parameters():
        assert torch.equal(p.detach(), a[name])
    assert not any(p.requires_grad for p in newest.params.parameters())
    # drop every non-params leaf file: the loader still restores
    step_dir = os.path.join(ckpt, "step_00000002")
    with open(os.path.join(step_dir, "manifest.json")) as f:
        manifest = json.load(f)
    for i, key in enumerate(manifest["keys"]):
        if not key.startswith("['params']"):
            os.remove(os.path.join(step_dir, f"{i}.npy"))
    serve.load_policy(ckpt, device="cpu")
    with pytest.raises(FileNotFoundError):
        serve.load_policy(str(tmp_path / "empty"), device="cpu")


def _manifest_path(ckpt_dir: str) -> str:
    step = checkpoints.latest_step(ckpt_dir)
    return os.path.join(ckpt_dir, f"step_{step:08d}", "manifest.json")


def test_loader_infers_trunk_from_manifest_without_meta_fields(tmp_path):
    """A checkpoint whose meta lacks d_embed/n_shared_layers stays loadable:
    the loader reads the trunk off the manifest's actor-trunk keys."""
    runner = fleet.make_fleet_runner(
        SCENARIOS, total_envs=4, device="cpu", use_artifacts=False,
        run_cfg=FleetRunnerConfig(
            n_iterations=1, eval_every=100, checkpoint_every=1,
            async_checkpoint=False, checkpoint_dir=str(tmp_path), bank_size=4,
            d_embed=16, n_shared_layers=3))
    runner.train(resume=False)
    path = _manifest_path(str(tmp_path))
    with open(path) as f:
        manifest = json.load(f)
    declared = (manifest["meta"].pop("d_embed"),
                manifest["meta"].pop("n_shared_layers"))
    assert declared == (16, 3)
    with open(path, "w") as f:
        json.dump(manifest, f)
    policy = serve.load_policy(str(tmp_path), device="cpu")
    assert (policy.mcfg.d_embed, policy.mcfg.n_shared_layers) == declared


def test_loader_rejects_mismatched_trunk_meta(tmp_path):
    _trained_checkpoint(tmp_path / "ckpt", n_iterations=1)
    path = _manifest_path(str(tmp_path / "ckpt"))
    with open(path) as f:
        manifest = json.load(f)
    manifest["meta"]["d_embed"] = 9999
    with open(path, "w") as f:
        json.dump(manifest, f)
    with pytest.raises(checkpoints.IntegrityError, match="d_embed"):
        serve.load_policy(str(tmp_path / "ckpt"), device="cpu")


def test_loader_rejects_non_fleet_checkpoint(tmp_path):
    checkpoints.save(str(tmp_path), 1,
                     {"params": {"w": np.zeros((2, 2), np.float32)}},
                     meta={"scenarios": list(SCENARIOS)})
    with pytest.raises(checkpoints.IntegrityError, match="actor"):
        serve.load_policy(str(tmp_path), device="cpu")
    checkpoints.save(str(tmp_path), 2,
                     {"params": {"w": np.zeros((2, 2), np.float32)}})
    with pytest.raises(checkpoints.IntegrityError, match="scenarios"):
        serve.load_policy(str(tmp_path), device="cpu")


def test_loader_rejects_leaves_that_do_not_fit_the_template(tmp_path):
    """A head leaf of another shape, or a missing one, raises."""
    mcfg = _mcfg(("burgers_reduced",))
    params = dict(multitask.MultiTaskPolicy(mcfg).named_parameters())
    meta = {"scenarios": ["burgers_reduced"], "d_embed": 32,
            "n_shared_layers": 2}
    bad = dict(params)
    bad["params.heads.burgers_reduced.actor_out.w"] = torch.zeros((32, 2))
    checkpoints.save(str(tmp_path), 1, {"params": bad}, meta=meta)
    with pytest.raises(checkpoints.IntegrityError, match="actor_out"):
        serve.load_policy(str(tmp_path), device="cpu")
    del bad["params.heads.burgers_reduced.actor_out.w"]
    checkpoints.save(str(tmp_path), 2, {"params": bad}, meta=meta)
    with pytest.raises(checkpoints.IntegrityError, match="template"):
        serve.load_policy(str(tmp_path), device="cpu")


def test_serving_entry_points_need_a_gpu_unless_asked(tmp_path, monkeypatch):
    _trained_checkpoint(tmp_path, n_iterations=1)
    if torch.cuda.is_available():
        assert resolve_device(None).type == "cuda"
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.load_service(str(tmp_path))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.load_policy(str(tmp_path))


# --- the card --------------------------------------------------------------------
def _need_gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the serving graphs are CUDA graphs")


@pytest.mark.cuda
def test_cuda_graph_served_actions_equal_eager_actor_mean(tmp_path):
    """On the card: a fleet checkpoint served through one CUDA graph per
    (scenario, bucket) gives `actor_mean` of the same params on the same
    padded batch (eager, on the card) bit for bit, padding included; a
    second pass over the same buckets captures nothing; the counters equal
    the requests and batches sent."""
    _need_gpu()
    runner = _trained_checkpoint(tmp_path)
    svc = serve.load_service(str(tmp_path))
    assert svc.device.type == "cuda" and svc.capture
    sent = {name: [0, 0] for name in SCENARIOS}
    for _ in range(2):
        for name in SCENARIOS:
            for n in (1, 2, 3, 5, 16, 37):
                obs = _rand_obs(svc.mcfg, name, n, seed=n)
                for row in obs:
                    svc.submit(name, row)
                for batch in svc.batcher.flush():
                    acts, vals = svc.dispatch(batch)
                    x = torch.from_numpy(batch.obs).cuda()
                    with torch.no_grad():
                        want_a = multitask.actor_mean(
                            runner.policy.params.cuda(), svc.mcfg, name, x)
                        want_v = multitask.value(
                            runner.policy.params.cuda(), svc.mcfg, name, x)
                    assert torch.equal(acts, want_a)
                    assert torch.equal(vals, want_v)
                    for slot in batch.slots:
                        svc.batcher.release(slot)
                    sent[name][0] += batch.n_valid
                    sent[name][1] += 1
    assert svc.captures == {(name, b): 1 for name in SCENARIOS
                            for b in DEFAULT_BUCKETS}
    assert svc.stats() == {n: {"requests": r, "batches": b}
                           for n, (r, b) in sent.items()}
    eager = serve.ControllerService.from_policy(
        serve.load_policy(str(tmp_path)), capture=False)
    obs = _rand_obs(svc.mcfg, "burgers_reduced", 7)
    np.testing.assert_array_equal(svc.serve_batch("burgers_reduced", obs),
                                  eager.serve_batch("burgers_reduced", obs))
    assert eager.captures == {}
