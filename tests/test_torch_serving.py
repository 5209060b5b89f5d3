"""The port's continuous-batching runtime against the reference on
``reduced_config(qwen3-0.6b)`` in float32, from the same JAX-initialised
parameters (carried over by ``repro_torch.convert``).

  * ``PagePool``: the same grow/release traces leave the same block
    tables and free lists as the reference's allocator, and the
    invariants hold;
  * ``write_prefill``: the same dense prefill cache scatters into pools
    equal to the reference's, bit for bit;
  * one ``make_paged_serve_step``: logits equal to JAX's (1e-4, fp32 on
    both sides in another summation order) under both backend pairs, with
    one inactive slot whose would-be write collides with an active one,
    and an all-inactive step leaves every pool byte unchanged;
  * ``ContinuousBatchingEngine.run`` on the same ``poisson_trace``:
    outputs, evictions and decode steps identical to JAX's, and tokens
    identical to the port's static ``generate``;
  * the cases of tests/test_serving.py for qwen3-0.6b: staggered
    arrivals, evict/re-admit, admission beyond capacity queues, finished
    at admission, launches flat under churn, and a lone sequence that
    exhausts the pool raising.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jcore
from repro.configs import get_config as j_get_config
from repro.configs import reduced_config as j_reduced_config
from repro.models import LanguageModel as JLanguageModel
from repro.models.attention import PageSpec as JPageSpec
from repro.runtime import pages as j_pages
from repro.runtime.batching import (
    ContinuousBatchingEngine as JContinuousBatchingEngine)
from repro.runtime.batching import poisson_trace as j_poisson_trace
from repro.runtime.steps import forward as j_forward
from repro.runtime.steps import make_paged_serve_step as j_make_step
from repro.runtime.steps import make_prefill_step as j_make_prefill_step

from repro_torch.configs import get_config, reduced_config
from repro_torch.convert import params_from_jax_numpy
from repro_torch.core import engine, use
from repro_torch.launch.serve import generate, main as serve_main, \
    run_continuous, static_oracle
from repro_torch.models import LanguageModel
from repro_torch.models.attention import KVCache, PageSpec
from repro_torch.runtime.batching import (ContinuousBatchingEngine, Request,
                                          poisson_trace)
from repro_torch.runtime.pages import (OutOfPages, PagePool,
                                       init_serving_cache, pages_for,
                                       refresh_tables, write_prefill)
from repro_torch.runtime.steps import make_paged_serve_step, \
    make_prefill_step

ATOL = 1e-4
BACKENDS = [("torch", "xla"), ("engine", "pallas")]


@pytest.fixture(scope="module")
def setup():
    jcfg = j_reduced_config(j_get_config("qwen3-0.6b"))
    cfg = reduced_config(get_config("qwen3-0.6b"))
    params = JLanguageModel.init(jax.random.PRNGKey(0), jcfg)
    state = params_from_jax_numpy(jax.tree.map(np.asarray, params), cfg,
                                  device="cpu")
    model = LanguageModel(cfg, device="cpu", seed=1)
    model.load_state_dict(state, strict=True)
    return jcfg, cfg, params, model


# ---------------------------------------------------------------------------
# the allocator
# ---------------------------------------------------------------------------

POOL_CASES = [  # tests/test_schedule.py's allocator traces
    ([("grow", 0, 9), ("grow", 1, 5), ("release", 0, 0),
      ("grow", 2, 12), ("release", 1, 0), ("grow", 0, 3)], 4, 6, 3),
    ([("grow", 0, 50)], 4, 2, 1),
    ([("grow", 0, 8), ("grow", 0, 8), ("release", 0, 0),
      ("release", 0, 0)], 8, 2, 1),
    ([("grow", 1, 7), ("grow", 0, 2), ("grow", 1, 9), ("grow", 2, 40),
      ("release", 1, 0), ("grow", 2, 13)], 2, 10, 3),
]


@pytest.mark.parametrize("ops,page_size,num_pages,num_slots", POOL_CASES)
def test_page_pool_matches_reference(ops, page_size, num_pages, num_slots):
    pool = PagePool(PageSpec(num_pages, page_size, num_pages), num_slots)
    jpool = j_pages.PagePool(JPageSpec(num_pages, page_size, num_pages),
                             num_slots)
    lengths = [0] * num_slots
    for kind, slot, length in ops:
        outcome = []
        for p in (pool, jpool):
            try:
                outcome.append(p.grow(slot, length) if kind == "grow"
                               else p.release(slot))
            except (OutOfPages, j_pages.OutOfPages, ValueError) as e:
                outcome.append(type(e).__name__)
        assert outcome[0] == outcome[1], (kind, slot, length, outcome)
        if kind == "grow" and isinstance(outcome[0], list):
            lengths[slot] = max(lengths[slot], length)
        elif kind == "release":
            lengths[slot] = 0
        pool.check_invariants(lengths)
        np.testing.assert_array_equal(pool.tables, jpool.tables)
        assert pool.free_pages == jpool.free_pages
        for i in range(num_slots):
            assert pool.owned_pages(i) == jpool.owned_pages(i)
            assert pool.slot_blocks(i) == pages_for(lengths[i], page_size)


def test_page_pool_invariants_catch_double_ownership():
    pool = PagePool(PageSpec(4, 2, 4), 2)
    pool.grow(0, 3)
    pool._owned[1].append(pool._owned[0][0])
    with pytest.raises(AssertionError, match="conservation"):
        pool.check_invariants()


# ---------------------------------------------------------------------------
# write_prefill and one paged decode step
# ---------------------------------------------------------------------------

SPEC = (12, 4, 6)            # num_pages, page_size, max_blocks
PROMPT_LENS = [6, None, 9]   # slot 1 stays inactive


def _prompts(cfg):
    rng = np.random.default_rng(0)
    return [None if L is None else
            rng.integers(0, cfg.vocab_size, L).astype(np.int32)
            for L in PROMPT_LENS]


def _jax_state(jcfg, params):
    """The reference's serving cache with the prompts prefilled, its
    allocator, and each slot's prefill argmax."""
    spec = JPageSpec(*SPEC)
    pool = j_pages.PagePool(spec, len(PROMPT_LENS))
    cache = j_pages.init_serving_cache(jcfg, len(PROMPT_LENS), spec)
    toks, denses = [], []
    for slot, prompt in enumerate(_prompts(jcfg)):
        if prompt is None:
            toks.append(0)
            continue
        ids = pool.grow(slot, len(prompt))
        logits, dense = j_make_prefill_step(jcfg, len(prompt))(
            params, {"tokens": jnp.asarray(prompt)[None]})
        denses.append((slot, len(prompt), ids, dense))
        cache = j_pages.write_prefill(cache, dense, slot=slot,
                                      length=len(prompt), page_ids=ids,
                                      page_size=spec.page_size)
        toks.append(int(jnp.argmax(logits[0])))
    for slot, L in enumerate(PROMPT_LENS):  # room for the decode write
        if L:
            pool.grow(slot, L + 1)
    cache = j_pages.refresh_tables(cache, pool.device_tables())
    return cache, pool, toks, denses


def _port_state(model):
    spec = PageSpec(*SPEC)
    pool = PagePool(spec, len(PROMPT_LENS))
    cache = init_serving_cache(model, len(PROMPT_LENS), spec)
    toks = []
    for slot, prompt in enumerate(_prompts(model.cfg)):
        if prompt is None:
            toks.append(0)
            continue
        ids = pool.grow(slot, len(prompt))
        logits, dense = make_prefill_step(model, len(prompt))(
            {"tokens": torch.from_numpy(prompt).long()[None]})
        write_prefill(cache, dense, slot=slot, length=len(prompt),
                      page_ids=ids, page_size=spec.page_size)
        toks.append(int(torch.argmax(logits[0])))
    for slot, L in enumerate(PROMPT_LENS):
        if L:
            pool.grow(slot, L + 1)
    refresh_tables(cache, pool.tables)
    return cache, pool, toks


def _jax_pools(cache):
    """Per-layer (k, v, tables) numpy arrays of the reference's cache."""
    leaf = cache["groups"]["b0"]
    return [(np.asarray(leaf.k[i]), np.asarray(leaf.v[i]),
             np.asarray(leaf.tables[i])) for i in range(leaf.k.shape[0])]


def test_write_prefill_pools_equal_reference(setup):
    """The reference's own dense prefill caches, written by the port's
    write_prefill (slot by slot, over pages a released slot left behind),
    give the reference's pools bit for bit."""
    jcfg, cfg, params, model = setup
    with jcore.use(backend="xla"):
        jcache, jpool, _, denses = _jax_state(jcfg, params)
    cache = init_serving_cache(model, len(PROMPT_LENS), PageSpec(*SPEC))
    for layer in cache:  # stale values a released slot would leave behind
        layer.k.fill_(7.0)
        layer.v.fill_(-7.0)
    jfresh = j_pages.init_serving_cache(jcfg, len(PROMPT_LENS),
                                        JPageSpec(*SPEC))
    jfresh = jax.tree.map(lambda x: jnp.full_like(x, 7.0) if x.ndim == 5
                          else x, jfresh)
    jfresh["groups"]["b0"] = jfresh["groups"]["b0"]._replace(
        v=-jfresh["groups"]["b0"].v)
    for slot, L, ids, dense in denses:
        d = dense["groups"]["b0"]
        port_dense = [KVCache(torch.tensor(np.asarray(d.k[i])),
                              torch.tensor(np.asarray(d.v[i])),
                              torch.tensor(np.asarray(d.pos[i])))
                      for i in range(d.k.shape[0])]
        write_prefill(cache, port_dense, slot=slot, length=L, page_ids=ids,
                      page_size=SPEC[1])
        jfresh = j_pages.write_prefill(jfresh, dense, slot=slot, length=L,
                                       page_ids=ids, page_size=SPEC[1])
    refresh_tables(cache, jpool.tables)
    jfresh = j_pages.refresh_tables(jfresh, jpool.device_tables())
    for layer, (k, v, tables) in zip(cache, _jax_pools(jfresh)):
        np.testing.assert_array_equal(layer.k.numpy(), k)
        np.testing.assert_array_equal(layer.v.numpy(), v)
        np.testing.assert_array_equal(layer.tables.numpy(), tables)


@pytest.mark.parametrize("backend,j_backend", BACKENDS)
def test_paged_step_matches_reference(setup, backend, j_backend):
    jcfg, cfg, params, model = setup
    with jcore.use(backend=j_backend):
        jcache, jpool, jtoks, _ = _jax_state(jcfg, params)
    with use(backend=backend, device="cpu"):
        cache, pool, toks = _port_state(model)
    assert toks == jtoks
    np.testing.assert_array_equal(pool.tables, jpool.tables)
    for layer, (k, v, _) in zip(cache, _jax_pools(jcache)):
        np.testing.assert_allclose(layer.k.numpy(), k, atol=ATOL, rtol=ATOL)
        np.testing.assert_allclose(layer.v.numpy(), v, atol=ATOL, rtol=ATOL)

    lengths = np.asarray([L or 0 for L in PROMPT_LENS], np.int32)
    active = np.asarray([L is not None for L in PROMPT_LENS])
    tokens = np.asarray(toks, np.int32)[:, None]
    positions = jnp.where(active, lengths, -1).astype(jnp.int32)[:, None]
    with jcore.use(backend=j_backend):
        want, jnew, _ = j_forward(jcfg, params, {"tokens": jnp.asarray(tokens)},
                                  cache=jcache, positions=positions)
        jtok, _, jlen = jax.jit(j_make_step(jcfg))(
            params, jcache, jnp.asarray(tokens), jnp.asarray(lengths),
            jnp.asarray(active))
    with use(backend=backend, device="cpu"), torch.no_grad():
        got, _, _ = model.apply(
            torch.from_numpy(tokens).long(),
            positions=torch.from_numpy(np.where(active, lengths, -1)
                                       .astype(np.int32))[:, None],
            cache=cache)
        # The step writes the same K/V again: the same pools either way.
        tok, _, new_len = make_paged_serve_step(model)(
            cache, torch.from_numpy(tokens).long(),
            torch.from_numpy(lengths).long(), torch.from_numpy(active))
    np.testing.assert_allclose(got[active].numpy(),
                               np.asarray(want)[active], atol=ATOL, rtol=ATOL)
    np.testing.assert_array_equal(tok[active, 0].numpy(),
                                  np.asarray(jtok)[active, 0])
    np.testing.assert_array_equal(new_len.numpy(), np.asarray(jlen))
    # The reference drops the inactive slot's write; the port's pools
    # agree with its pools (the new rows within ATOL, all else exact).
    for layer, (k, v, _) in zip(cache, _jax_pools(jnew)):
        np.testing.assert_allclose(layer.k.numpy(), k, atol=ATOL, rtol=ATOL)
        np.testing.assert_allclose(layer.v.numpy(), v, atol=ATOL, rtol=ATOL)


def test_inactive_slot_leaves_the_pools_unchanged(setup):
    """An inactive slot's zeroed block table points at page 0, offset 0,
    where an active slot writes its new token this step: the active write
    wins, and every byte no active slot writes is unchanged."""
    _, cfg, _, model = setup
    spec = PageSpec(num_pages=4, page_size=4, max_blocks=3)
    cache = init_serving_cache(model, 3, spec)
    gen = torch.Generator().manual_seed(0)
    # slot 0 at length 4 writes position 4: block 1 = page 0, offset 0
    tables = np.asarray([[1, 0, 0], [0, 0, 0], [2, 0, 0]], np.int32)
    refresh_tables(cache, tables)
    step = make_paged_serve_step(model)
    tokens = torch.tensor([[3], [5], [7]])
    lengths = torch.tensor([4, 0, 2])
    for backend in ("engine", "torch"):
        for layer in cache:
            layer.k.copy_(torch.randn(layer.k.shape, generator=gen))
            layer.v.copy_(torch.randn(layer.v.shape, generator=gen))
        before = [(c.k.clone(), c.v.clone()) for c in cache]
        with use(backend=backend, device="cpu"):
            step(cache, tokens, lengths, torch.tensor([False, False, False]))
        for c, (k, v) in zip(cache, before):
            assert torch.equal(c.k, k) and torch.equal(c.v, v)
        # slot 0 and slot 2 active, slot 1 not: compare with a step in
        # which slot 1 does not exist at all.
        solo = init_serving_cache(model, 2, spec)
        for s, c in zip(solo, cache):
            s.k.copy_(c.k)
            s.v.copy_(c.v)
        refresh_tables(solo, tables[[0, 2]])
        with use(backend=backend, device="cpu"):
            step(cache, tokens, lengths, torch.tensor([True, False, True]))
            step(solo, tokens[[0, 2]], lengths[[0, 2]],
                 torch.tensor([True, True]))
        for c, s, (k, v) in zip(cache, solo, before):
            assert torch.equal(c.k, s.k) and torch.equal(c.v, s.v)
            changed = (c.k != k).any(-1).any(-1)
            assert changed[0, 0] and changed[2, 2] and changed.sum() == 2


# ---------------------------------------------------------------------------
# the scheduler
# ---------------------------------------------------------------------------

def _static_tokens(model, req):
    out = generate(model, torch.from_numpy(req.prompt)[None], req.max_new)
    return out["tokens"][0].numpy()


def _assert_identical(model, reqs, result):
    for r in reqs:
        want = _static_tokens(model, r)
        got = result["outputs"][r.rid]
        assert np.array_equal(want, got), (
            f"rid={r.rid} diverged: static={want.tolist()} "
            f"continuous={got.tolist()}")


RUN_CASES = {  # tests/test_serving.py's staggered and evict/re-admit cases
    "staggered": (dict(num_requests=5, rate=0.5, prompt_lens=(6, 12),
                       max_new=(2, 7), seed=3), 3, (24, 8, 6)),
    "evict": (dict(num_requests=4, rate=2.0, prompt_lens=10, max_new=8,
                   seed=1), 3, (9, 4, 8)),
}


def test_poisson_trace_equals_reference():
    kw = dict(num_requests=12, rate=1.0, prompt_lens=(96, 256),
              max_new=(16, 48), vocab_size=151936, seed=0)
    for r, jr in zip(poisson_trace(**kw), j_poisson_trace(**kw)):
        assert (r.rid, r.max_new, r.arrival) == (jr.rid, jr.max_new,
                                                 jr.arrival)
        np.testing.assert_array_equal(r.prompt, jr.prompt)


@pytest.mark.parametrize("case", sorted(RUN_CASES))
@pytest.mark.parametrize("backend", ["engine", "torch"])
def test_continuous_run_matches_reference(setup, case, backend):
    jcfg, cfg, params, model = setup
    trace, slots, spec = RUN_CASES[case]
    jreqs = j_poisson_trace(vocab_size=cfg.vocab_size, **trace)
    want = JContinuousBatchingEngine(jcfg, params, num_slots=slots,
                                     spec=JPageSpec(*spec)).run(jreqs)
    reqs = poisson_trace(vocab_size=cfg.vocab_size, **trace)
    with use(backend=backend, device="cpu"):
        serving = ContinuousBatchingEngine(model, num_slots=slots,
                                           spec=PageSpec(*spec))
        got = serving.run(reqs)
        assert sorted(got["outputs"]) == sorted(want["outputs"])
        for rid, toks in want["outputs"].items():
            np.testing.assert_array_equal(got["outputs"][rid], toks)
        assert got["evictions"] == want["evictions"]
        for key in ("requests", "total_tokens", "decode_steps", "evictions"):
            assert got["metrics"][key] == want["metrics"][key], key
        if case == "evict":
            assert got["metrics"]["evictions"] > 0, \
                "case must exercise the eviction path"
        serving.pool.check_invariants([0] * serving.num_slots)
        assert serving.pool.free_pages == spec[0]
        _assert_identical(model, reqs, got)


def test_admission_beyond_capacity_queues(setup):
    _, cfg, _, model = setup
    reqs = [Request(rid=i, prompt=np.full(8, 7 + i, np.int32), max_new=4)
            for i in range(6)]
    with use(backend="engine", device="cpu"):
        serving = ContinuousBatchingEngine(model, num_slots=2,
                                           spec=PageSpec(6, 4, 3))
        result = serving.run(reqs)
        assert sorted(result["outputs"]) == [r.rid for r in reqs]
        assert all(len(t) == 4 for t in result["outputs"].values())
        assert serving.pool.free_pages == 6
        _assert_identical(model, reqs, result)


def test_finished_at_admission_is_noop(setup):
    _, cfg, _, model = setup
    req = Request(rid=0, prompt=np.arange(1, 9, dtype=np.int32), max_new=1)
    with use(backend="engine", device="cpu"):
        engine.reset_stats()
        serving = ContinuousBatchingEngine(model, num_slots=2,
                                           spec=PageSpec(8, 4, 4))
        result = serving.run([req])
        launches = engine.stats().get("flash_decode", {}).get("launches", 0)
    assert result["metrics"]["decode_steps"] == 0
    assert launches == 0, "finished sequence must not launch decode"
    assert len(result["outputs"][0]) == 1
    assert serving.pool.free_pages == 8


def test_launches_flat_under_churn(setup):
    """A churning batch re-enters ONE cached decode state: one plan and
    one kernel-state build, and exactly one flash_decode launch per layer
    per decode step, whatever the batch composition."""
    _, cfg, _, model = setup
    reqs = poisson_trace(num_requests=4, rate=0.5, prompt_lens=(6, 10),
                         max_new=(3, 6), vocab_size=cfg.vocab_size, seed=0)
    with use(backend="engine", device="cpu"):
        engine.reset_stats()
        serving = ContinuousBatchingEngine(model, num_slots=3,
                                           spec=PageSpec(24, 8, 6))
        result = serving.run(reqs)
        st = engine.stats()["flash_decode"]
        m = result["metrics"]
        assert m["decode_steps"] > 1 and m["requests"] == len(reqs)
        assert st["launches"] == m["flash_decode_launches"] \
            == m["decode_steps"] * cfg.num_layers
        assert st["kernel_misses"] == 1 and st["plan_misses"] == 1
        _assert_identical(model, reqs, result)


def test_decode_table_built_once_per_step(setup, monkeypatch):
    """Every layer shares one block-table tensor and the step's lengths,
    so a decode step builds the runtime decode table once, not once per
    layer, and still launches flash_decode once per layer."""
    from repro_torch.core.schedule import DecodeTileSchedule
    _, cfg, _, model = setup
    builds = []
    real = DecodeTileSchedule.tables_and_offsets
    monkeypatch.setattr(DecodeTileSchedule, "tables_and_offsets",
                        lambda self, *a: builds.append(1) or real(self, *a))
    with use(backend="engine", device="cpu"):
        cache, pool, toks = _port_state(model)
        assert all(c.tables is cache[0].tables for c in cache)
        lengths = torch.tensor([L or 0 for L in PROMPT_LENS])
        active = torch.tensor([L is not None for L in PROMPT_LENS])
        engine.reset_stats(entries=False)
        step = make_paged_serve_step(model)
        tokens = torch.tensor(toks)[:, None]
        for n in (1, 2):
            tokens, _, lengths = step(cache, tokens, lengths, active)
            assert len(builds) == n
        assert engine.stats()["flash_decode"]["launches"] \
            == 2 * cfg.num_layers


def test_continuous_launches_without_the_oracle(setup):
    """``run_continuous(check=False)`` runs the engine alone: one prefill
    per admission and one forward per decode step, each 7 projections per
    layer and the LM head, flash forward once per layer per prefill.  The
    oracle, run after, gives the static path's tokens."""
    _, cfg, _, model = setup
    L = cfg.num_layers
    with use(backend="engine", device="cpu"):
        engine.reset_stats(entries=False)
        res = run_continuous(model, num_slots=3, num_pages=9, page_size=4,
                             max_blocks=8, num_requests=4, rate=2.0,
                             prompt_len=10, max_new=8, seed=1, check=False)
        st = engine.stats()
        assert "token_identical" not in res
        assert static_oracle(model, res["trace"], res["outputs"]) == {
            "identical_requests": 4, "token_identical": True}
    m = res["metrics"]
    admissions = len(res["trace"]) + m["evictions"]
    assert m["evictions"] > 0
    gemm = st["gemm"]
    assert gemm["plan_hits"] + gemm["plan_misses"] \
        == (admissions + m["decode_steps"]) * (7 * L + 1)
    assert st["flash_attention"]["launches"] == admissions * L
    assert st["flash_decode"]["launches"] == m["decode_steps"] * L


def test_lone_sequence_pool_exhaustion_raises(setup):
    _, cfg, _, model = setup
    req = Request(rid=0, prompt=np.arange(1, 8, dtype=np.int32), max_new=16)
    with use(backend="engine", device="cpu"):
        serving = ContinuousBatchingEngine(model, num_slots=2,
                                           spec=PageSpec(2, 4, 8))
        with pytest.raises(OutOfPages):
            serving.run([req])


def test_kv_int8_pools_are_int8_with_scales(setup):
    """``kv_quant="int8"`` gives int8 pools and zeroed ``(pages, P)`` f32
    scales, as the reference's ``init_paged_kv_cache``; any other
    kv_quant is refused."""
    jcfg, _, _, model = setup
    spec = PageSpec(4, 4, 2, kv_quant="int8")
    cache = init_serving_cache(model, 2, spec)
    want = j_pages.init_serving_cache(jcfg, 2, JPageSpec(*spec))["groups"][
        "b0"]
    for layer in cache:
        assert layer.k.dtype == layer.v.dtype == torch.int8
        assert str(want.k.dtype) == "int8"
        for s, w in ((layer.k_scale, want.k_scale),
                     (layer.v_scale, want.v_scale)):
            assert s.dtype == torch.float32
            assert tuple(s.shape) == tuple(w.shape[1:]) == (4, 4)
            assert not s.any()
    with pytest.raises(ValueError, match="kv_quant"):
        init_serving_cache(model, 2, PageSpec(4, 4, 2, kv_quant="int4"))


def test_run_continuous_and_cli_on_cpu(setup, capsys, monkeypatch):
    _, cfg, _, model = setup
    with use(backend="engine", device="cpu"):
        res = run_continuous(model, num_slots=3, num_pages=9, page_size=4,
                             max_blocks=8, num_requests=4, rate=2.0,
                             prompt_len=10, max_new=8, seed=1)
    assert res["token_identical"] and res["identical_requests"] == 4
    assert res["metrics"]["evictions"] > 0
    # The warm start is ported: a first run records the manifest, the next
    # warms up on it and serves resolving no plan.
    import tempfile
    with tempfile.TemporaryDirectory() as d, \
            use(backend="engine", device="cpu"):
        manifest = f"{d}/manifest.json"
        run_continuous(model, warm_start=manifest, check=False)
        warm = run_continuous(model, warm_start=manifest, check=False)
    assert warm["warmup"]["post_plan_misses"] == 0
    # The CLI configures the process-wide default: put it back afterwards.
    from repro_torch.core import config as engine_config
    monkeypatch.setattr(engine_config, "_DEFAULT", engine_config._DEFAULT)
    serve_main(["--arch", "qwen3-0.6b", "--device", "cpu", "--continuous",
                "--prompt-len", "24", "--gen", "12"])
    out = capsys.readouterr().out
    assert "continuous: requests=6" in out and "token_identical=True" in out
    assert "engine[flash_decode]: launches=" in out
