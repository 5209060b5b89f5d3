"""Continuous batching of the mixture-of-experts and Mamba-2 models against
the reference, on the CPU, from the same JAX-initialised parameters
(carried over by ``repro_torch.convert``):

  * the "staggered" and "evict" runs of tests/test_torch_serving.py on
    reduced phi3.5-moe-42b and grok-1-314b and on reduced mamba2-130m with
    the reference tests' overrides (``ssm_chunk 4, d_model 48, ssm_head_dim
    8``), under both backends: outputs, evictions and decode steps equal to
    the reference ``ContinuousBatchingEngine``'s (its ``xla`` path); the
    Mamba-2 runs are also token-identical to the port's static path (a
    mixture of experts promises no such identity: routing and capacity
    depend on the batch);
  * ``write_prefill`` of an SSM state: the reference's own dense prefill
    states, written into the port's serving cache, equal the reference's
    serving cache bit for bit (the conv tail cast to the serving leaf's
    dtype, as the reference casts it);
  * ``_merge_inactive``: inactive slots' ``conv`` and ``s`` rows bit-equal
    across a paged step, active rows updated;
  * a reduced config with ``block_pattern=("attn", "ssm")``, whose serving
    cache mixes paged pools and plain state leaves, held to the reference;
  * the serve CLI with ``--continuous`` for mamba2-130m and
    phi3.5-moe-42b on ``--device cpu``.

Tolerances: tokens, evictions and step counts exactly; the paged step's
logits against the reference's within atol = rtol = 1e-4 (float32 on both
sides, sums in another order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs import reduced_config as j_reduced_config
from repro.models import LanguageModel as JLanguageModel
from repro.models.attention import PageSpec as JPageSpec
from repro.runtime import pages as j_pages
from repro.runtime.batching import (
    ContinuousBatchingEngine as JContinuousBatchingEngine)
from repro.runtime.batching import poisson_trace as j_poisson_trace
from repro.runtime.steps import forward as j_forward
from repro.runtime.steps import make_prefill_step as j_make_prefill_step

from repro_torch.configs import get_config, reduced_config
from repro_torch.convert import params_from_jax_numpy
from repro_torch.core import engine, use
from repro_torch.launch.serve import generate, main as serve_main
from repro_torch.models import LanguageModel
from repro_torch.models.attention import PagedKVCache, PageSpec
from repro_torch.models.ssd import SSMState
from repro_torch.runtime.batching import (ContinuousBatchingEngine,
                                          poisson_trace)
from repro_torch.runtime.pages import (PagePool, init_serving_cache,
                                       refresh_tables, write_prefill)
from repro_torch.runtime.steps import make_paged_serve_step, \
    make_prefill_step

ATOL = 1e-4
MAMBA = dict(ssm_chunk=4, d_model=48, ssm_head_dim=8)
ARCHS = {"phi3.5-moe-42b": {}, "grok-1-314b": {}, "mamba2-130m": MAMBA,
         "attn+ssm": dict(MAMBA, block_pattern=("attn", "ssm"))}
RUN_CASES = {  # tests/test_torch_serving.py's staggered and evict cases
    "staggered": (dict(num_requests=5, rate=0.5, prompt_lens=(6, 12),
                       max_new=(2, 7), seed=3), 3, (24, 8, 6)),
    "evict": (dict(num_requests=4, rate=2.0, prompt_lens=10, max_new=8,
                   seed=1), 3, (9, 4, 8)),
}

_SETUPS, _WANT = {}, {}


def _setup(name):
    """(jcfg, cfg, JAX params, port model) for one of ``ARCHS``."""
    if name not in _SETUPS:
        arch = "mamba2-130m" if name == "attn+ssm" else name
        jcfg = j_reduced_config(j_get_config(arch), **ARCHS[name])
        cfg = reduced_config(get_config(arch), **ARCHS[name])
        params = JLanguageModel.init(jax.random.PRNGKey(0), jcfg)
        model = LanguageModel(cfg, device="cpu", seed=1)
        model.load_state_dict(params_from_jax_numpy(
            jax.tree.map(np.asarray, params), cfg, device="cpu"), strict=True)
        _SETUPS[name] = (jcfg, cfg, params, model)
    return _SETUPS[name]


def _reference_run(name, case):
    """The reference engine's run of one case (its default xla path)."""
    if (name, case) not in _WANT:
        jcfg, _, params, _ = _setup(name)
        trace, slots, spec = RUN_CASES[case]
        reqs = j_poisson_trace(vocab_size=jcfg.vocab_size, **trace)
        _WANT[name, case] = JContinuousBatchingEngine(
            jcfg, params, num_slots=slots, spec=JPageSpec(*spec)).run(reqs)
    return _WANT[name, case]


@pytest.mark.parametrize("case", sorted(RUN_CASES))
@pytest.mark.parametrize("backend", ["engine", "torch"])
@pytest.mark.parametrize("name", sorted(ARCHS))
def test_continuous_run_matches_reference(name, backend, case):
    _, cfg, _, model = _setup(name)
    want = _reference_run(name, case)
    trace, slots, spec = RUN_CASES[case]
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
            assert got["metrics"]["evictions"] > 0
        serving.pool.check_invariants([0] * slots)
        assert serving.pool.free_pages == spec[0]
        if not cfg.num_experts:
            for r in reqs:
                static = generate(model, torch.from_numpy(r.prompt)[None],
                                  r.max_new)["tokens"][0].numpy()
                np.testing.assert_array_equal(got["outputs"][r.rid], static)


def test_moe_runs_launch_the_grouped_kernel_per_forward():
    """Under the engine backend every MoE forward of a continuous run (one
    prefill per admission, one step per decode step) runs its three expert
    GEMMs through the grouped family; no projection leaves the GEMM
    family."""
    _, cfg, _, model = _setup("phi3.5-moe-42b")
    trace, slots, spec = RUN_CASES["evict"]
    reqs = poisson_trace(vocab_size=cfg.vocab_size, **trace)
    with use(backend="engine", device="cpu"):
        engine.reset_stats(entries=False)
        res = ContinuousBatchingEngine(model, num_slots=slots,
                                       spec=PageSpec(*spec)).run(reqs)
        st = engine.stats()
    m = res["metrics"]
    forwards = len(reqs) + m["evictions"] + m["decode_steps"]
    assert st["grouped_gemm"]["launches"] == forwards * 3 * cfg.num_layers
    assert st["flash_decode"]["launches"] == \
        m["decode_steps"] * cfg.num_layers


# ---------------------------------------------------------------------------
# the SSM leaves of the serving cache
# ---------------------------------------------------------------------------

def _ssm_leaves(cache):
    """Per-layer (conv, s) numpy arrays of a reference serving cache whose
    layers are all "ssm" (scanned groups)."""
    leaf = cache["groups"]["b0"]
    return [(np.asarray(leaf.conv[i]), np.asarray(leaf.s[i]))
            for i in range(leaf.s.shape[0])]


def test_write_prefill_ssm_state_equals_reference():
    """The reference's dense prefill states of two prompts, written slot
    by slot into the port's serving cache, give the reference's serving
    cache bit for bit; the other slot keeps its (stale) rows."""
    jcfg, cfg, params, model = _setup("mamba2-130m")
    spec = PageSpec(12, 4, 6)
    cache = init_serving_cache(model, 3, spec)
    for layer in cache:  # stale rows an evicted sequence would leave
        layer.conv.fill_(3.0)
        layer.s.fill_(-3.0)
    jcache = j_pages.init_serving_cache(jcfg, 3, JPageSpec(*spec))
    jcache = jax.tree.map(lambda x: jnp.full_like(x, 3.0 if x.ndim == 4
                                                  else -3.0), jcache)
    rng = np.random.default_rng(0)
    pool = PagePool(spec, 3)
    for slot, L in ((0, 7), (2, 10)):
        prompt = rng.integers(0, cfg.vocab_size, L).astype(np.int32)
        _, dense = j_make_prefill_step(jcfg, L)(
            params, {"tokens": jnp.asarray(prompt)[None]})
        ids = pool.grow(slot, L)
        d = dense["groups"]["b0"]
        port_dense = [SSMState(torch.tensor(np.asarray(d.conv[i])),
                               torch.tensor(np.asarray(d.s[i])))
                      for i in range(d.s.shape[0])]
        write_prefill(cache, port_dense, slot=slot, length=L, page_ids=ids,
                      page_size=spec.page_size)
        jcache = j_pages.write_prefill(jcache, dense, slot=slot, length=L,
                                       page_ids=ids,
                                       page_size=spec.page_size)
    refresh_tables(cache, pool.tables)  # state leaves have no tables
    for layer, (conv, s) in zip(cache, _ssm_leaves(jcache)):
        assert layer.conv.dtype == torch.bfloat16 and str(conv.dtype) == \
            "bfloat16"
        np.testing.assert_array_equal(layer.conv.float().numpy(),
                                      conv.astype(np.float32))
        np.testing.assert_array_equal(layer.s.numpy(), s)
        assert (layer.s[1] == -3.0).all()


def test_merge_inactive_keeps_inactive_rows_bit_equal():
    """One paged step with slot 1 inactive: its conv and s rows are the
    rows before the step, bit for bit (in the merged leaf's promoted
    dtype), the active slots' rows are the forward's; an all-inactive step
    changes no row."""
    _, cfg, _, model = _setup("mamba2-130m")
    spec = PageSpec(12, 4, 6)
    gen = torch.Generator().manual_seed(0)
    with use(backend="engine", device="cpu"):
        cache = init_serving_cache(model, 3, spec)
        cache = [SSMState(torch.randn(c.conv.shape, generator=gen),
                          torch.randn(c.s.shape, generator=gen))
                 for c in cache]
        before = [(c.conv.clone(), c.s.clone()) for c in cache]
        step = make_paged_serve_step(model)
        tokens = torch.tensor([[3], [5], [7]])
        lengths = torch.tensor([4, 2, 6])
        active = torch.tensor([True, False, True])
        _, new, new_len = step(cache, tokens, lengths, active)
        with torch.no_grad():
            _, raw, _ = model.apply(tokens, positions=torch.where(
                active, lengths, -1).to(torch.int32)[:, None], cache=cache)
        _, idle, _ = step(new, tokens, new_len,
                          torch.zeros(3, dtype=torch.bool))
    assert new_len.tolist() == [5, 2, 7]
    for layer, r, (conv, s), i in zip(new, raw, before, idle):
        assert torch.equal(layer.conv[1], conv[1].to(layer.conv.dtype))
        assert torch.equal(layer.s[1], s[1])
        assert torch.equal(layer.conv[[0, 2]], r.conv[[0, 2]])
        assert torch.equal(layer.s[[0, 2]], r.s[[0, 2]])
        assert not torch.equal(layer.s[0], s[0])
        assert torch.equal(i.conv, layer.conv) and torch.equal(i.s, layer.s)


def test_mixed_attention_and_ssm_cache_held_to_reference():
    """``block_pattern=("attn", "ssm")``: the serving cache is a paged pool
    and a slot-major SSM state; one paged step with an inactive slot gives
    the reference's logits on the active slots (atol = rtol = 1e-4), the
    inactive slot's state rows stay as they were, and the pools, the
    step's K/V rows written, are the reference's."""
    jcfg, cfg, params, model = _setup("attn+ssm")
    spec = PageSpec(12, 4, 6)
    prompts = {0: 6, 2: 9}
    rng = np.random.default_rng(2)
    jpool = j_pages.PagePool(JPageSpec(*spec), 3)
    jcache = j_pages.init_serving_cache(jcfg, 3, JPageSpec(*spec))
    cache = init_serving_cache(model, 3, spec)
    assert isinstance(cache[0], PagedKVCache)
    assert isinstance(cache[1], SSMState)
    pool = PagePool(spec, 3)
    toks = np.zeros((3, 1), np.int32)
    for slot, L in prompts.items():
        prompt = rng.integers(0, cfg.vocab_size, L).astype(np.int32)
        jlogits, jdense = j_make_prefill_step(jcfg, L)(
            params, {"tokens": jnp.asarray(prompt)[None]})
        ids = jpool.grow(slot, L)
        jcache = j_pages.write_prefill(jcache, jdense, slot=slot, length=L,
                                       page_ids=ids,
                                       page_size=spec.page_size)
        with use(backend="engine", device="cpu"):
            logits, dense = make_prefill_step(model, L)(
                {"tokens": torch.from_numpy(prompt).long()[None]})
        write_prefill(cache, dense, slot=slot, length=L,
                      page_ids=pool.grow(slot, L), page_size=spec.page_size)
        toks[slot, 0] = int(jnp.argmax(jlogits[0]))
        assert int(torch.argmax(logits[0])) == toks[slot, 0]
        jpool.grow(slot, L + 1)
        pool.grow(slot, L + 1)
    jcache = j_pages.refresh_tables(jcache, jpool.device_tables())
    refresh_tables(cache, pool.tables)
    lengths = np.asarray([prompts.get(i, 0) for i in range(3)], np.int32)
    active = np.asarray([i in prompts for i in range(3)])
    want, jnew, _ = j_forward(jcfg, params, {"tokens": jnp.asarray(toks)},
                           cache=jcache, positions=jnp.where(
                               active, lengths, -1).astype(jnp.int32)[:, None])
    state_before = (cache[1].conv.clone(), cache[1].s.clone())
    with use(backend="engine", device="cpu"), torch.no_grad():
        got, _, _ = model.apply(
            torch.from_numpy(toks).long(),
            positions=torch.from_numpy(np.where(active, lengths, -1)
                                       .astype(np.int32))[:, None],
            cache=cache)
        _, new, _ = make_paged_serve_step(model)(
            cache, torch.from_numpy(toks).long(),
            torch.from_numpy(lengths).long(), torch.from_numpy(active))
    np.testing.assert_allclose(got[active].numpy(), np.asarray(want)[active],
                               atol=ATOL, rtol=ATOL)
    assert torch.equal(new[1].s[1], state_before[1][1])
    assert torch.equal(new[1].conv[1],
                       state_before[0][1].to(new[1].conv.dtype))
    assert new[0] is cache[0]  # the pools pass through the merge
    jleaf = jnew["groups"]["b0"]
    for pool, jpool_ in ((cache[0].k, jleaf.k), (cache[0].v, jleaf.v)):
        np.testing.assert_allclose(pool.numpy(), np.asarray(jpool_[0]),
                                   atol=ATOL, rtol=ATOL)


@pytest.mark.parametrize("arch", ["mamba2-130m", "phi3.5-moe-42b"])
def test_continuous_cli_on_cpu(arch, capsys):
    """The serve CLI's continuous mode runs both families; the Mamba-2 run
    is token-identical to the static path, the MoE run reports it."""
    from repro_torch.core import configure, get_config as engine_config
    before = engine_config()
    try:
        serve_main(["--arch", arch, "--device", "cpu", "--continuous",
                    "--prompt-len", "24", "--gen", "12"])
    finally:
        configure(device=before.device, backend=before.backend,
                  fused=before.fused)
    out = capsys.readouterr().out
    assert f"arch={arch} device=cpu continuous: requests=6" in out
    assert "token_identical=" in out
    if arch == "mamba2-130m":
        assert "token_identical=True" in out
    else:
        assert "engine[flash_decode]: launches=" in out
