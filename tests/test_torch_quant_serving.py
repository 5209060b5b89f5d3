"""Quantized serving in the port against the reference: W8A16 weights
(``quantize_model``), KV-int8 paged pools (``PageSpec(kv_quant="int8")``),
int8 expert GEMMs (``use(quant="int8")``) and ``grad_compress`` training,
on reduced configs in float32 from the same JAX-initialised parameters.

The reference holds the layers of a scanned group stacked on a leading
axis, so its ``quantize_model`` (2-D ``w`` leaves only) leaves those
projections wide: on ``reduced_config(qwen3-0.6b)`` it quantizes nothing.
The port holds one module per layer and quantizes every projection.  The
W8A16 cases therefore give the reference the tree its ``quantize_model``
would give an unscanned model: each layer's projection quantized by the
reference's own ``quantize`` and the layers stacked into one
``QuantizedTensor`` (its scan hands every layer its own slice).  The
``grad_compress`` step runs on an unscanned model (a block pattern one
longer than the depth): the reference compresses each tree leaf in
256-element blocks of the flattened leaf, and a scanned leaf stacks every
layer's.

Tolerances (float32 on both sides, sums in another order):
  * quantized trees, pools and scales: exactly equal;
  * W8A16 logits: atol = rtol = 1e-5; greedy tokens identical;
  * KV-int8 decode: the port's engine and torch paths and the reference's
    XLA path within 1e-5 relative of each other, and within int8 error
    (5e-2 relative) of the wide pools (tests/test_quant.py's bounds);
  * continuous runs: tokens, evictions and decode steps identical;
  * int8 phi3.5-moe logits: the activations are quantized per row at
    dispatch, and a value a float32 ulp from a rounding boundary can round
    to the neighbouring int8 in the other package; 2e-3 of the logits'
    range bounds such flips, and the greedy tokens must still agree;
  * the grad_compress step: loss 1e-5 relative, grad_norm 1e-4 relative,
    every compressed gradient leaf within one int8 step of its block
    (the blocks' scales agree to float32 noise, so a leaf rounds to a
    neighbouring level where the raw gradients differ by an ulp).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jcore
from repro.configs import get_config as j_get_config
from repro.configs import reduced_config as j_reduced_config
from repro.data import SyntheticLMDataset as JSyntheticLMDataset
from repro.launch.serve import generate as j_generate
from repro.models import LanguageModel as JLanguageModel
from repro.models.attention import KVCache as JKVCache
from repro.models.attention import PageSpec as JPageSpec
from repro.models.attention import _paged_decode as j_paged_decode
from repro.models.attention import init_paged_kv_cache as j_init_paged
from repro.optim import adamw as j_adamw
from repro.optim import compression as jcomp
from repro.runtime import pages as j_pages
from repro.runtime.batching import (
    ContinuousBatchingEngine as JContinuousBatchingEngine)
from repro.runtime.batching import poisson_trace as j_poisson_trace
from repro.runtime.steps import make_train_step as j_make_train_step

from repro_torch.configs import get_config, reduced_config
from repro_torch.convert import params_from_jax_numpy
from repro_torch.core import engine, use
from repro_torch.kernels.flash_attention import kernel as flash_kernel
from repro_torch.launch.serve import generate
from repro_torch.models import LanguageModel
from repro_torch.models.attention import (KVCache, PageSpec, _paged_decode,
                                          init_paged_kv_cache, paged_step)
from repro_torch.optim import adamw
from repro_torch.optim import compression as comp
from repro_torch.runtime.batching import (ContinuousBatchingEngine,
                                          poisson_trace)
from repro_torch.runtime.pages import write_prefill
from repro_torch.runtime.steps import make_train_step

BACKENDS = [("torch", "xla"), ("engine", "pallas")]


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _port(cfg, params):
    model = LanguageModel(cfg, device="cpu", seed=1)
    model.load_state_dict(params_from_jax_numpy(_np_tree(params), cfg,
                                                device="cpu"), strict=True)
    return model


def _unscanned(cfg):
    """The same model with every layer outside a scanned group."""
    return dataclasses.replace(cfg,
                               block_pattern=("attn",) * (cfg.num_layers + 1))


@pytest.fixture(scope="module")
def qwen():
    jcfg = j_reduced_config(j_get_config("qwen3-0.6b"))
    cfg = reduced_config(get_config("qwen3-0.6b"))
    params = JLanguageModel.init(jax.random.PRNGKey(0), jcfg)
    return jcfg, cfg, params


def _j_quantize_stacked(params, spec="w8a16"):
    """The reference's W8A16 tree with every scanned layer's projections
    quantized: each layer by ``quantize`` (per output column), the layers'
    values and scales stacked into one ``QuantizedTensor``."""
    def walk(node):
        if isinstance(node, dict):
            out = {}
            for k, v in node.items():
                if k == "w" and getattr(v, "ndim", 0) == 3:
                    per = [jcomp.quantize(v[i], spec, axis=-1)
                           for i in range(v.shape[0])]
                    out[k] = jcomp.QuantizedTensor(
                        jnp.stack([p.q for p in per]),
                        jnp.stack([p.scale for p in per]), per[0].spec,
                        axis=-1, orig_dtype=v.dtype)
                else:
                    out[k] = walk(v)
            return out
        return node
    return dict(params, blocks={"groups": walk(params["blocks"]["groups"]),
                                "rem": params["blocks"]["rem"]})


@pytest.fixture(scope="module")
def w8a16():
    """Reduced Qwen3 quantized W8A16 in both packages."""
    jcfg = j_reduced_config(j_get_config("qwen3-0.6b"))
    cfg = reduced_config(get_config("qwen3-0.6b"))
    params = JLanguageModel.init(jax.random.PRNGKey(0), jcfg)
    qparams = _j_quantize_stacked(params)
    model = comp.quantize_model(_port(cfg, params), "w8a16")
    tokens = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 13)).astype(np.int32)
    return jcfg, cfg, params, qparams, model, tokens


@pytest.fixture(scope="module")
def unscanned():
    jcfg = _unscanned(j_reduced_config(j_get_config("qwen3-0.6b")))
    cfg = _unscanned(reduced_config(get_config("qwen3-0.6b")))
    return jcfg, cfg, JLanguageModel.init(jax.random.PRNGKey(0), jcfg)


# ---------------------------------------------------------------------------
# W8A16 weights
# ---------------------------------------------------------------------------

def test_reference_quantize_model_skips_scanned_layers(qwen, unscanned):
    """Why the reference's tree is built per layer: on its own Qwen3 tree
    (all layers in one scanned group, tied read-out) quantize_model finds
    no 2-D ``w`` leaf; on an unscanned model it quantizes every
    projection, as the port's does on its per-layer modules."""
    jcfg, cfg, params = qwen
    is_q = lambda x: isinstance(x, jcomp.QuantizedTensor)  # noqa: E731
    q = jcomp.quantize_model(params, "w8a16")
    assert not any(is_q(x) for x in jax.tree.leaves(q, is_leaf=is_q))
    ucfg, _, uparams = unscanned
    uq = jcomp.quantize_model(uparams, "w8a16")
    assert sum(is_q(x) for x in jax.tree.leaves(uq, is_leaf=is_q)) == \
        7 * ucfg.num_layers
    model = comp.quantize_model(_port(cfg, params), "w8a16")
    assert isinstance(model.blocks[0].mixer.wq.w, comp.QuantizedTensor)


def test_w8a16_trees_equal_reference(w8a16, unscanned):
    """Layer by layer, the port's quantized projections equal the
    reference's: its per-layer stack here, and its own quantize_model's
    leaves on the unscanned model (the same draws, layer by layer)."""
    jcfg, cfg, params, qparams, model, _ = w8a16
    _, _, uparams = unscanned
    uq = jcomp.quantize_model(uparams, "w8a16")
    n = 0
    for i, block in enumerate(model.blocks):
        for path in ("mixer.wq", "mixer.wk", "mixer.wv", "mixer.wo",
                     "ff.w_gate", "ff.w_up", "ff.w_down"):
            stacked = qparams["blocks"]["groups"]["b0"]
            for part in path.split("."):
                stacked = stacked[part]
            got, want = block.get_submodule(path).w, stacked["w"]
            np.testing.assert_array_equal(got.q.numpy(),
                                          np.asarray(want.q[i]))
            np.testing.assert_array_equal(got.scale.numpy(),
                                          np.asarray(want.scale[i]))
            w = uparams["blocks"]["rem"][i]
            for part in path.split("."):
                w = w[part]
            mine = comp.quantize_model(
                {"w": torch.from_numpy(np.asarray(w["w"]))}, "w8a16")["w"]
            theirs = uq["blocks"]["rem"][i]
            for part in path.split("."):
                theirs = theirs[part]
            np.testing.assert_array_equal(mine.q.numpy(),
                                          np.asarray(theirs["w"].q))
            np.testing.assert_array_equal(mine.scale.numpy(),
                                          np.asarray(theirs["w"].scale))
            n += 1
    assert n == 7 * cfg.num_layers
    np.testing.assert_array_equal(model.embed.table.detach().numpy(),
                                  np.asarray(qparams["embed"]["table"]))


@pytest.mark.parametrize("backend,j_backend", BACKENDS)
def test_w8a16_logits_and_tokens_equal_reference(w8a16, backend, j_backend):
    jcfg, cfg, params, qparams, model, tokens = w8a16
    with jcore.use(backend=j_backend):
        want, _, _ = JLanguageModel.apply(qparams, jcfg, jnp.asarray(tokens))
        want_tok = np.asarray(j_generate(jcfg, qparams, jnp.asarray(tokens),
                                         4)["tokens"])
    with use(backend=backend, device="cpu"), torch.no_grad():
        engine.reset_stats()
        got, _, _ = model.apply(torch.from_numpy(tokens).long())
        if backend == "engine":  # every projection through the quant kernel
            assert engine.stats()["gemm"]["launches"] >= 7 * cfg.num_layers
        res = generate(model, torch.from_numpy(tokens), 4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_array_equal(res["tokens"].numpy(), want_tok)


def test_w8a16_moves_the_logits_only_by_quantization(w8a16):
    jcfg, cfg, params, _, model, tokens = w8a16
    wide = _port(cfg, params)
    with use(backend="engine", device="cpu"), torch.no_grad():
        q, _, _ = model.apply(torch.from_numpy(tokens).long())
        w, _, _ = wide.apply(torch.from_numpy(tokens).long())
    gap = (q - w).abs().max() / (w.max() - w.min())
    assert 0 < gap < 5e-2


# ---------------------------------------------------------------------------
# KV-int8 pools
# ---------------------------------------------------------------------------

def test_kv_int8_write_prefill_equals_reference():
    """A dense prefill cache into int8 pools (over stale pages): pools and
    scales equal to the reference's, and the padded tail quantized as the
    reference quantizes it."""
    P, HKV, HD, L = 16, 2, 32, 21
    spec = PageSpec(num_pages=6, page_size=P, max_blocks=3, kv_quant="int8")
    rng = np.random.default_rng(3)
    k, v = (rng.standard_normal((1, L, HKV, HD)).astype(np.float32)
            for _ in range(2))
    sv = init_paged_kv_cache(2, spec, HKV, HD, torch.float32, "cpu")
    jsv = j_init_paged(2, JPageSpec(*spec), HKV, HD, jnp.float32)
    sv.k.fill_(7)
    sv.k_scale.fill_(0.5)
    jsv = jsv._replace(k=jnp.full_like(jsv.k, 7),
                       k_scale=jnp.full_like(jsv.k_scale, 0.5))
    write_prefill([sv], [KVCache(torch.from_numpy(k), torch.from_numpy(v),
                                 torch.arange(L)[None])],
                  slot=0, length=L, page_ids=[4, 2], page_size=P)
    out = j_pages._write_one(jsv, JKVCache(jnp.asarray(k), jnp.asarray(v),
                                           jnp.arange(L)[None]),
                             slot=0, length=L, page_ids=[4, 2], page_size=P)
    for got, want in ((sv.k, out.k), (sv.v, out.v), (sv.k_scale, out.k_scale),
                      (sv.v_scale, out.v_scale)):
        assert got.dtype in (torch.int8, torch.float32)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    deq = sv.k[4].float() * sv.k_scale[4][:, None, None]
    np.testing.assert_allclose(deq.numpy(), k[0, :P], atol=2e-2, rtol=2e-2)


def _decode_run(spec, backend, port=True):
    """tests/test_quant.py's KV-int8 decode: 3 slots, 10 steps."""
    B, H, HKV, HD = 3, 4, 2, 64
    rng = np.random.default_rng(7)
    base = np.asarray([0, 3, 1], np.int32)
    tables = np.asarray([[0, 1], [2, 3], [4, 5]], np.int32)
    if port:
        cfg = type("Cfg", (), {"attn_logit_softcap": 0.0})()
        cache = init_paged_kv_cache(B, spec, HKV, HD, torch.float32, "cpu")
        cache.tables.copy_(torch.from_numpy(tables))
    else:
        cfg = type("Cfg", (), {"attn_logit_softcap": 0.0})()
        cache = j_init_paged(B, JPageSpec(*spec), HKV, HD, jnp.float32)
        cache = cache._replace(tables=jnp.asarray(tables))
    out = None
    for step in range(10):
        qkv = [rng.standard_normal((B, 1, h, HD)).astype(np.float32) * 0.3
               for h in (H, HKV, HKV)]
        pos = (base + step)[:, None]
        if port:
            with use(backend=backend, device="cpu"):
                t = [torch.from_numpy(x) for x in qkv]
                st = paged_step(cache, torch.from_numpy(pos))
                out = _paged_decode(cfg, cache, *t, st, torch.float32,
                                    H // HKV).numpy()
        else:
            with jcore.use(backend=backend):
                cache, o = j_paged_decode(cfg, cache, *(jnp.asarray(x)
                                                        for x in qkv),
                                          jnp.asarray(pos), jnp.float32,
                                          H // HKV)
            out = np.asarray(o)
    return out, cache


def _rel(a, b):
    return np.abs(a - b).max() / (np.abs(b).max() or 1.0)


def test_kv_int8_paged_decode_matches_reference_and_dense():
    spec_w = PageSpec(num_pages=8, page_size=16, max_blocks=2)
    spec_q = PageSpec(num_pages=8, page_size=16, max_blocks=2,
                      kv_quant="int8")
    wide, _ = _decode_run(spec_w, "torch")
    ref_q, jcache = _decode_run(spec_q, "xla", port=False)
    n0 = flash_kernel.LAUNCHES["flash_decode_int8"]
    for backend in ("torch", "engine"):
        got, cache = _decode_run(spec_q, backend)
        assert _rel(got, ref_q) < 1e-5, backend
        assert _rel(got, wide) < 5e-2, backend
        for mine, theirs in ((cache.k, jcache.k), (cache.v, jcache.v),
                             (cache.k_scale, jcache.k_scale),
                             (cache.v_scale, jcache.v_scale)):
            np.testing.assert_array_equal(mine.numpy(), np.asarray(theirs))
    # the CPU runs the kernel's plain version: no launch counted
    assert flash_kernel.LAUNCHES["flash_decode_int8"] == n0


def test_kv_int8_inactive_slot_leaves_pools_and_scales_unchanged(qwen):
    """An all-inactive step leaves every pool and scale byte as it was."""
    jcfg, cfg, params = qwen
    model = _port(cfg, params)
    spec = PageSpec(num_pages=4, page_size=4, max_blocks=3, kv_quant="int8")
    cache = model.init_cache(2, 12, paged=spec)
    gen = torch.Generator().manual_seed(0)
    for layer in cache:
        layer.k.copy_(torch.randint(-127, 128, layer.k.shape, generator=gen))
        layer.k_scale.copy_(torch.rand(layer.k_scale.shape, generator=gen))
    before = [(c.k.clone(), c.v.clone(), c.k_scale.clone(),
               c.v_scale.clone()) for c in cache]
    for backend in ("engine", "torch"):
        with use(backend=backend, device="cpu"), torch.no_grad():
            model.apply(torch.tensor([[3], [5]]),
                        positions=torch.tensor([[-1], [-1]],
                                               dtype=torch.int32),
                        cache=cache)
        for c, b in zip(cache, before):
            for got, want in zip((c.k, c.v, c.k_scale, c.v_scale), b):
                assert torch.equal(got, want)


RUN_CASES = {  # tests/test_serving.py's staggered and evict/re-admit cases
    "staggered": (dict(num_requests=5, rate=0.5, prompt_lens=(6, 12),
                       max_new=(2, 7), seed=3), 3, (24, 8, 6)),
    "evict": (dict(num_requests=4, rate=2.0, prompt_lens=10, max_new=8,
                   seed=1), 3, (9, 4, 8)),
}


def _run_both(jcfg, jparams, model, case, backend):
    trace, slots, spec = RUN_CASES[case]
    jreqs = j_poisson_trace(vocab_size=jcfg.vocab_size, **trace)
    jserving = JContinuousBatchingEngine(
        jcfg, jparams, num_slots=slots,
        spec=JPageSpec(*spec, kv_quant="int8"))
    want = jserving.run(jreqs)
    reqs = poisson_trace(vocab_size=jcfg.vocab_size, **trace)
    with use(backend=backend, device="cpu"):
        engine.reset_stats()
        serving = ContinuousBatchingEngine(
            model, num_slots=slots, spec=PageSpec(*spec, kv_quant="int8"))
        got = serving.run(reqs)
        st = engine.stats()
    assert sorted(got["outputs"]) == sorted(want["outputs"])
    for rid, toks in want["outputs"].items():
        np.testing.assert_array_equal(got["outputs"][rid], toks)
    assert got["evictions"] == want["evictions"]
    for key in ("requests", "total_tokens", "decode_steps", "evictions"):
        assert got["metrics"][key] == want["metrics"][key], key
    if case == "evict":
        assert got["metrics"]["evictions"] > 0
    serving.pool.check_invariants([0] * serving.num_slots)
    assert serving.pool.free_pages == spec[0]
    if backend == "engine":
        assert st["flash_decode"]["launches"] == \
            got["metrics"]["decode_steps"] * model.cfg.num_layers
    return got


@pytest.mark.parametrize("case", sorted(RUN_CASES))
@pytest.mark.parametrize("backend", ["engine", "torch"])
def test_kv_int8_continuous_run_matches_reference(qwen, case, backend):
    jcfg, cfg, params = qwen
    _run_both(jcfg, params, _port(cfg, params), case, backend)


@pytest.mark.parametrize("backend", ["engine", "torch"])
def test_w8a16_kv_int8_continuous_run_matches_reference(w8a16, backend):
    jcfg, cfg, params, qparams, model, _ = w8a16
    _run_both(jcfg, qparams, model, "staggered", backend)


# ---------------------------------------------------------------------------
# int8 expert GEMMs (phi3.5-moe)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def moe():
    jcfg = j_reduced_config(j_get_config("phi3.5-moe-42b"))
    cfg = reduced_config(get_config("phi3.5-moe-42b"))
    params = JLanguageModel.init(jax.random.PRNGKey(0), jcfg)
    tokens = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 17)).astype(np.int32)
    return jcfg, cfg, params, _port(cfg, params), tokens


@pytest.mark.parametrize("backend,j_backend", BACKENDS)
def test_moe_int8_logits_and_tokens_equal_reference(moe, backend, j_backend):
    """Under ``quant="int8"`` the engine backend's expert GEMMs quantize
    (three quant launches a layer a forward); the torch and XLA backends'
    einsums stay wide, as in the reference."""
    jcfg, cfg, params, model, tokens = moe
    with jcore.use(backend=j_backend, quant="int8"):
        want, _, jaux = JLanguageModel.apply(params, jcfg,
                                             jnp.asarray(tokens))
        want_tok = np.asarray(j_generate(jcfg, params, jnp.asarray(tokens),
                                         3)["tokens"])
    with use(backend=backend, device="cpu", quant="int8"), torch.no_grad():
        engine.reset_stats()
        got, _, aux = model.apply(torch.from_numpy(tokens).long())
        st = engine.stats()
        res = generate(model, torch.from_numpy(tokens), 3)
    if backend == "engine":
        assert st["grouped_gemm"]["launches"] == 3 * cfg.num_layers
    want = np.asarray(want)
    spread = want.max() - want.min()
    assert np.abs(got.numpy() - want).max() <= 2e-3 * spread
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5)
    np.testing.assert_array_equal(res["tokens"].numpy(), want_tok)


def test_moe_int8_differs_from_wide_by_quantization(moe):
    jcfg, cfg, params, model, tokens = moe
    with use(backend="engine", device="cpu"), torch.no_grad():
        wide, _, _ = model.apply(torch.from_numpy(tokens).long())
        with use(quant="int8"):
            q, _, _ = model.apply(torch.from_numpy(tokens).long())
    gap = (q - wide).abs().max() / (wide.max() - wide.min())
    assert 0 < gap < 5e-2


# ---------------------------------------------------------------------------
# grad_compress training
# ---------------------------------------------------------------------------

def _spy(opt, box, convert):
    def update(grads, *args, **kw):
        box["grads"] = convert(grads)
        return opt.update(grads, *args, **kw)
    return type(opt)(opt.init, update)


@pytest.mark.parametrize("backend,j_backend", BACKENDS)
def test_grad_compress_step_matches_reference(unscanned, backend,
                                              j_backend):
    jcfg, cfg, params = unscanned
    batch = JSyntheticLMDataset(jcfg.vocab_size, 16, 4).host_batch(0)
    j_box, box = {}, {}
    j_opt = _spy(j_adamw(1e-3), j_box,
                 lambda g: params_from_jax_numpy(_np_tree(g), cfg, "cpu"))
    with jcore.use(backend=j_backend):
        step = j_make_train_step(jcfg, j_opt, grad_compress=True)
        _, j_state, want = step(params, j_opt.init(params),
                                {k: jnp.asarray(v) for k, v in batch.items()},
                                jnp.asarray(0))
    j_res = params_from_jax_numpy(_np_tree(j_state["ef_residual"]), cfg,
                                  "cpu")
    model = _port(cfg, params)
    opt = _spy(adamw(1e-3), box,
               lambda g: {k: v.clone() for k, v in g.items()})
    state = opt.init(dict(model.named_parameters()))
    with use(backend=backend, device="cpu"):
        got = make_train_step(cfg, opt, grad_compress=True)(
            model, state, {k: torch.from_numpy(v) for k, v in batch.items()},
            0)
    np.testing.assert_allclose(float(got["loss"]), float(want["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(got["grad_norm"]),
                               float(want["grad_norm"]), rtol=1e-4)
    assert set(box["grads"]) == set(j_box["grads"]) == set(
        state["ef_residual"])
    for name, g in box["grads"].items():
        want_g = j_box["grads"][name].numpy()
        # one int8 step of the leaf's largest block: amax / 127
        step_ = np.abs(want_g).max() / 127 + 1e-12
        np.testing.assert_allclose(g.numpy(), want_g, atol=1.01 * step_,
                                   rtol=0, err_msg=name)
        np.testing.assert_allclose(state["ef_residual"][name].numpy(),
                                   j_res[name].numpy(), atol=1.01 * step_,
                                   rtol=0, err_msg=name)
