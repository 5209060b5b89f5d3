"""RecurrentGemma (RG-LRU blocks, sliding-window attention on ring caches)
in the port against the reference, on the CPU, from the same
JAX-initialised parameters (carried over by ``repro_torch.convert``):

  * ``rglru_apply`` in outputs and state, with state continuity across a
    split of the sequence; ``_rglru_scan`` against the reference's
    ``lax.associative_scan`` and against a step loop;
  * windowed ``_attention_seq`` on the full-K chunk path (sq <= 512) and on
    the sliding path (sq = 1536, window 16);
  * ``_ring_write`` at a prompt longer than the ring and with an inactive
    (negative) position;
  * reduced ``recurrentgemma-9b`` logits at 6 layers (two groups) and at 8
    (two groups and a two-layer "rec" remainder), every bias and norm leaf
    drawn from a numpy seed; greedy tokens; decode past the window
    against the full forward (the reference's ring case);
  * one train step's loss and gradients against the reference's;
  * the continuous runtime against the reference's engine in tokens,
    evictions and decode steps, under both backends, with a re-admitted
    sequence longer than the window; ``write_prefill`` of rings and
    states bit-equal to the reference's; inactive slots' rings and states
    bit-equal across a paged step;
  * ``reference_ndims`` of grouped and remainder ``lambda``; the CLIs.

The reference runs its ``xla`` path.  Tolerances: logits, the scan and
attention atol = rtol = 1e-4 (float32 on both sides, sums in another
order; the scan and attention against the reference 1e-5); tokens,
evictions and step counts exactly; train-step loss, nll and grad_norm
1e-5 relative, gradient leaves atol 1e-5 / rtol 1e-4.
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
from repro.models import attention as j_attention
from repro.models import rglru as j_rglru
from repro.models.attention import PageSpec as JPageSpec
from repro.optim import adamw as j_adamw
from repro.optim import warmup_cosine as j_warmup_cosine
from repro.runtime import pages as j_pages
from repro.runtime.batching import (
    ContinuousBatchingEngine as JContinuousBatchingEngine)
from repro.runtime.batching import poisson_trace as j_poisson_trace
from repro.runtime.steps import make_prefill_step as j_make_prefill_step
from repro.runtime.steps import make_train_step as j_make_train_step

from repro_torch.configs import ModelConfig, get_config, list_configs, \
    reduced_config
from repro_torch.convert import params_from_jax_numpy, reference_ndims
from repro_torch.core import engine, use
from repro_torch.launch.serve import generate, main as serve_main
from repro_torch.launch.train import main as train_main
from repro_torch.models import EncoderDecoderModel, LanguageModel
from repro_torch.models.attention import (KVCache, PageSpec, _attention_seq,
                                          _ring_write, init_kv_cache)
from repro_torch.models.blocks import check_ported
from repro_torch.models.common import Init
from repro_torch.models.rglru import (RGLRU, RecurrentState, _rglru_scan,
                                      init_recurrent_state)
from repro_torch.optim import adamw, warmup_cosine
from repro_torch.runtime.batching import (ContinuousBatchingEngine,
                                          poisson_trace)
from repro_torch.runtime.pages import (PagePool, init_serving_cache,
                                       refresh_tables, write_prefill)
from repro_torch.runtime.steps import (make_paged_serve_step,
                                       make_prefill_step, make_train_step)

ARCH = "recurrentgemma-9b"
ATOL = 1e-4
BACKENDS = ["torch", "engine"]


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _as_port_config(jcfg):
    return ModelConfig(**{f: getattr(jcfg, f)
                          for f in ModelConfig.__dataclass_fields__})


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = torch.from_numpy(np.array(v, np.float32))
    return out


def _draw_biases_and_norms(tree, seed):
    """``tree`` (numpy leaves) with every linear bias (``b``), conv bias
    and norm scale redrawn: biases N(0, 0.2^2), scales 1 + N(0, 0.2^2)."""
    rng = np.random.default_rng(seed)
    drawn = []

    def walk(node, path):
        if isinstance(node, dict):
            return {k: walk(v, path + (k,)) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v, path + (str(i),))
                              for i, v in enumerate(node))
        in_norm = any("norm" in k for k in path[:-1])
        if path[-1] in ("b", "conv_b") or (in_norm and path[-1] == "scale"):
            drawn.append(".".join(path))
            base = 1.0 if path[-1] == "scale" else 0.0
            return (base + 0.2 * rng.standard_normal(node.shape)) \
                .astype(node.dtype)
        return node

    return walk(tree, ()), drawn


_SETUPS = {}


def _setup(layers=6, **overrides):
    """(jcfg, cfg, numpy params, JAX params, port model) for reduced
    recurrentgemma at ``layers`` layers, built once."""
    key = (layers, tuple(sorted(overrides.items())))
    if key not in _SETUPS:
        jcfg = j_reduced_config(j_get_config(ARCH), num_layers=layers,
                                **overrides)
        cfg = reduced_config(get_config(ARCH), num_layers=layers, **overrides)
        assert cfg == _as_port_config(jcfg)
        np_params, drawn = _draw_biases_and_norms(
            _np_tree(JLanguageModel.init(jax.random.PRNGKey(0), jcfg)), 7)
        assert drawn
        jparams = jax.tree.map(jnp.asarray, np_params)
        model = LanguageModel(cfg, device="cpu", seed=1)
        model.load_state_dict(params_from_jax_numpy(np_params, cfg, "cpu"),
                              strict=True)
        _SETUPS[key] = (jcfg, cfg, np_params, jparams, model)
    return _SETUPS[key]


def _tensors(leaf):
    """A ring's (k, v, pos) or a state's tensors."""
    return (leaf.k, leaf.v, leaf.pos) if isinstance(leaf, KVCache) \
        else tuple(leaf)


def _tokens(cfg, b, s, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32)


# ---------------------------------------------------------------------------
# config
# ---------------------------------------------------------------------------

def test_config_is_the_reference():
    jcfg, cfg = j_get_config(ARCH), get_config(ARCH)
    assert cfg == _as_port_config(jcfg)
    assert cfg.param_count() == jcfg.param_count()
    assert ARCH in list_configs()
    assert (cfg.num_layers, cfg.d_model, cfg.attn_window,
            cfg.block_pattern) == (38, 4096, 2048, ("rec", "rec", "local"))
    # 10.44 B parameters: fp32 masters of 41.8 GB
    assert round(4 * cfg.param_count() / 1e9, 1) == 41.8
    check_ported(cfg)


def test_unported_configurations_still_raise():
    """No reference configuration is refused any more: internvl2-1b builds
    as a ``LanguageModel`` with its frontend, seamless-m4t-large-v2 as an
    ``EncoderDecoderModel``; ``LanguageModel`` refuses the latter."""
    vision = _as_port_config(j_reduced_config(j_get_config("internvl2-1b")))
    assert LanguageModel(vision, device="cpu").frontend.cfg is vision
    encdec = _as_port_config(j_reduced_config(
        j_get_config("seamless-m4t-large-v2")))
    model = EncoderDecoderModel(encdec, device="cpu")
    assert all(b.cross is not None for b in model.decoder)
    with pytest.raises(ValueError, match="encoder-decoder"):
        LanguageModel(encdec, device="cpu")


def test_model_needs_the_card_unless_cpu_is_asked():
    cfg = reduced_config(get_config(ARCH))
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError):
        LanguageModel(cfg)
    assert LanguageModel(cfg, device="cpu").device.type == "cpu"


# ---------------------------------------------------------------------------
# RG-LRU
# ---------------------------------------------------------------------------

def _rglru_pair(seed=0):
    jcfg = j_reduced_config(j_get_config(ARCH))
    cfg = _as_port_config(jcfg)
    params = j_rglru.rglru_init(jax.random.PRNGKey(seed), jcfg)
    params = dict(params, conv_b=0.2 * jax.random.normal(
        jax.random.PRNGKey(seed + 1), params["conv_b"].shape))
    mod = RGLRU(cfg, Init(0, "cpu"))
    mod.load_state_dict(_flat(_np_tree(params)), strict=True)
    return jcfg, cfg, params, mod


def test_rglru_init_draws_the_reference_distributions():
    cfg = reduced_config(get_config(ARCH), rglru_width=4096)
    mod = RGLRU(cfg, Init(0, "cpu"))
    u = torch.sigmoid(mod.lam.detach()) ** 8  # the uniform draw
    assert 0.9 ** 2 - 1e-4 <= float(u.min()) < 0.82
    assert 0.997 < float(u.max()) <= 0.999 ** 2 + 1e-4
    assert {n for n, _ in mod.named_parameters()} == {
        "lin_y.w", "lin_y.b", "lin_x.w", "lin_x.b", "lin_out.w",
        "lin_out.b", "conv_w", "conv_b", "gate_a.w", "gate_a.b",
        "gate_x.w", "gate_x.b", "lambda"}
    st = init_recurrent_state(3, reduced_config(get_config(ARCH),
                                                dtype="float32"), "cpu")
    assert st.h.dtype == torch.float32 and st.conv.dtype == torch.bfloat16
    assert tuple(st.conv.shape) == (3, 3, 64)


@pytest.mark.parametrize("split", [None, 7, 11])
def test_rglru_apply_matches_reference(split):
    """Outputs and state against ``rglru_apply``; with ``split`` the
    sequence runs in two calls, the second from the first's state (12 =
    7 + 5; 11 + 1 takes the one-token decode branch)."""
    jcfg, cfg, params, mod = _rglru_pair()
    x = np.random.default_rng(1).standard_normal((2, 12, cfg.d_model)) \
        .astype(np.float32)
    st0 = j_rglru.init_recurrent_state(2, jcfg)
    y_full, jst = j_rglru.rglru_apply(params, jcfg, jnp.asarray(x), state=st0)
    tst = init_recurrent_state(2, cfg, "cpu")
    with torch.no_grad():
        if split is None:
            got, st = mod(torch.from_numpy(x), state=tst)
        else:
            y1, st = mod(torch.from_numpy(x[:, :split]), state=tst)
            y2, st = mod(torch.from_numpy(x[:, split:]), state=st)
            got = torch.cat([y1, y2], dim=1)
    np.testing.assert_allclose(got.numpy(), np.asarray(y_full), atol=ATOL,
                               rtol=ATOL)
    np.testing.assert_allclose(st.h.numpy(), np.asarray(jst.h), atol=ATOL,
                               rtol=ATOL)
    np.testing.assert_allclose(st.conv.float().numpy(),
                               np.asarray(jst.conv, np.float32), atol=1e-6)
    assert st.conv.dtype == torch.float32  # the activations' dtype


@pytest.mark.parametrize("s", [1, 2, 11, 64, 37, 1537])
@pytest.mark.parametrize("with_h0", [False, True])
def test_rglru_scan_matches_reference_and_loop(s, with_h0):
    rng = np.random.default_rng(s)
    a = rng.uniform(0.5, 0.99, (2, s, 8)).astype(np.float32)
    xs = rng.standard_normal((2, s, 8)).astype(np.float32)
    h0 = rng.standard_normal((2, 8)).astype(np.float32) if with_h0 else None
    log_a = np.log(a)
    want = j_rglru._rglru_scan(jnp.asarray(xs), jnp.asarray(log_a),
                               None if h0 is None else jnp.asarray(h0))
    got = _rglru_scan(torch.from_numpy(xs), torch.from_numpy(log_a),
                      None if h0 is None else torch.from_numpy(h0))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)
    h = torch.zeros(2, 8) if h0 is None else torch.from_numpy(h0)
    loop = []
    for t in range(s):
        h = torch.exp(torch.from_numpy(log_a[:, t])) * h \
            + torch.from_numpy(xs[:, t])
        loop.append(h)
    np.testing.assert_allclose(got.numpy(), torch.stack(loop, 1).numpy(),
                               atol=1e-4, rtol=1e-4)


# ---------------------------------------------------------------------------
# sliding-window attention and the ring
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sq,window", [(40, 16), (512, 16), (1536, 16),
                                       (1536, 600), (1536, None)])
def test_windowed_attention_seq_matches_reference(sq, window):
    """sq <= 512: one chunk; 1536 with window 16: the sliding path (each
    512-query chunk over a 528-key slice); window 600 < 1536 - 512 slides
    too; no window: the full-K chunk path."""
    rng = np.random.default_rng(sq + (window or 0))
    q, k, v = (rng.standard_normal((1, sq, 2, 8)).astype(np.float32)
               for _ in range(3))
    pos = np.arange(sq, dtype=np.int32)
    with jcore.use(backend="xla"):
        want = j_attention._attention_seq(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(pos),
            jnp.asarray(pos), window, None)
    with use(backend="torch", device="cpu"):
        got = _attention_seq(torch.from_numpy(q), torch.from_numpy(k),
                             torch.from_numpy(v), torch.from_numpy(pos),
                             window, None)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


def test_windowed_attention_grad_checkpoints_each_chunk():
    """With gradients on, the chunked path's values and gradients are the
    ones without (the chunks only recompute)."""
    rng = np.random.default_rng(5)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 1100, 2, 8))
                                .astype(np.float32)).requires_grad_()
               for _ in range(3))
    pos = torch.arange(1100, dtype=torch.int32)
    with use(backend="torch", device="cpu"):
        out = _attention_seq(q, k, v, pos, 16, None)
        grads = torch.autograd.grad(out.square().sum(), (q, k, v))
        with torch.no_grad():
            plain = _attention_seq(q, k, v, pos, 16, None)
    assert torch.equal(out.detach(), plain)
    assert all(torch.isfinite(g).all() and g.abs().sum() > 0 for g in grads)


def test_ring_write_keeps_the_last_positions_and_drops_inactive_rows():
    cap = 4
    cache = init_kv_cache(2, cap, 1, 2, torch.float32, "cpu")
    s = 10  # longer than the ring: positions 6..9 must land
    k = torch.arange(2 * s * 2, dtype=torch.float32).reshape(2, s, 1, 2)
    _ring_write(cache, k, -k, torch.arange(s, dtype=torch.int32)[None])
    for row in range(2):
        for p in range(6, 10):
            assert int(cache.pos[row, p % cap]) == p
            assert torch.equal(cache.k[row, p % cap], k[row, p])
            assert torch.equal(cache.v[row, p % cap], -k[row, p])
    before = (cache.k.clone(), cache.v.clone(), cache.pos.clone())
    new = torch.full((2, 1, 1, 2), 99.0)
    # row 0 active at position 10, row 1 inactive (-1)
    _ring_write(cache, new, new, torch.tensor([[10], [-1]],
                                              dtype=torch.int32))
    assert int(cache.pos[0, 10 % cap]) == 10
    assert torch.equal(cache.k[0, 10 % cap], new[0, 0])
    assert torch.equal(cache.k[1], before[0][1])
    assert torch.equal(cache.v[1], before[1][1])
    assert torch.equal(cache.pos[1], before[2][1])


def test_ring_prefill_matches_the_reference_ring():
    """A 40-token prefill into a 16-row ring (window 16): the ring the
    port keeps is the reference's (its XLA scatter keeps the last of the
    duplicate writes)."""
    jcfg, cfg, _, jparams, model = _setup()
    toks = _tokens(cfg, 1, 40, seed=3)
    with jcore.use(backend="xla"):
        _, jcache = jax.jit(j_make_prefill_step(jcfg, 40))(
            jparams, {"tokens": jnp.asarray(toks)})
    with use(backend="torch", device="cpu"):
        _, cache = make_prefill_step(model, 40)(
            {"tokens": torch.from_numpy(toks).long()})
    local = cache[2]
    assert isinstance(local, KVCache) and local.k.shape[1] == 16
    want = jcache["groups"]["b2"]
    np.testing.assert_array_equal(local.pos.numpy(), np.asarray(want.pos[0]))
    np.testing.assert_allclose(local.k.numpy(), np.asarray(want.k[0]),
                               atol=1e-5, rtol=1e-5)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("layers", [6, 8])
def test_logits_match_reference(layers, backend):
    jcfg, cfg, _, jparams, model = _setup(layers)
    toks = _tokens(cfg, 2, 40)
    with jcore.use(backend="xla"):
        want, _, _ = JLanguageModel.apply(jparams, jcfg, jnp.asarray(toks))
    with use(backend=backend, device="cpu"), torch.no_grad():
        engine.reset_stats()
        got, _, _ = model.apply(torch.from_numpy(toks).long())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=ATOL)
    if backend == "engine":
        st = engine.stats()
        kinds = [cfg.block_pattern[i % 3] for i in range(layers)]
        want_gemm = sum(5 if k == "rec" else 4 for k in kinds) \
            + 3 * layers + 1
        assert st["gemm"]["launches"] == want_gemm
        assert st.get("flash_attention", {}).get("launches", 0) == 0


def test_long_prompt_logits_match_reference():
    """1,536 tokens: the local layers take the sliding path."""
    jcfg, cfg, _, jparams, model = _setup()
    toks = _tokens(cfg, 1, 1536, seed=2)
    with jcore.use(backend="xla"):
        want, _, _ = JLanguageModel.apply(jparams, jcfg, jnp.asarray(toks))
    with use(backend="engine", device="cpu"), torch.no_grad():
        got, _, _ = model.apply(torch.from_numpy(toks).long())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=ATOL)


@pytest.mark.parametrize("layers", [6, 8])
def test_generate_tokens_identical_to_reference(layers):
    jcfg, cfg, _, jparams, model = _setup(layers)
    toks = _tokens(cfg, 2, 21, seed=4)  # 21 + 8 positions: past the window
    with jcore.use(backend="xla"):
        want = np.asarray(j_generate(jcfg, jparams, jnp.asarray(toks),
                                     8)["tokens"])
    for backend in BACKENDS:
        with use(backend=backend, device="cpu"):
            res = generate(model, torch.from_numpy(toks), 8)
        np.testing.assert_array_equal(res["tokens"].numpy(), want)


@pytest.mark.parametrize("backend", BACKENDS)
def test_decode_past_the_window_matches_full_forward(backend):
    """The reference's ``test_ring_buffer_window_cache``: 39 prefilled
    tokens into a 16-row ring, then decode steps whose logits equal the
    full forward's at every position."""
    _, cfg, _, _, model = _setup()
    toks = torch.from_numpy(_tokens(cfg, 1, 44, seed=5)).long()
    with use(backend=backend, device="cpu"), torch.no_grad():
        full, _, _ = model.apply(toks)
        cache = model.init_cache(1, 44)
        assert cache[2].k.shape[1] == cfg.attn_window
        _, cache, _ = model.apply(toks[:, :39], cache=cache)
        for t in range(39, 44):
            dec, cache, _ = model.apply(
                toks[:, t:t + 1], positions=torch.tensor([t]), cache=cache)
            assert float((full[:, t] - dec[:, 0]).abs().max()) < 2e-4


def _spy(opt, box, convert):
    def update(grads, *args, **kw):
        box["grads"] = convert(grads)
        return opt.update(grads, *args, **kw)
    return type(opt)(opt.init, update)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("layers", [6, 8])
def test_train_step_matches_reference(layers, backend):
    """One train step on a batch of 2 x 16: loss, nll, grad_norm and every
    gradient leaf (``lambda``, the conv and the drawn biases included)."""
    jcfg, cfg, np_params, jparams, _ = _setup(layers)
    batch = JSyntheticLMDataset(jcfg.vocab_size, 16, 2).host_batch(0)
    j_box, box = {}, {}
    j_opt = _spy(j_adamw(j_warmup_cosine(3e-3, 1, 10)), j_box,
                 lambda g: params_from_jax_numpy(_np_tree(g), cfg, "cpu"))
    with jcore.use(backend="xla"):
        _, _, want = j_make_train_step(jcfg, j_opt)(
            jparams, j_opt.init(jparams),
            {k: jnp.asarray(v) for k, v in batch.items()}, jnp.asarray(0))
    model = LanguageModel(cfg, device="cpu", seed=1)
    model.load_state_dict(params_from_jax_numpy(np_params, cfg, "cpu"))
    opt = _spy(adamw(warmup_cosine(3e-3, 1, 10)), box,
               lambda g: {k: v.clone() for k, v in g.items()})
    with use(backend=backend, device="cpu"):
        got = make_train_step(cfg, opt)(
            model, opt.init(dict(model.named_parameters())),
            {k: torch.from_numpy(v) for k, v in batch.items()}, 0)
    for key in ("loss", "nll", "grad_norm", "lr"):
        np.testing.assert_allclose(float(got[key]), float(want[key]),
                                   rtol=1e-5, err_msg=key)
    assert set(box["grads"]) == set(j_box["grads"])
    for name, g in box["grads"].items():
        np.testing.assert_allclose(g.numpy(), j_box["grads"][name].numpy(),
                                   atol=1e-5, rtol=1e-4, err_msg=name)


def test_weight_decay_ranks_of_grouped_and_remainder_lambda():
    """``lambda`` and ``conv_b`` of a grouped layer are 2-D in the
    reference (stacked) and so decayed; a remainder layer's are 1-D."""
    _, cfg, np_params, _, model = _setup(8)
    want = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(np_params)[0]:
        keys = [str(getattr(k, "key", getattr(k, "idx", k))) for k in path]
        if keys[:2] == ["blocks", "groups"]:
            for g in range(2):
                layer = 3 * g + int(keys[2][1:])
                want[".".join(["blocks", str(layer)] + keys[3:])] = leaf.ndim
        elif keys[:2] == ["blocks", "rem"]:
            want[".".join(["blocks", str(6 + int(keys[2]))] + keys[3:])] = \
                leaf.ndim
        else:
            want[".".join(keys)] = leaf.ndim
    got = reference_ndims(cfg, model)
    assert got == want
    assert got["blocks.0.mixer.lambda"] == 2
    assert got["blocks.0.mixer.conv_b"] == 2
    assert got["blocks.6.mixer.lambda"] == 1
    assert got["blocks.7.mixer.conv_b"] == 1


# ---------------------------------------------------------------------------
# continuous batching
# ---------------------------------------------------------------------------

RUN_CASES = {
    # the staggered case of tests/test_torch_serving.py
    "staggered": (dict(num_requests=5, rate=0.5, prompt_lens=(6, 12),
                       max_new=(2, 7), seed=3), 3, (24, 8, 6)),
    # prompts of 20-30 tokens (past the window of 16) over a pool that
    # evicts: a re-admitted context is longer than the window
    "evict_long": (dict(num_requests=4, rate=2.0, prompt_lens=(20, 30),
                        max_new=8, seed=1), 3, (7, 8, 5)),
}
_WANT = {}


def _reference_run(case):
    if case not in _WANT:
        jcfg, _, _, jparams, _ = _setup()
        trace, slots, spec = RUN_CASES[case]
        reqs = j_poisson_trace(vocab_size=jcfg.vocab_size, **trace)
        with jcore.use(backend="xla"):
            _WANT[case] = JContinuousBatchingEngine(
                jcfg, jparams, num_slots=slots, spec=JPageSpec(*spec)).run(reqs)
    return _WANT[case]


@pytest.mark.parametrize("case", sorted(RUN_CASES))
@pytest.mark.parametrize("backend", BACKENDS)
def test_continuous_run_matches_reference(backend, case):
    _, cfg, _, _, model = _setup()
    want = _reference_run(case)
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
    if case == "evict_long":
        assert got["metrics"]["evictions"] > 0
        readmitted = [r for r in reqs if got["evictions"][r.rid]]
        assert readmitted and all(len(r.prompt) > cfg.attn_window
                                  for r in readmitted)
    serving.pool.check_invariants([0] * slots)
    assert serving.pool.free_pages == spec[0]


def test_write_prefill_of_rings_and_states_is_the_reference():
    """The reference's own dense prefill caches of a 40-token and then a
    10-token sequence, written into one slot (the second over the first:
    the ring must be reset), equal the reference's serving cache bit for
    bit: rings re-slotted by position, RG-LRU states cast to the serving
    leaf's dtype (the conv tail to bf16)."""
    jcfg, cfg, _, jparams, model = _setup()
    spec = (12, 8, 6)
    jserving = j_pages.init_serving_cache(jcfg, 2, JPageSpec(*spec))
    serving = init_serving_cache(model, 2, PageSpec(*spec))
    for L, seed in ((40, 8), (10, 9)):
        toks = _tokens(cfg, 1, L, seed)
        with jcore.use(backend="xla"):
            _, jdense = jax.jit(j_make_prefill_step(jcfg, L))(
                jparams, {"tokens": jnp.asarray(toks)})
        jserving = j_pages.write_prefill(jserving, jdense, slot=1, length=L,
                                         page_ids=list(range((L + 7) // 8)),
                                         page_size=8)
        dense = [KVCache(*(torch.from_numpy(np.array(a[g]))
                           for a in jdense["groups"][f"b{i}"]))
                 if i == 2 else RecurrentState(*(torch.from_numpy(
                     np.asarray(a[g], np.float32)).to(
                     torch.bfloat16 if a.dtype == jnp.bfloat16
                     else torch.float32)
                     for a in jdense["groups"][f"b{i}"]))
                 for g in range(2) for i in range(3)]
        write_prefill(serving, dense, slot=1, length=L,
                      page_ids=list(range((L + 7) // 8)), page_size=8)
    for layer, leaf in enumerate(serving):
        want = jserving["groups"][f"b{layer % 3}"]
        for got, w in zip(_tensors(leaf), want):
            w = np.asarray(w[layer // 3])
            assert got.dtype == (torch.bfloat16 if w.dtype == jnp.bfloat16
                                 else torch.int32 if w.dtype == np.int32
                                 else torch.float32)
            np.testing.assert_array_equal(got.float().numpy(),
                                          w.astype(np.float32))
    assert int((serving[2].pos[1] >= 0).sum()) == 10


def test_inactive_slots_keep_rings_and_states():
    """A paged step with slot 1 inactive: its ring rows, RG-LRU ``h`` and
    conv tail are bit-equal afterwards, slot 0's are updated; the conv
    tail is promoted to the activations' dtype (fp32), as ``jnp.where``
    promotes it."""
    _, cfg, _, _, model = _setup()
    spec = PageSpec(12, 8, 6)
    with use(backend="torch", device="cpu"), torch.no_grad():
        cache = init_serving_cache(model, 2, spec)
        pool = PagePool(spec, 2)
        for slot, L in ((0, 20), (1, 12)):
            toks = torch.from_numpy(_tokens(cfg, 1, L, seed=slot)).long()
            _, dense = make_prefill_step(model, L)({"tokens": toks})
            write_prefill(cache, dense, slot=slot, length=L,
                          page_ids=pool.grow(slot, L), page_size=8)
        refresh_tables(cache, pool.tables)
        before = [tuple(t.clone() for t in _tensors(leaf)) for leaf in cache]
        _, new, lengths = make_paged_serve_step(model)(
            cache, torch.tensor([[3], [4]]), torch.tensor([20, 12]),
            torch.tensor([True, False]))
    assert lengths.tolist() == [21, 12]
    for old, leaf in zip(before, new):
        for o, n in zip(old, _tensors(leaf)):
            assert torch.equal(n[1].to(o.dtype), o[1])
        assert not all(torch.equal(n[0].to(o.dtype), o[0])
                       for o, n in zip(old, _tensors(leaf)))
    assert new[0].conv.dtype == torch.float32


def test_serve_and_train_clis_on_cpu(capsys, tmp_path):
    from repro_torch.core import configure, get_config as engine_config
    before = engine_config()
    try:
        serve_main(["--arch", ARCH, "--device", "cpu", "--batch", "2",
                    "--prompt-len", "20", "--gen", "4"])
        serve_main(["--arch", ARCH, "--device", "cpu", "--continuous",
                    "--prompt-len", "20", "--gen", "4"])
        train_main(["--arch", ARCH, "--device", "cpu", "--steps", "2",
                    "--seq", "32", "--batch", "2", "--ckpt-dir",
                    str(tmp_path)])
    finally:
        configure(device=before.device, backend=before.backend,
                  fused=before.fused)
    out = capsys.readouterr().out
    assert f"arch={ARCH}" in out
    assert "token_identical" in out or "identical" in out
    assert "nll:" in out
