"""SeamlessM4T-large-v2 (the encoder-decoder: an audio adapter, a
bidirectional encoder, a decoder with cross-attention, LayerNorm) in the
port against the reference, on the CPU, at reduced size (2 encoder and 2
decoder layers, width 64, 32 features a frame), from the same
JAX-initialised parameters (carried over by ``repro_torch.convert``) with
every bias and norm leaf drawn from a numpy seed:

  * the configuration and its parameter count (1.833 B);
  * the frontend's adapter, ``encode`` and cross-attention
    (``attention_apply(kv_override=...)``, with RoPE on the query only);
  * teacher-forced logits, the port under ``torch`` and ``engine`` (plain
    kernel versions on the CPU) against the reference's ``xla`` path;
  * prefill + decode steps with ``enc_out`` carried against the full
    forward (at tests/test_decode_consistency.py's 2e-4), and greedy
    tokens through the reference's and the port's prefill and serve steps;
  * one train step (loss, nll, grad_norm, every gradient leaf, the updated
    parameters), remat gradients bit-equal to none;
  * ``reference_ndims`` / ``reference_shapes`` of the stacked encoder
    leaves (a norm scale is 2-D in the reference, so AdamW decays it) and
    ``scalable_adamw``'s factored leaves and updates;
  * the untied read-out over a vocab whose weight rows TMA cannot read
    (a zero-padded copy; logits, values and gradients unchanged);
  * the non-causal flash attention at ``sq = 1`` and ``sq != sk`` against
    the reference's Pallas kernel in interpret mode;
  * the refusals: ``generate``, continuous batching and both CLIs.

Tolerances: logits, ``encode`` and attention atol = rtol = 1e-4 (float32
on both sides, sums in another order); flash 2e-3 (tests/test_torch_flash.py,
the reference's TPU plans against the port's H100 plans); train-step loss,
nll and grad_norm 1e-5 relative, gradient leaves atol 1e-5 / rtol 1e-4,
parameters updated from the same gradients atol 1e-6; tokens exactly.
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
from repro.kernels.flash_attention import flash_attention as j_flash
from repro.models import EncoderDecoderModel as JEncoderDecoderModel
from repro.models.attention import attention_apply as j_attention_apply
from repro.models.frontends import frontend_apply as j_frontend_apply
from repro.optim import adamw as j_adamw
from repro.optim import scalable_adamw as j_scalable_adamw
from repro.optim import warmup_cosine as j_warmup_cosine
from repro.runtime.steps import make_prefill_step as j_make_prefill_step
from repro.runtime.steps import make_serve_step as j_make_serve_step
from repro.runtime.steps import make_train_step as j_make_train_step

from repro_torch.configs import ModelConfig, get_config, list_configs, \
    reduced_config
from repro_torch.convert import (opt_state_from_jax_numpy,
                                 params_from_jax_numpy, reference_ndims,
                                 reference_shapes)
from repro_torch.core import use
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.launch.serve import generate, main as serve_main
from repro_torch.launch.train import main as train_main
from repro_torch.models import EncoderDecoderModel
from repro_torch.models.attention import Attention, PageSpec
from repro_torch.models.blocks import check_ported
from repro_torch.models.common import Init
from repro_torch.optim import (adamw, is_factored_leaf, scalable_adamw,
                               warmup_cosine)
from repro_torch.runtime.batching import ContinuousBatchingEngine
from repro_torch.runtime.steps import (make_loss_fn, make_prefill_step,
                                       make_serve_step, make_train_step,
                                       model_for)

ARCH = "seamless-m4t-large-v2"
ATOL = 1e-4
BACKENDS = ["torch", "engine"]
S_ENC = 13  # encoder frames of the reduced cases


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _as_port_config(jcfg):
    return ModelConfig(**{f: getattr(jcfg, f)
                          for f in ModelConfig.__dataclass_fields__})


def _draw_biases_and_norms(tree, seed):
    """``tree`` (numpy leaves) with every linear bias (``b``) and norm leaf
    redrawn: biases N(0, 0.2^2), scales 1 + N(0, 0.2^2).  Returns (tree,
    the drawn leaves' paths)."""
    rng = np.random.default_rng(seed)
    drawn = []

    def walk(node, path):
        if isinstance(node, dict):
            return {k: walk(v, path + (k,)) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v, path + (str(i),))
                              for i, v in enumerate(node))
        in_norm = any("norm" in k for k in path[:-1])
        if path[-1] == "b" or (in_norm and path[-1] in ("scale", "bias")):
            drawn.append(".".join(path))
            base = 1.0 if path[-1] == "scale" else 0.0
            return (base + 0.2 * rng.standard_normal(node.shape)) \
                .astype(node.dtype)
        return node

    return walk(tree, ()), drawn


_SETUPS = {}


def _setup(**overrides):
    """(jcfg, cfg, numpy params, JAX params, port model), built once per
    set of overrides."""
    key = tuple(sorted(overrides.items()))
    if key not in _SETUPS:
        jcfg = j_reduced_config(j_get_config(ARCH), **overrides)
        cfg = reduced_config(get_config(ARCH), **overrides)
        assert cfg == _as_port_config(jcfg)
        np_params, drawn = _draw_biases_and_norms(
            _np_tree(JEncoderDecoderModel.init(jax.random.PRNGKey(0), jcfg)),
            7)
        assert {"frontend.adapter.b", "enc_norm.bias",
                "encoder.norm_attn.scale"} <= set(drawn)
        jparams = jax.tree.map(jnp.asarray, np_params)
        _SETUPS[key] = (jcfg, cfg, np_params, jparams,
                        _model(cfg, np_params))
    return _SETUPS[key]


def _model(cfg, np_params):
    model = EncoderDecoderModel(cfg, device="cpu", seed=1)
    model.load_state_dict(params_from_jax_numpy(np_params, cfg, "cpu"),
                          strict=True)
    return model


def _tokens(cfg, b, s, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32)


def _feats(cfg, b, s=S_ENC, seed=1):
    return np.random.default_rng(seed).standard_normal(
        (b, s, cfg.modality_dim)).astype(np.float32)


# ---------------------------------------------------------------------------
# config, frontend, encoder, cross-attention
# ---------------------------------------------------------------------------

def test_config_is_the_reference():
    jcfg, cfg = j_get_config(ARCH), get_config(ARCH)
    assert cfg == _as_port_config(jcfg)
    assert cfg.param_count() == jcfg.param_count()
    assert round(cfg.param_count() / 1e9, 3) == 1.833
    assert ARCH in list_configs()
    assert (cfg.num_layers, cfg.num_encoder_layers, cfg.head_dim,
            cfg.norm_type, cfg.mlp_act, cfg.rope) == \
        (24, 24, 64, "layernorm", "relu", False)
    check_ported(cfg)
    assert model_for(cfg) is EncoderDecoderModel


def test_frontend_and_encode_match_reference():
    jcfg, cfg, _, jparams, model = _setup()
    feats = _feats(cfg, 2)
    want_x = j_frontend_apply(jparams["frontend"], jcfg, jnp.asarray(feats))
    with jcore.use(backend="xla"):
        want = JEncoderDecoderModel.encode(jparams, jcfg, jnp.asarray(feats))
    for backend in BACKENDS:
        with use(backend=backend, device="cpu"), torch.no_grad():
            x = model.frontend(torch.from_numpy(feats))
            got = model.encode(torch.from_numpy(feats))
        np.testing.assert_allclose(x.numpy(), np.asarray(want_x), atol=ATOL,
                                   rtol=ATOL)
        assert got.shape == (2, S_ENC, cfg.d_model)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                                   rtol=ATOL, err_msg=backend)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("rope", [False, True])
@pytest.mark.parametrize("sq", [1, 5])
def test_cross_attention_matches_reference(sq, rope, backend):
    """``kv_override`` of sk = 9 rows: every key visible, RoPE (when on)
    turning q at its positions and never k; no cache comes back."""
    jcfg = dataclasses.replace(j_reduced_config(j_get_config(ARCH)),
                               rope=rope)
    cfg = _as_port_config(jcfg)
    from repro.models.attention import attention_init
    params = attention_init(jax.random.PRNGKey(3), jcfg, cross=True)
    rng = np.random.default_rng(sq)
    x = rng.standard_normal((2, sq, cfg.d_model)).astype(np.float32)
    kv = rng.standard_normal((2, 9, cfg.d_model)).astype(np.float32)
    pos = np.arange(4, 4 + sq, dtype=np.int32)
    with jcore.use(backend="xla"):
        want, _ = j_attention_apply(params, jcfg, jnp.asarray(x),
                                    jnp.asarray(pos),
                                    kv_override=jnp.asarray(kv))
    mod = Attention(cfg, Init(0, "cpu"))
    mod.load_state_dict({f"{k}.{leaf}": torch.from_numpy(np.array(v))
                         for k, d in params.items() for leaf, v in d.items()},
                        strict=True)
    with use(backend=backend, device="cpu"), torch.no_grad():
        got, cache = mod(torch.from_numpy(x), torch.from_numpy(pos),
                         kv_override=torch.from_numpy(kv))
    assert cache is None
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=ATOL)



# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("vocab", [None, 509])
@pytest.mark.parametrize("backend", BACKENDS)
def test_logits_match_reference(backend, vocab):
    """Also at a vocab whose weight rows are not a whole number of 16 bytes
    (509 fp32 columns, as seamless's 256,206 bf16 ones): the read-out runs
    over a zero-padded copy, the logits a view of its first 509 columns."""
    jcfg, cfg, _, jparams, model = _setup(
        **({} if vocab is None else {"vocab_size": vocab}))
    toks, feats = _tokens(cfg, 2, 11), _feats(cfg, 2)
    with jcore.use(backend="xla"):
        want, _, _ = JEncoderDecoderModel.apply(jparams, jcfg,
                                                jnp.asarray(toks),
                                                jnp.asarray(feats))
    with use(backend=backend, device="cpu"), torch.no_grad():
        got, _, _ = model.apply(torch.from_numpy(toks).long(),
                                torch.from_numpy(feats))
        enc = model.encode(torch.from_numpy(feats))
        again, _, _ = model.apply(torch.from_numpy(toks).long(), enc_out=enc)
    assert got.shape[-1] == cfg.vocab_size
    assert got.stride(1) == -(-cfg.vocab_size // 4) * 4
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=ATOL)
    assert torch.equal(got, again)
    with pytest.raises(ValueError, match="enc_out"):
        model.apply(torch.from_numpy(toks).long())


@pytest.mark.parametrize("backend", BACKENDS)
def test_prefill_then_decode_with_enc_out_matches_full(backend):
    """The encoder runs once; 7 of 11 tokens are prefilled with its output
    into a cache of 11 rows, then 4 decode steps each pass it again: every
    position's logits within 2e-4 of the full forward's."""
    _, cfg, _, _, model = _setup()
    b, s, pre_len = 2, 11, 7
    toks = torch.from_numpy(_tokens(cfg, b, s, seed=2)).long()
    feats = torch.from_numpy(_feats(cfg, b, seed=3))
    with use(backend=backend, device="cpu"), torch.no_grad():
        full, _, _ = model.apply(toks, feats)
        enc = model.encode(feats)
        cache = model.init_cache(b, s)
        pre, cache, _ = model.apply(toks[:, :pre_len], enc_out=enc,
                                    positions=torch.arange(pre_len),
                                    cache=cache)
        steps = []
        for t in range(pre_len, s):
            dec, cache, _ = model.apply(toks[:, t:t + 1], enc_out=enc,
                                        positions=torch.tensor([t]),
                                        cache=cache)
            steps.append(dec)
    assert float((full[:, :pre_len] - pre).abs().max()) < 2e-4
    assert float((full[:, pre_len:] - torch.cat(steps, 1)).abs().max()) \
        < 2e-4


def test_greedy_tokens_through_the_steps_match_reference():
    """Greedy decoding through each package's prefill step (with the
    encoder's output in the batch) and serve step (passing it again): the
    same 6 tokens under both backends."""
    jcfg, cfg, _, jparams, model = _setup()
    toks, feats = _tokens(cfg, 2, 9, seed=4), _feats(cfg, 2, seed=5)
    gen, cap = 6, 9 + 6
    with jcore.use(backend="xla"):
        enc = JEncoderDecoderModel.encode(jparams, jcfg, jnp.asarray(feats))
        logits, cache = j_make_prefill_step(jcfg, cap)(
            jparams, {"tokens": jnp.asarray(toks), "enc_out": enc})
        serve = j_make_serve_step(jcfg)
        tok, pos, want = jnp.argmax(logits, -1)[:, None], jnp.asarray(9), []
        for _ in range(gen):
            want.append(np.asarray(tok))
            logits, cache, pos = serve(jparams, cache, tok, pos, enc)
            tok = jnp.argmax(logits, -1)[:, None]
    want = np.concatenate(want, 1)
    for backend in BACKENDS:
        with use(backend=backend, device="cpu"):
            enc = model.encode(torch.from_numpy(feats))
            logits, cache = make_prefill_step(model, cap)(
                {"tokens": torch.from_numpy(toks).long(), "enc_out": enc})
            serve = make_serve_step(model)
            tok, pos, got = torch.argmax(logits, -1)[:, None], \
                torch.tensor(9, dtype=torch.int32), []
            for _ in range(gen):
                got.append(tok)
                logits, cache, pos = serve(cache, tok, pos, enc)
                tok = torch.argmax(logits, -1)[:, None]
        np.testing.assert_array_equal(torch.cat(got, 1).numpy(), want,
                                      err_msg=backend)


def _spy(opt, box, convert):
    def update(grads, *args, **kw):
        box["grads"] = convert(grads)
        return opt.update(grads, *args, **kw)
    return type(opt)(opt.init, update)


def _train_batch(cfg, seed=6):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (2, 11)).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:],
            "modality_feats": _feats(cfg, 2, seed=seed + 1)}


@pytest.mark.parametrize("backend", BACKENDS)
def test_train_step_matches_reference(backend):
    """One train step on 2 x 10 tokens over 13 frames: loss, nll,
    grad_norm, every gradient leaf (the adapter's, the encoder's and the
    cross-attention's included), then the parameters AdamW gives from the
    reference's gradients with each leaf's reference rank deciding its
    decay (the stacked encoder norms' are decayed)."""
    jcfg, cfg, np_params, jparams, _ = _setup()
    batch = _train_batch(cfg)
    j_box, box = {}, {}
    j_opt = _spy(j_adamw(j_warmup_cosine(3e-3, 1, 10)), j_box,
                 lambda g: params_from_jax_numpy(_np_tree(g), cfg, "cpu"))
    with jcore.use(backend="xla"):
        j_new, _, want = j_make_train_step(jcfg, j_opt)(
            jparams, j_opt.init(jparams),
            {k: jnp.asarray(v) for k, v in batch.items()}, jnp.asarray(0))
    model = _model(cfg, np_params)
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
    assert {"frontend.adapter.w", "encoder.1.attn.wq.w",
            "decoder.0.cross.wk.w"} <= set(box["grads"])
    for name, g in box["grads"].items():
        np.testing.assert_allclose(g.numpy(), j_box["grads"][name].numpy(),
                                   atol=1e-5, rtol=1e-4, err_msg=name)
    model = _model(cfg, np_params)
    params = dict(model.named_parameters())
    opt = adamw(warmup_cosine(3e-3, 1, 10))
    with torch.no_grad():
        opt.update(j_box["grads"], opt.init(params), params, 0,
                   ndims=reference_ndims(cfg, model))
    new = params_from_jax_numpy(_np_tree(j_new), cfg, "cpu")
    for name, p in params.items():
        np.testing.assert_allclose(p.detach().numpy(), new[name].numpy(),
                                   atol=1e-6, rtol=0, err_msg=name)


@pytest.mark.parametrize("backend", BACKENDS)
def test_remat_gradients_bit_equal_to_no_remat(backend):
    """With ``cfg.remat`` every encoder layer and every decoder group runs
    under a checkpoint (the decoder's recompute sees the same ``enc_out``):
    loss and every gradient bit-equal to a run without."""
    _, cfg, np_params, _, _ = _setup()
    batch = {k: torch.from_numpy(v) for k, v in _train_batch(cfg).items()}
    out = {}
    for remat in (False, True):
        c = dataclasses.replace(cfg, remat=remat)
        model = _model(c, np_params)
        with use(backend=backend, device="cpu"):
            total, _ = make_loss_fn(c)(model, batch)
            grads = torch.autograd.grad(total, list(model.parameters()))
        out[remat] = (total, dict(zip(
            (n for n, _ in model.named_parameters()), grads)))
    assert torch.equal(out[False][0], out[True][0])
    for name, g in out[False][1].items():
        assert torch.equal(g, out[True][1][name]), name


def test_reference_ranks_of_the_stacked_encoder():
    """The reference stacks the encoder's layers on one axis (``vmap``) and
    the decoder's in groups: a norm scale is (L, d) there, rank 2, so its
    AdamW decays it and ``scalable_adamw`` factors by those shapes."""
    _, cfg, np_params, _, model = _setup()
    want = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(np_params)[0]:
        keys = [str(getattr(k, "key", getattr(k, "idx", k))) for k in path]
        if keys[0] == "encoder":
            for layer in range(cfg.num_encoder_layers):
                want[".".join(["encoder", str(layer)] + keys[1:])] = leaf.ndim
        elif keys[:2] == ["decoder", "groups"]:
            for layer in range(cfg.num_layers):
                want[".".join(["decoder", str(layer)] + keys[3:])] = leaf.ndim
        else:
            want[".".join(keys)] = leaf.ndim
    got = reference_ndims(cfg, model)
    assert got == want
    assert got["encoder.1.norm_attn.scale"] == 2
    assert got["decoder.0.norm_cross.bias"] == 2
    assert got["enc_norm.scale"] == 1 and got["frontend.adapter.b"] == 1
    assert reference_shapes(cfg, model)["encoder.0.attn.wq.w"] == \
        (cfg.num_encoder_layers, cfg.d_model, cfg.num_heads * cfg.head_dim)
    # The decay that follows: a zero gradient leaves a rank-1 leaf where
    # it is and shrinks a stacked norm scale by lr x 0.1 x p.
    params = {k: p.detach().clone() for k, p in model.named_parameters()}
    opt = adamw(1e-2, max_grad_norm=None)
    opt.update({k: torch.zeros_like(p) for k, p in params.items()},
               opt.init(params), params, 0, ndims=got)
    for k in ("enc_norm.scale", "frontend.adapter.b"):
        assert torch.equal(params[k], dict(model.named_parameters())[k])
    p0 = dict(model.named_parameters())["encoder.0.norm_ff.scale"]
    torch.testing.assert_close(params["encoder.0.norm_ff.scale"],
                               p0.detach() * (1 - 1e-3), rtol=1e-6, atol=0)


# Wide enough that the encoder's and decoder's matrices are factored (both
# trailing dims >= 128).
WIDE = dict(d_model=128, d_ff=256, num_heads=4, head_dim=32)


def test_scalable_adamw_factors_and_steps_as_reference():
    """``scalable_adamw`` on the stacked encoder and decoder: the same
    leaves factored (per layer in the port, per stack in the reference),
    and two updates fed the same gradients give the reference's
    parameters."""
    jcfg, cfg, np_params, jparams, _ = _setup(**WIDE)
    rng = np.random.default_rng(8)
    grads = [jax.tree.map(lambda x: (rng.standard_normal(x.shape) * 1e-3)
                          .astype(np.float32), np_params) for _ in range(2)]
    j_opt = j_scalable_adamw(j_warmup_cosine(1e-2, 1, 10))
    j_state, j_params = j_opt.init(jparams), jparams
    for step, g in enumerate(grads):
        j_params, j_state, _ = j_opt.update(
            jax.tree.map(jnp.asarray, g), j_state, j_params,
            jnp.asarray(step))
    model = _model(cfg, np_params)
    p = dict(model.named_parameters())
    opt = scalable_adamw(warmup_cosine(1e-2, 1, 10))
    state = opt.init(p, shapes=reference_shapes(cfg, model))
    want_init = opt_state_from_jax_numpy(_np_tree(j_opt.init(jparams)), cfg,
                                         "cpu")
    factored = {n for n, v in state["v"].items() if is_factored_leaf(v)}
    assert factored == {n for n, v in want_init["v"].items()
                        if isinstance(v, dict)}
    assert {"encoder.0.attn.wq.w", "decoder.1.cross.wo.w"} <= factored
    assert "encoder.0.norm_attn.scale" not in factored
    ndims = reference_ndims(cfg, model)
    with torch.no_grad():
        for step, g in enumerate(grads):
            opt.update(params_from_jax_numpy(g, cfg, "cpu"), state, p, step,
                       ndims=ndims)
    want_p = params_from_jax_numpy(_np_tree(j_params), cfg, "cpu")
    for name in p:
        np.testing.assert_allclose(p[name].detach().numpy(),
                                   want_p[name].numpy(), atol=1e-6, rtol=0,
                                   err_msg=name)


# ---------------------------------------------------------------------------
# the untied read-out over rows TMA cannot read
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype,width", [(torch.bfloat16, 1008),
                                         (torch.float32, 1004)])
@pytest.mark.parametrize("backend", BACKENDS)
def test_readout_pads_rows_and_keeps_values_and_gradients(dtype, width,
                                                          backend,
                                                          monkeypatch):
    """``readout`` over 1,003 columns runs its GEMM over the copy padded to
    whole 16-byte rows; the logits and both gradients equal those of the
    unpadded product exactly."""
    from repro_torch.core import matmul
    from repro_torch.models import common
    gen = torch.Generator().manual_seed(0)
    x0 = torch.randn((2, 3, 16), generator=gen).to(dtype)
    w0 = torch.randn((16, 1003), generator=gen)
    g = torch.randn((2, 3, 1003), generator=gen)
    seen = []

    def recording(a, b, **kw):
        seen.append(tuple(b.shape))
        return matmul(a, b, **kw)

    monkeypatch.setattr(common, "matmul", recording)
    outs = []
    for fn in (common.readout, lambda x, w, dt, odt: matmul(
            x, w.to(dt), out_dtype=odt)):
        x, w = x0.clone().requires_grad_(), w0.clone().requires_grad_()
        with use(backend=backend, device="cpu"):
            y = fn(x, w, dtype, torch.float32)
            y.backward(g)
        outs.append((y.detach(), x.grad, w.grad))
    assert seen == [(16, width)]
    for got, want in zip(*outs):
        assert got.dtype == want.dtype and torch.equal(got, want)


def test_seamless_readout_takes_a_tma_readable_width(monkeypatch):
    """At seamless's own width (meta tensors: no memory), the read-out's
    GEMM gets a bf16 weight of 256,208 columns, which TMA reads (route A),
    where 256,206 would take route C."""
    from repro_torch.kernels.gemm.kernel import choose_route
    from repro_torch.models import common
    cfg = get_config(ARCH)
    seen = []

    def recording(a, b, **kw):
        seen.append(tuple(b.shape))
        return a.new_empty(a.shape[:-1] + b.shape[-1:])

    monkeypatch.setattr(common, "matmul", recording)
    x = torch.empty((4, 1, cfg.d_model), dtype=torch.bfloat16, device="meta")
    w = torch.empty((cfg.d_model, cfg.vocab_size), device="meta")
    y = common.readout(x, w, torch.bfloat16, torch.bfloat16)
    assert seen == [(1024, 256208)] and y.shape == (4, 1, 256206)
    assert choose_route(torch.bfloat16, 1024, 256206, 64) == "C"
    assert choose_route(torch.bfloat16, 1024, 256208, 64) == "A"


# ---------------------------------------------------------------------------
# non-causal flash, refusals
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("b,h,sq,sk,d", [(2, 3, 1, 70, 64),
                                         (1, 2, 40, 100, 64),
                                         (2, 2, 100, 40, 32)])
def test_noncausal_flash_matches_reference_pallas(b, h, sq, sk, d, fused):
    """Cross-attention's shapes: one query row (a decode step) against
    every key, and sq != sk both ways, each off the blocks, against the
    reference's Pallas kernels in interpret mode."""
    rng = np.random.default_rng(sq + sk)
    arrs = [rng.standard_normal((b, s, h, d)).astype(np.float32)
            for s in (sq, sk, sk)]
    with jcore.use(backend="pallas"):
        want = np.asarray(j_flash(*(jnp.asarray(x) for x in arrs),
                                  causal=False, fused=fused))
    with use(backend="engine", device="cpu"):
        got = flash_attention(*(torch.from_numpy(x) for x in arrs),
                              causal=False, fused=fused)
    assert got.shape == (b, sq, h, d)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-3, rtol=2e-3)


def test_generate_continuous_and_clis_refuse_the_encoder_decoder(tmp_path):
    """The CLIs refuse before they configure the process (the engine's
    default device stays as it was)."""
    from repro_torch.core import get_config as engine_config
    before = engine_config()
    _, cfg, _, _, model = _setup()
    with pytest.raises(ValueError, match="encoder-decoder"):
        generate(model, torch.zeros((1, 4), dtype=torch.long), 2)
    with pytest.raises(ValueError, match="decoder-only"):
        ContinuousBatchingEngine(model, num_slots=2, spec=PageSpec(8, 4, 4))
    with pytest.raises(ValueError, match="encoder-decoder"):
        serve_main(["--arch", ARCH, "--device", "cpu"])
    with pytest.raises(ValueError, match="encoder-decoder"):
        serve_main(["--arch", ARCH, "--device", "cpu", "--continuous"])
    with pytest.raises(ValueError, match="encoder-decoder"):
        train_main(["--arch", ARCH, "--device", "cpu", "--steps", "1",
                    "--ckpt-dir", str(tmp_path)])
    assert engine_config() == before
