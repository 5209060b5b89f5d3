"""InternVL2-1B (the vision prefix on a Qwen2 backbone) in the port against
the reference, on the CPU, at reduced size (2 layers, width 64, 4 image
tokens of 32 features), from the same JAX-initialised parameters (carried
over by ``repro_torch.convert``) with every bias and norm leaf drawn from a
numpy seed:

  * the configuration and its parameter count (0.494 B);
  * the frontend's projected prefix (``frontend_apply``);
  * teacher-forced logits with the prefix, the port under ``torch`` and
    ``engine`` (plain kernel versions on the CPU) against the reference's
    ``xla`` path;
  * prefill with the prefix + one decode step against the full forward
    (tests/test_decode_consistency.py's vision case, at its 2e-4);
  * greedy tokens of ``generate`` (text-only, as the reference serves it);
  * one train step with the prefix (loss on the text positions only):
    loss, nll, grad_norm, every gradient leaf (the frontend's too) and the
    updated parameters;
  * continuous batching text-only against the reference's engine;
  * the serve and train CLIs, text-only.

Tolerances: logits and the prefix atol = rtol = 1e-4 (float32 on both
sides, sums in another order); train-step loss, nll and grad_norm 1e-5
relative, gradient leaves atol 1e-5 / rtol 1e-4, the parameters updated
from the reference's gradients atol 1e-6; tokens exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jcore
from repro.configs import get_config as j_get_config
from repro.configs import reduced_config as j_reduced_config
from repro.launch.serve import generate as j_generate
from repro.models import LanguageModel as JLanguageModel
from repro.models.attention import PageSpec as JPageSpec
from repro.models.frontends import frontend_apply as j_frontend_apply
from repro.optim import adamw as j_adamw
from repro.optim import warmup_cosine as j_warmup_cosine
from repro.runtime.batching import (
    ContinuousBatchingEngine as JContinuousBatchingEngine)
from repro.runtime.batching import poisson_trace as j_poisson_trace
from repro.runtime.steps import make_train_step as j_make_train_step

from repro_torch.configs import ModelConfig, get_config, list_configs, \
    reduced_config
from repro_torch.convert import params_from_jax_numpy, reference_ndims
from repro_torch.core import use
from repro_torch.launch.serve import generate, main as serve_main
from repro_torch.launch.train import main as train_main
from repro_torch.models import LanguageModel
from repro_torch.models.attention import PageSpec
from repro_torch.models.blocks import check_ported
from repro_torch.optim import adamw, warmup_cosine
from repro_torch.runtime.batching import (ContinuousBatchingEngine,
                                          poisson_trace)
from repro_torch.runtime.steps import make_train_step

ARCH = "internvl2-1b"
ATOL = 1e-4
BACKENDS = ["torch", "engine"]


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


_SETUP = {}


def _setup():
    """(jcfg, cfg, numpy params, JAX params, port model), built once."""
    if not _SETUP:
        jcfg = j_reduced_config(j_get_config(ARCH))
        cfg = reduced_config(get_config(ARCH))
        assert cfg == _as_port_config(jcfg)
        np_params, drawn = _draw_biases_and_norms(
            _np_tree(JLanguageModel.init(jax.random.PRNGKey(0), jcfg)), 7)
        assert any(p.startswith("frontend.proj1") for p in drawn)
        jparams = jax.tree.map(jnp.asarray, np_params)
        model = LanguageModel(cfg, device="cpu", seed=1)
        model.load_state_dict(params_from_jax_numpy(np_params, cfg, "cpu"),
                              strict=True)
        _SETUP["v"] = (jcfg, cfg, np_params, jparams, model)
    return _SETUP["v"]


def _tokens(cfg, b, s, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32)


def _feats(cfg, b, seed=1):
    return np.random.default_rng(seed).standard_normal(
        (b, cfg.num_modality_tokens, cfg.modality_dim)).astype(np.float32)


def test_config_is_the_reference():
    jcfg, cfg = j_get_config(ARCH), get_config(ARCH)
    assert cfg == _as_port_config(jcfg)
    assert cfg.param_count() == jcfg.param_count()
    assert round(cfg.param_count() / 1e9, 3) == 0.494
    assert ARCH in list_configs()
    assert (cfg.modality, cfg.modality_dim, cfg.num_modality_tokens,
            cfg.num_heads // cfg.num_kv_heads, cfg.head_dim) == \
        ("vision", 1024, 256, 7, 64)
    check_ported(cfg)


def test_frontend_matches_reference():
    jcfg, cfg, _, jparams, model = _setup()
    feats = _feats(cfg, 2)
    want = j_frontend_apply(jparams["frontend"], jcfg, jnp.asarray(feats))
    with use(backend="engine", device="cpu"), torch.no_grad():
        got = model.frontend(torch.from_numpy(feats))
    assert got.shape == (2, cfg.num_modality_tokens, cfg.d_model)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=ATOL)


@pytest.mark.parametrize("backend", BACKENDS)
def test_logits_with_prefix_match_reference(backend):
    jcfg, cfg, _, jparams, model = _setup()
    toks, feats = _tokens(cfg, 2, 17), _feats(cfg, 2)
    with jcore.use(backend="xla"):
        want, _, _ = JLanguageModel.apply(jparams, jcfg, jnp.asarray(toks),
                                          modality_feats=jnp.asarray(feats))
    with use(backend=backend, device="cpu"), torch.no_grad():
        got, _, _ = model.apply(torch.from_numpy(toks).long(),
                                modality_feats=torch.from_numpy(feats))
    assert got.shape == (2, 17 + cfg.num_modality_tokens, cfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=ATOL)


@pytest.mark.parametrize("backend", BACKENDS)
def test_prefill_with_prefix_then_decode_matches_full(backend):
    """tests/test_decode_consistency.py's vision case: the prefix and 16
    tokens prefilled into a cache of s + n_mod rows, then the 17th token
    decoded at position s - 1 + n_mod."""
    _, cfg, _, _, model = _setup()
    b, s, n_mod = 2, 17, cfg.num_modality_tokens
    toks = torch.from_numpy(_tokens(cfg, b, s, seed=2)).long()
    feats = torch.from_numpy(_feats(cfg, b, seed=3))
    with use(backend=backend, device="cpu"), torch.no_grad():
        full, _, _ = model.apply(toks, modality_feats=feats)
        cache = model.init_cache(b, s + n_mod)
        pre, cache, _ = model.apply(
            toks[:, :-1], positions=torch.arange(s - 1 + n_mod), cache=cache,
            modality_feats=feats)
        dec, _, _ = model.apply(toks[:, -1:],
                                positions=torch.tensor([s - 1 + n_mod]),
                                cache=cache)
    assert float((full[:, :-1] - pre).abs().max()) < 2e-4
    assert float((full[:, -1:] - dec).abs().max()) < 2e-4


def test_generate_text_only_tokens_identical_to_reference():
    jcfg, cfg, _, jparams, model = _setup()
    toks = _tokens(cfg, 2, 11, seed=4)
    with jcore.use(backend="xla"):
        want = np.asarray(j_generate(jcfg, jparams, jnp.asarray(toks),
                                     6)["tokens"])
    for backend in BACKENDS:
        with use(backend=backend, device="cpu"):
            res = generate(model, torch.from_numpy(toks), 6)
        np.testing.assert_array_equal(res["tokens"].numpy(), want)


def _spy(opt, box, convert):
    def update(grads, *args, **kw):
        box["grads"] = convert(grads)
        return opt.update(grads, *args, **kw)
    return type(opt)(opt.init, update)


@pytest.mark.parametrize("backend", BACKENDS)
def test_train_step_with_prefix_matches_reference(backend):
    """One train step on 2 x (4 image + 12 text) positions with the loss
    on the text positions only: loss, nll, grad_norm, every gradient leaf
    (the frontend's and the drawn biases included), and the parameters
    after the update (:func:`_check_update`)."""
    jcfg, cfg, np_params, jparams, _ = _setup()
    rng = np.random.default_rng(5)
    toks = rng.integers(0, cfg.vocab_size, (2, 13)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:],
             "modality_feats": _feats(cfg, 2, seed=6)}
    j_box, box = {}, {}
    j_opt = _spy(j_adamw(j_warmup_cosine(3e-3, 1, 10)), j_box,
                 lambda g: params_from_jax_numpy(_np_tree(g), cfg, "cpu"))
    with jcore.use(backend="xla"):
        j_new, _, want = j_make_train_step(jcfg, j_opt)(
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
    assert "frontend.proj1.w" in box["grads"]
    for name, g in box["grads"].items():
        np.testing.assert_allclose(g.numpy(), j_box["grads"][name].numpy(),
                                   atol=1e-5, rtol=1e-4, err_msg=name)
    _check_update(cfg, np_params, j_box["grads"], j_new)


def _check_update(cfg, np_params, grads, j_new):
    """The port's AdamW fed the reference's gradients, with the weight
    decay of each leaf's reference rank, gives the reference's updated
    parameters (an update of Adam's first step is about lr x sign(g), so
    the gradients must be the same ones: a near-zero gradient whose sign
    differs moves its element by about 2 lr)."""
    model = LanguageModel(cfg, device="cpu", seed=1)
    model.load_state_dict(params_from_jax_numpy(np_params, cfg, "cpu"))
    params = dict(model.named_parameters())
    opt = adamw(warmup_cosine(3e-3, 1, 10))
    with torch.no_grad():
        opt.update(grads, opt.init(params), params, 0,
                   ndims=reference_ndims(cfg, model))
    new = params_from_jax_numpy(_np_tree(j_new), cfg, "cpu")
    for name, p in params.items():
        np.testing.assert_allclose(p.detach().numpy(), new[name].numpy(),
                                   atol=1e-6, rtol=0, err_msg=name)


# 4 requests of 20-30 tokens over 3 slots and 7 pages of 8: growth evicts
# (tests/test_torch_recurrent.py's evicting case).
TRACE = dict(num_requests=4, rate=2.0, prompt_lens=(20, 30), max_new=8,
             seed=1)
SLOTS, SPEC = 3, (7, 8, 5)


@pytest.mark.parametrize("backend", BACKENDS)
def test_continuous_text_only_matches_reference(backend):
    jcfg, cfg, _, jparams, model = _setup()
    with jcore.use(backend="xla"):
        want = JContinuousBatchingEngine(
            jcfg, jparams, num_slots=SLOTS, spec=JPageSpec(*SPEC)).run(
            j_poisson_trace(vocab_size=jcfg.vocab_size, **TRACE))
    reqs = poisson_trace(vocab_size=cfg.vocab_size, **TRACE)
    with use(backend=backend, device="cpu"):
        serving = ContinuousBatchingEngine(model, num_slots=SLOTS,
                                           spec=PageSpec(*SPEC))
        got = serving.run(reqs)
    assert sorted(got["outputs"]) == sorted(want["outputs"])
    for rid, toks in want["outputs"].items():
        np.testing.assert_array_equal(got["outputs"][rid], toks)
    for key in ("requests", "total_tokens", "decode_steps", "evictions"):
        assert got["metrics"][key] == want["metrics"][key], key
    assert got["metrics"]["evictions"] > 0
    serving.pool.check_invariants([0] * SLOTS)


def test_serve_and_train_clis_text_only(capsys, tmp_path):
    from repro_torch.core import configure, get_config as engine_config
    before = engine_config()
    try:
        serve_main(["--arch", ARCH, "--device", "cpu", "--batch", "2",
                    "--prompt-len", "12", "--gen", "3"])
        serve_main(["--arch", ARCH, "--device", "cpu", "--continuous",
                    "--prompt-len", "20", "--gen", "4"])
        train_main(["--arch", ARCH, "--device", "cpu", "--steps", "2",
                    "--seq", "16", "--batch", "2", "--ckpt-dir",
                    str(tmp_path)])
    finally:
        configure(device=before.device, backend=before.backend,
                  fused=before.fused)
    out = capsys.readouterr().out
    assert f"arch={ARCH}" in out
    assert "token_identical=True" in out
    assert "nll:" in out
