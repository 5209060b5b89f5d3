"""The port's Mamba-2 slice against the reference on
``reduced_config(mamba2-130m, ssm_chunk=4, d_model=48, ssm_head_dim=8)``
(the reference tests' overrides) in float32, from the same JAX-initialised
parameters through ``repro_torch.convert``: logits under both backend
pairs, prefill + decode against the full forward, the decode caches,
greedy ``generate``, one train step, and the CLIs on the CPU.

Tolerances: logits and cache leaves atol = rtol = 1e-4 (float32 on both
sides, sums in another order); prefill + decode against the full forward
2e-4 (the reference's own bound in tests/test_decode_consistency.py);
train-step loss, nll and grad_norm 1e-5 relative, gradient leaves
atol 1e-5 / rtol 1e-4 (float32; the chunked scan's backward sums in
another order than JAX's autodiff).
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
from repro.optim import adamw as j_adamw
from repro.optim import warmup_cosine as j_warmup_cosine
from repro.runtime.steps import make_prefill_step as j_make_prefill_step
from repro.runtime.steps import make_train_step as j_make_train_step

from repro_torch.configs import ModelConfig, get_config, reduced_config
from repro_torch.convert import params_from_jax_numpy, reference_ndims
from repro_torch.core import engine, use
from repro_torch.launch.serve import generate, main as serve_main, \
    run_continuous
from repro_torch.launch.train import main as train_main
from repro_torch.models import EncoderDecoderModel, LanguageModel
from repro_torch.models.attention import PageSpec
from repro_torch.models.blocks import check_ported
from repro_torch.models.ssd import SSMState
from repro_torch.optim import adamw, warmup_cosine
from repro_torch.runtime.steps import make_prefill_step, make_train_step

OVERRIDES = dict(ssm_chunk=4, d_model=48, ssm_head_dim=8)
ATOL = 1e-4
BACKENDS = [("torch", "xla"), ("engine", "pallas")]


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def setup():
    jcfg = j_reduced_config(j_get_config("mamba2-130m"), **OVERRIDES)
    cfg = reduced_config(get_config("mamba2-130m"), **OVERRIDES)
    assert cfg == ModelConfig(**{f: getattr(jcfg, f)
                                 for f in cfg.__dataclass_fields__})
    params = JLanguageModel.init(jax.random.PRNGKey(0), jcfg)
    model = LanguageModel(cfg, device="cpu", seed=1)
    model.load_state_dict(params_from_jax_numpy(_np_tree(params), cfg,
                                                device="cpu"), strict=True)
    tokens = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 17)).astype(np.int32)
    return jcfg, cfg, params, model, tokens


def test_full_width_config_is_the_reference():
    jcfg = j_get_config("mamba2-130m")
    cfg = get_config("mamba2-130m")
    assert cfg == ModelConfig(**{f: getattr(jcfg, f)
                                 for f in cfg.__dataclass_fields__})
    assert cfg.param_count() == jcfg.param_count()


def test_seeded_init_has_the_reference_leaves(setup):
    """The port's own initialiser builds the same parameter names, shapes
    and fixed values (A_log, D, conv bias, norm scales) as the reference."""
    jcfg, cfg, params, model, _ = setup
    want = params_from_jax_numpy(_np_tree(params), cfg, device="cpu")
    own = dict(LanguageModel(cfg, device="cpu", seed=3).named_parameters())
    assert {k: tuple(v.shape) for k, v in own.items()} == \
        {k: tuple(v.shape) for k, v in want.items()}
    for name in want:
        if name.rsplit(".", 1)[-1] in ("A_log", "D", "conv_b", "scale"):
            torch.testing.assert_close(own[name], want[name])
    dt_bias = own["blocks.0.mixer.dt_bias"]
    dt = torch.nn.functional.softplus(dt_bias)
    assert bool(((dt > 0.001 - 1e-6) & (dt < 0.1 + 1e-6)).all())


@pytest.mark.parametrize("backend,j_backend", BACKENDS)
def test_logits_match_reference(setup, backend, j_backend):
    jcfg, cfg, params, model, tokens = setup
    with jcore.use(backend=j_backend):
        want, _, _ = JLanguageModel.apply(params, jcfg, jnp.asarray(tokens))
    with use(backend=backend, device="cpu"), torch.no_grad():
        engine.reset_stats()
        got, _, _ = model.apply(torch.from_numpy(tokens).long())
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=ATOL)
    if backend == "engine":
        st = engine.stats()
        # One scan launch per layer (17 tokens pad to 5 chunks of 4), the
        # in/out projections per layer and the tied read-out on GEMMs.
        assert st["ssd_chunk"]["launches"] == cfg.num_layers
        assert st["gemm"]["launches"] >= 2 * cfg.num_layers + 1


@pytest.mark.parametrize("backend,j_backend", BACKENDS)
def test_prefill_cache_matches_reference(setup, backend, j_backend):
    """After prefilling a ragged prompt (padded to the chunk with dt = 0)
    every layer's conv tail and SSM state equal the reference's, and the
    leaves keep the reference's dtypes."""
    jcfg, cfg, params, model, tokens = setup
    with jcore.use(backend=j_backend):
        _, jcache = j_make_prefill_step(jcfg, 20)(
            params, {"tokens": jnp.asarray(tokens)})
    j_leaves = jcache["groups"]["b0"]
    with use(backend=backend, device="cpu"):
        init = model.init_cache(2, 20)
        _, cache = make_prefill_step(model, 20)(
            {"tokens": torch.from_numpy(tokens).long()})
    assert all(isinstance(c, SSMState) for c in cache)
    assert init[0].conv.dtype == torch.bfloat16
    assert init[0].s.dtype == torch.float32
    for i, c in enumerate(cache):
        assert c.conv.dtype == torch.float32 and c.s.dtype == torch.float32
        np.testing.assert_allclose(c.conv.numpy(), np.asarray(j_leaves.conv[i]),
                                   atol=ATOL, rtol=ATOL)
        np.testing.assert_allclose(c.s.numpy(), np.asarray(j_leaves.s[i]),
                                   atol=ATOL, rtol=ATOL)


@pytest.mark.parametrize("backend", ["torch", "engine"])
def test_prefill_decode_matches_full(setup, backend):
    _, cfg, _, model, tokens = setup
    t = torch.from_numpy(tokens).long()
    s = t.shape[1]
    with use(backend=backend, device="cpu"), torch.no_grad():
        full, _, _ = model.apply(t)
        cache = model.init_cache(2, s)
        pre, cache, _ = model.apply(t[:, :-1], positions=torch.arange(s - 1),
                                    cache=cache)
        engine.reset_stats()
        dec, cache, _ = model.apply(t[:, -1:], positions=torch.tensor([s - 1]),
                                    cache=cache)
        if backend == "engine":
            # The decode step is plain torch: no SSD kernel runs.
            assert engine.stats().get("ssd_chunk", {}).get("launches", 0) == 0
    assert float((full[:, :-1] - pre).abs().max()) < 2e-4
    assert float((full[:, -1:] - dec).abs().max()) < 2e-4


def test_generate_tokens_identical_to_reference(setup):
    jcfg, cfg, params, model, tokens = setup
    want = np.asarray(j_generate(jcfg, params, jnp.asarray(tokens),
                                 5)["tokens"])
    for backend in ("engine", "torch"):
        with use(backend=backend, device="cpu"):
            res = generate(model, torch.from_numpy(tokens), 5)
        np.testing.assert_array_equal(res["tokens"].numpy(), want)


def _spy(opt, box, convert):
    def update(grads, *args, **kw):
        box["grads"] = convert(grads)
        return opt.update(grads, *args, **kw)
    return type(opt)(opt.init, update)


@pytest.mark.parametrize("backend,j_backend", BACKENDS)
def test_train_step_matches_reference(setup, backend, j_backend):
    """One train step on a batch of 2 x 16 (four chunks, so the backward
    walks three seams): loss, nll, grad_norm and every gradient leaf."""
    jcfg, cfg, params, _, _ = setup
    batch = JSyntheticLMDataset(jcfg.vocab_size, 16, 2).host_batch(0)
    j_box, box = {}, {}
    j_opt = _spy(j_adamw(j_warmup_cosine(3e-3, 1, 10)), j_box,
                 lambda g: params_from_jax_numpy(_np_tree(g), cfg, "cpu"))
    with jcore.use(backend=j_backend):
        _, _, want = j_make_train_step(jcfg, j_opt)(
            params, j_opt.init(params),
            {k: jnp.asarray(v) for k, v in batch.items()}, jnp.asarray(0))
    model = LanguageModel(cfg, device="cpu", seed=1)
    model.load_state_dict(params_from_jax_numpy(_np_tree(params), cfg, "cpu"))
    opt = _spy(adamw(warmup_cosine(3e-3, 1, 10)), box,
               lambda g: {k: v.clone() for k, v in g.items()})
    with use(backend=backend, device="cpu"):
        engine.reset_stats()
        got = make_train_step(cfg, opt)(
            model, opt.init(dict(model.named_parameters())),
            {k: torch.from_numpy(v) for k, v in batch.items()}, 0)
    if backend == "engine":
        st = engine.stats()["ssd_chunk"]
        assert st["launches"] == cfg.num_layers
        assert st["launches_bwd"] == cfg.num_layers
    for key in ("loss", "nll", "grad_norm", "lr"):
        np.testing.assert_allclose(float(got[key]), float(want[key]),
                                   rtol=1e-5, err_msg=key)
    assert set(box["grads"]) == set(j_box["grads"])
    for name, g in box["grads"].items():
        np.testing.assert_allclose(g.numpy(), j_box["grads"][name].numpy(),
                                   atol=1e-5, rtol=1e-4, err_msg=name)


def test_weight_decay_ranks_are_the_reference(setup):
    """AdamW decays a leaf by its rank in the reference (stacked over the
    scanned layers): every layer's SSD leaves get the rank of the JAX
    array they were unstacked from."""
    jcfg, cfg, params, model, _ = setup
    want = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
        keys = [str(getattr(k, "key", getattr(k, "idx", k))) for k in path]
        if keys[:2] == ["blocks", "groups"]:
            for layer in range(cfg.num_layers):
                want[".".join(["blocks", str(layer)] + keys[3:])] = leaf.ndim
        else:
            want[".".join(keys)] = leaf.ndim
    assert reference_ndims(cfg, model) == want
    assert want["blocks.0.mixer.A_log"] == 2
    assert want["blocks.1.mixer.in_proj.w"] == 3


def test_unported_recurrent_and_paged_paths_raise(setup):
    """Every reference configuration builds: recurrentgemma's kinds, a
    mixed ("ssm", "rec") pattern, the vision prefix (a ``LanguageModel``)
    and the encoder-decoder (an ``EncoderDecoderModel``, which
    ``LanguageModel`` refuses)."""
    _, cfg, _, model, _ = setup

    def port_cfg(arch):
        jr = j_reduced_config(j_get_config(arch))
        return ModelConfig(**{f: getattr(jr, f)
                              for f in cfg.__dataclass_fields__})

    for arch in ("recurrentgemma-9b", "internvl2-1b", "seamless-m4t-large-v2"):
        check_ported(port_cfg(arch))
    vision = LanguageModel(port_cfg("internvl2-1b"), device="cpu")
    assert vision.frontend.proj1.b is not None
    seamless = port_cfg("seamless-m4t-large-v2")
    assert len(EncoderDecoderModel(seamless, device="cpu").encoder) == 2
    with pytest.raises(ValueError, match="encoder-decoder"):
        LanguageModel(seamless, device="cpu")
    # The paged serving cache and continuous batching are ported: every
    # layer's leaf is a slot-major SSM state, and the continuous run's
    # tokens are the static path's.
    paged = model.init_cache(2, 16, paged=PageSpec(8, 4, 4))
    assert all(isinstance(c, SSMState) and c.s.shape[0] == 2 for c in paged)
    with use(device="cpu"):
        assert run_continuous(model)["token_identical"]
    mixed = dataclasses.replace(cfg, block_pattern=("ssm", "rec"),
                                rglru_width=cfg.d_model)
    kinds = [b.kind for b in LanguageModel(mixed, device="cpu").blocks]
    assert kinds == ["ssm", "rec"] * (cfg.num_layers // 2)


def test_serve_and_train_clis_on_cpu(capsys, tmp_path):
    from repro_torch.core import configure, get_config as engine_config
    before = engine_config()
    engine.reset_stats()
    try:
        serve_main(["--arch", "mamba2-130m", "--device", "cpu", "--batch",
                    "2", "--prompt-len", "10", "--gen", "3"])
        train_main(["--arch", "mamba2-130m", "--device", "cpu", "--steps",
                    "2", "--seq", "32", "--batch", "2", "--ckpt-dir",
                    str(tmp_path)])
    finally:
        configure(device=before.device, backend=before.backend,
                  fused=before.fused)
    out = capsys.readouterr().out
    assert "arch=mamba2-130m device=cpu generated (2, 3)" in out
    # Two layers, two training steps: four reverse walks.
    line = next(ln for ln in out.splitlines()
                if ln.startswith("engine[ssd_chunk]"))
    assert "launches_bwd=4" in line
