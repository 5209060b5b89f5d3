"""The port's remaining decoder configurations against the reference:
qwen2.5-3b (qkv bias, tied), phi3-mini-3.8b (MHA, untied), starcoder2-15b
(LayerNorm, qkv and MLP biases, a non-gated gelu MLP, untied) and
grok-1-314b (a gelu-gated mixture of experts, attention and final-logit
softcaps, ``embed_scale``, untied), each on its ``reduced_config`` in
float32 from the same JAX-initialised parameters through
``repro_torch.convert``.  Every bias and norm leaf is drawn from a numpy
seed before the conversion (``Init`` and the reference's initialisers give
zeros and ones, which would hide a wrong bias or norm wiring), and the
same arrays go to both packages.  Also: the configs field for field, the
config helpers for every registered config, ``layernorm`` and the CLIs on
the CPU (the dense decoders also through continuous batching).

The reference runs its ``xla`` path; the port runs both its ``torch`` and
``engine`` backends against it.  Tolerances: logits atol = rtol = 1e-4
(float32 on both sides, sums in another order); greedy tokens identical;
train-step loss, nll and grad_norm 1e-5 relative, gradient leaves atol
1e-5 / rtol 1e-4; ``layernorm`` atol 1e-6 / rtol 1e-5 in float32 and
atol 1e-2 in bfloat16 (one bf16 rounding of outputs of size ~3).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jcore
from repro.configs import get_config as j_get_config
from repro.configs import list_configs as j_list_configs
from repro.configs import reduced_config as j_reduced_config
from repro.data import SyntheticLMDataset as JSyntheticLMDataset
from repro.launch.serve import generate as j_generate
from repro.models import LanguageModel as JLanguageModel
from repro.models.common import layernorm as j_layernorm
from repro.optim import adamw as j_adamw
from repro.optim import warmup_cosine as j_warmup_cosine
from repro.runtime.steps import make_train_step as j_make_train_step

from repro_torch.configs import (ModelConfig, get_config, list_configs,
                                 reduced_config)
from repro_torch.convert import params_from_jax_numpy, reference_ndims
from repro_torch.core import engine, use
from repro_torch.launch.serve import generate, main as serve_main
from repro_torch.launch.train import main as train_main
from repro_torch.models import LanguageModel
from repro_torch.models.common import Init, LayerNorm, layernorm, make_norm
from repro_torch.optim import adamw, warmup_cosine
from repro_torch.runtime.steps import make_train_step

ATOL = 1e-4
ARCHS = ["qwen2.5-3b", "phi3-mini-3.8b", "starcoder2-15b", "grok-1-314b"]
REGISTERED = sorted(ARCHS + ["qwen3-0.6b", "mamba2-130m", "phi3.5-moe-42b",
                             "recurrentgemma-9b", "internvl2-1b",
                             "seamless-m4t-large-v2"])
BACKENDS = ["torch", "engine"]


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _as_port_config(jcfg):
    return ModelConfig(**{f: getattr(jcfg, f)
                          for f in ModelConfig.__dataclass_fields__})


def _draw_biases_and_norms(tree, seed):
    """``tree`` (numpy leaves) with every linear bias (``b``) and every
    norm leaf (``scale``, ``bias`` under a ``*norm*`` key) redrawn:
    biases N(0, 0.2^2), scales 1 + N(0, 0.2^2)."""
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


def _setup(arch):
    """(jcfg, cfg, numpy params, JAX params, port model, tokens) for
    ``arch``, built once."""
    if arch not in _SETUPS:
        jcfg = j_reduced_config(j_get_config(arch))
        cfg = reduced_config(get_config(arch))
        assert cfg == _as_port_config(jcfg)
        np_params, drawn = _draw_biases_and_norms(
            _np_tree(JLanguageModel.init(jax.random.PRNGKey(0), jcfg)), 7)
        assert drawn
        jparams = jax.tree.map(jnp.asarray, np_params)
        model = LanguageModel(cfg, device="cpu", seed=1)
        model.load_state_dict(params_from_jax_numpy(np_params, cfg,
                                                    device="cpu"),
                              strict=True)
        tokens = np.random.default_rng(0).integers(
            0, cfg.vocab_size, (2, 17)).astype(np.int32)
        _SETUPS[arch] = (jcfg, cfg, np_params, jparams, model, tokens)
    return _SETUPS[arch]


@pytest.mark.parametrize("arch", ARCHS)
def test_config_is_the_reference(arch):
    jcfg, cfg = j_get_config(arch), get_config(arch)
    assert cfg == _as_port_config(jcfg)
    assert set(cfg.__dataclass_fields__) == set(jcfg.__dataclass_fields__)
    assert cfg.source and cfg.source == jcfg.source
    assert reduced_config(cfg) == _as_port_config(j_reduced_config(jcfg))
    assert cfg.param_count() == jcfg.param_count()


@pytest.mark.parametrize("arch", REGISTERED)
def test_config_helpers_are_the_reference(arch):
    jcfg, cfg = j_get_config(arch), get_config(arch)
    assert cfg.active_param_count() == jcfg.active_param_count()
    assert cfg.sub_quadratic == jcfg.sub_quadratic
    assert cfg.has_decoder == jcfg.has_decoder
    red, jred = reduced_config(cfg), j_reduced_config(jcfg)
    assert red.active_param_count() == jred.active_param_count()


def test_list_configs_lists_the_registered_names():
    assert list_configs() == REGISTERED
    assert list_configs() == sorted(j_list_configs())


def test_full_width_memory_of_the_card_depths():
    """The fp32 master sizes the card's phases are sized by
    (``chip_smoke.py``): full depth for qwen2.5-3b and phi3-mini, 24 and 2
    starcoder2 layers, 2 grok layers."""
    def gb(arch, layers=None):
        cfg = get_config(arch)
        if layers is not None:
            cfg = dataclasses.replace(cfg, num_layers=layers)
        return 4 * cfg.param_count() / 1e9

    assert round(gb("qwen2.5-3b"), 1) == 12.3
    assert round(gb("phi3-mini-3.8b"), 1) == 15.3
    per_layer = gb("starcoder2-15b", 2) - gb("starcoder2-15b", 1)
    assert round(per_layer, 2) == 1.54
    assert round(gb("starcoder2-15b", 0), 1) == 2.4
    assert round(gb("grok-1-314b", 2) - gb("grok-1-314b", 1), 1) == 19.7
    assert round(gb("grok-1-314b", 0), 1) == 6.4


@pytest.mark.parametrize("dtype,atol,rtol", [(np.float32, 1e-6, 1e-5),
                                             ("bfloat16", 1e-2, 0.0)])
def test_layernorm_matches_reference(dtype, atol, rtol):
    r = np.random.default_rng(3)
    x = (3.0 + 2.0 * r.standard_normal((4, 7, 96))).astype(np.float32)
    scale = (1 + 0.3 * r.standard_normal(96)).astype(np.float32)
    bias = (0.3 * r.standard_normal(96)).astype(np.float32)
    jx = jnp.asarray(x).astype(dtype)
    want = j_layernorm({"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)},
                       jx, 1e-5)
    tx = torch.from_numpy(x).to(torch.bfloat16 if dtype == "bfloat16"
                                else torch.float32)
    got = layernorm(torch.from_numpy(scale), torch.from_numpy(bias), tx, 1e-5)
    assert got.dtype == tx.dtype
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               atol=atol, rtol=rtol)


def test_make_norm_builds_layernorm():
    norm = make_norm("layernorm", 8, Init(0, "cpu"))
    assert isinstance(norm, LayerNorm)
    assert dict((k, tuple(v.shape)) for k, v in norm.named_parameters()) \
        == {"scale": (8,), "bias": (8,)}
    assert torch.equal(norm.scale, torch.ones(8))
    assert torch.equal(norm.bias, torch.zeros(8))
    with pytest.raises(NotImplementedError):
        make_norm("groupnorm", 8, Init(0, "cpu"))


@pytest.mark.parametrize("arch", ARCHS)
def test_seeded_init_has_the_reference_leaves(arch):
    _, cfg, np_params, _, _, _ = _setup(arch)
    want = params_from_jax_numpy(np_params, cfg, device="cpu")
    own = dict(LanguageModel(cfg, device="cpu", seed=3).named_parameters())
    assert {k: tuple(v.shape) for k, v in own.items()} == \
        {k: tuple(v.shape) for k, v in want.items()}
    assert ("lm_head.w" in own) == (not cfg.tie_embeddings)


@pytest.mark.parametrize("arch", ARCHS)
def test_weight_decay_ranks_are_the_reference(arch):
    """Each leaf's rank as the reference holds it: the scanned layers'
    leaves (biases and norm leaves too) one axis up, the final norm's
    leaves rank 1 (no weight decay)."""
    _, cfg, np_params, _, model, _ = _setup(arch)
    want = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(np_params)[0]:
        keys = [str(getattr(k, "key", getattr(k, "idx", k))) for k in path]
        if keys[:2] == ["blocks", "groups"]:
            for layer in range(cfg.num_layers):
                want[".".join(["blocks", str(layer)] + keys[3:])] = leaf.ndim
        else:
            want[".".join(keys)] = leaf.ndim
    assert reference_ndims(cfg, model) == want
    assert want["final_norm.scale"] == 1
    if cfg.norm_type == "layernorm":
        assert want["final_norm.bias"] == 1


def _flash_launches(cfg):
    """Flash launches of a forward: one a layer, none where the attention
    softcap keeps attention in plain torch."""
    return 0 if cfg.attn_logit_softcap else cfg.num_layers


def _gemm_launches(cfg):
    """GEMM launches of a forward: q, k, v and o a layer, the dense MLP's
    GEMMs (two non-gated, three gated; experts go through the grouped
    family) and the read-out, one GEMM tied or untied."""
    mlp = 0 if cfg.num_experts else (3 if cfg.mlp_gated else 2)
    return (4 + mlp) * cfg.num_layers + 1


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_logits_match_reference(arch, backend):
    jcfg, cfg, _, jparams, model, tokens = _setup(arch)
    with jcore.use(backend="xla"):
        want, _, _ = JLanguageModel.apply(jparams, jcfg, jnp.asarray(tokens))
    with use(backend=backend, device="cpu"), torch.no_grad():
        engine.reset_stats()
        got, _, _ = model.apply(torch.from_numpy(tokens).long())
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=ATOL)
    if backend == "engine":
        st = engine.stats()
        assert st["gemm"]["launches"] == _gemm_launches(cfg)
        assert st.get("flash_attention", {}).get("launches", 0) == \
            _flash_launches(cfg)
        if cfg.num_experts:
            assert st["grouped_gemm"]["launches"] == 3 * cfg.num_layers


@pytest.mark.parametrize("arch", ARCHS)
def test_generate_tokens_identical_to_reference(arch):
    jcfg, cfg, _, jparams, model, tokens = _setup(arch)
    with jcore.use(backend="xla"):
        want = np.asarray(j_generate(jcfg, jparams, jnp.asarray(tokens),
                                     5)["tokens"])
    for backend in BACKENDS:
        with use(backend=backend, device="cpu"):
            res = generate(model, torch.from_numpy(tokens), 5)
        np.testing.assert_array_equal(res["tokens"].numpy(), want)


def _spy(opt, box, convert):
    def update(grads, *args, **kw):
        box["grads"] = convert(grads)
        return opt.update(grads, *args, **kw)
    return type(opt)(opt.init, update)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_reference(arch, backend):
    """One train step on a batch of 2 x 16: loss, nll, grad_norm and every
    gradient leaf, the drawn biases and norm leaves included."""
    jcfg, cfg, np_params, jparams, _, _ = _setup(arch)
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
        engine.reset_stats()
        got = make_train_step(cfg, opt)(
            model, opt.init(dict(model.named_parameters())),
            {k: torch.from_numpy(v) for k, v in batch.items()}, 0)
    if backend == "engine":
        st = engine.stats()
        flash = st.get("flash_attention", {})
        assert flash.get("launches", 0) == _flash_launches(cfg)
        assert flash.get("launches_bwd", 0) == _flash_launches(cfg)
        # the dense GEMMs' backward is the reference's (plain products)
        assert st["gemm"]["launches"] == _gemm_launches(cfg)
        if cfg.num_experts:
            assert st["grouped_gemm"]["launches_bwd"] == 3 * cfg.num_layers
    for key in ("loss", "nll", "grad_norm", "lr"):
        np.testing.assert_allclose(float(got[key]), float(want[key]),
                                   rtol=1e-5, err_msg=key)
    assert set(box["grads"]) == set(j_box["grads"])
    for name, g in box["grads"].items():
        np.testing.assert_allclose(g.numpy(), j_box["grads"][name].numpy(),
                                   atol=1e-5, rtol=1e-4, err_msg=name)


@pytest.mark.parametrize("arch", ARCHS)
def test_restart_from_checkpoint_is_exact(arch, tmp_path):
    """Four steps straight against a run whose step 3 fails and restarts
    from step 2's checkpoint: the same parameters, the drawn biases and
    norm leaves (and LayerNorm's bias) included."""
    from repro_torch.data import SyntheticLMDataset
    from repro_torch.runtime.train_loop import (TrainLoopConfig,
                                                run_with_restarts)
    _, cfg, np_params, _, _, _ = _setup(arch)
    opt = adamw(warmup_cosine(3e-3, 1, 4))
    ds = SyntheticLMDataset(cfg.vocab_size, 16, 2)
    fired = []

    def make_state():
        model = LanguageModel(cfg, device="cpu", seed=1)
        model.load_state_dict(params_from_jax_numpy(np_params, cfg, "cpu"))
        return model, opt.init(dict(model.named_parameters()))

    def batch_fn(step):
        return {k: torch.from_numpy(v) for k, v in ds.host_batch(step).items()}

    def injector(step):
        if step == 3 and not fired:
            fired.append(step)
            raise RuntimeError("simulated node failure")

    outs = []
    with use(backend="engine", device="cpu"):
        for name, inject in (("straight", None), ("restarted", injector)):
            outs.append(run_with_restarts(
                make_state, make_train_step(cfg, opt), batch_fn,
                TrainLoopConfig(total_steps=4, ckpt_dir=str(tmp_path / name),
                                save_every=2, max_restarts=1),
                fault_injector=inject))
    assert [o["restarts"] for o in outs] == [0, 1] and fired == [3]
    want = dict(outs[0]["model"].named_parameters())
    for name, p in outs[1]["model"].named_parameters():
        torch.testing.assert_close(p, want[name], atol=1e-5, rtol=1e-5,
                                   msg=name)


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_and_train_clis_on_cpu(arch, capsys, tmp_path):
    from repro_torch.core import configure, get_config as engine_config
    before = engine_config()
    try:
        serve_main(["--arch", arch, "--device", "cpu", "--batch", "2",
                    "--prompt-len", "10", "--gen", "3"])
        train_main(["--arch", arch, "--device", "cpu", "--steps", "2",
                    "--seq", "16", "--batch", "2", "--ckpt-dir",
                    str(tmp_path)])
    finally:
        configure(device=before.device, backend=before.backend,
                  fused=before.fused)
    out = capsys.readouterr().out
    assert f"arch={arch} device=cpu generated (2, 3)" in out
    assert f"arch={arch} device=cpu" in out.split("generated", 1)[1]


@pytest.mark.parametrize("arch", [a for a in ARCHS
                                  if not get_config(a).num_experts])
def test_continuous_cli_on_cpu_matches_the_static_path(arch, capsys):
    """The dense decoders through the paged continuous runtime: every
    request's greedy tokens equal its static-path decode."""
    from repro_torch.core import configure, get_config as engine_config
    before = engine_config()
    try:
        serve_main(["--arch", arch, "--device", "cpu", "--continuous"])
    finally:
        configure(device=before.device, backend=before.backend,
                  fused=before.fused)
    out = capsys.readouterr().out
    assert f"arch={arch} device=cpu continuous:" in out
    assert "token_identical=True" in out


def test_clis_refuse_an_unregistered_arch(capsys):
    for main in (serve_main, train_main):
        with pytest.raises(SystemExit):
            main(["--arch", "llama-7b", "--device", "cpu"])
    assert "invalid choice: 'llama-7b'" in capsys.readouterr().err
