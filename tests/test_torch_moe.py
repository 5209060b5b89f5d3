"""The port's mixture-of-experts slice against the reference on
``reduced_config(phi3.5-moe-42b)`` (4 experts, top-2, d 64, d_ff 128, two
layers) in float32, from the same JAX-initialised parameters through
``repro_torch.convert``: ``moe_apply``'s output and aux loss under both
backend pairs, routing ties, model logits and aux loss, greedy
``generate``, one train step, the launch counts, the refused continuous
path and the CLIs on the CPU.

Tolerances: outputs, logits and aux loss atol = rtol = 1e-4 (float32 on
both sides, sums in another order); train-step loss, nll, aux loss and
grad_norm 1e-5 relative, gradient leaves atol 1e-5 / rtol 1e-4 (float32;
the grouped backward sums in another order than JAX's).
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
from repro.models.moe import moe_apply as j_moe_apply
from repro.optim import adamw as j_adamw
from repro.optim import warmup_cosine as j_warmup_cosine
from repro.runtime.steps import make_train_step as j_make_train_step

from repro_torch.configs import ModelConfig, get_config, reduced_config
from repro_torch.convert import params_from_jax_numpy, reference_ndims
from repro_torch.core import engine, use
from repro_torch.launch.serve import generate, main as serve_main, \
    run_continuous
from repro_torch.launch.train import main as train_main
from repro_torch.models import LanguageModel
from repro_torch.models.attention import PageSpec
from repro_torch.models.common import Init
from repro_torch.models.moe import MoE, moe_apply, top_k
from repro_torch.optim import adamw, warmup_cosine
from repro_torch.runtime.steps import make_train_step

ATOL = 1e-4
BACKENDS = [("torch", "xla"), ("engine", "pallas")]
ARCH = "phi3.5-moe-42b"


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def setup():
    jcfg = j_reduced_config(j_get_config(ARCH))
    cfg = reduced_config(get_config(ARCH))
    assert cfg == ModelConfig(**{f: getattr(jcfg, f)
                                 for f in cfg.__dataclass_fields__})
    params = JLanguageModel.init(jax.random.PRNGKey(0), jcfg)
    model = LanguageModel(cfg, device="cpu", seed=1)
    model.load_state_dict(params_from_jax_numpy(_np_tree(params), cfg,
                                                device="cpu"), strict=True)
    tokens = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 17)).astype(np.int32)
    return jcfg, cfg, params, model, tokens


def _layer0_ff(jcfg, params):
    """Layer 0's MoE parameters from the reference's stacked tree."""
    return jax.tree.map(lambda a: a[0], params["blocks"]["groups"]["b0"]["ff"])


def _port_moe(cfg, jff):
    ff = MoE(cfg, Init(0, "cpu"))
    ff.load_state_dict({f"{k}.w": torch.from_numpy(np.array(v["w"]))
                        for k, v in jff.items()}, strict=True)
    return ff


def test_full_width_config_is_the_reference():
    jcfg, cfg = j_get_config(ARCH), get_config(ARCH)
    assert cfg == ModelConfig(**{f: getattr(jcfg, f)
                                 for f in cfg.__dataclass_fields__})
    assert cfg.param_count() == jcfg.param_count()
    # The depths the card runs (chip_smoke.py): 4 layers served, 2 trained.
    four = dataclasses.replace(cfg, num_layers=4)
    two = dataclasses.replace(cfg, num_layers=2)
    assert four.param_count() == dataclasses.replace(
        jcfg, num_layers=4).param_count() == 5_463_867_392
    assert two.param_count() == 2_863_267_840


def test_seeded_init_has_the_reference_leaves(setup):
    jcfg, cfg, params, _, _ = setup
    want = params_from_jax_numpy(_np_tree(params), cfg, device="cpu")
    own = dict(LanguageModel(cfg, device="cpu", seed=3).named_parameters())
    assert {k: tuple(v.shape) for k, v in own.items()} == \
        {k: tuple(v.shape) for k, v in want.items()}
    e, d, f = cfg.num_experts, cfg.d_model, cfg.d_ff
    assert tuple(own["blocks.0.ff.w_up.w"].shape) == (e, d, f)
    assert tuple(own["blocks.1.ff.w_down.w"].shape) == (e, f, d)
    assert tuple(own["blocks.0.ff.router.w"].shape) == (d, e)
    # the reference's scales: N(0, 1) / sqrt(fan_in)
    std = float(own["blocks.0.ff.w_down.w"].detach().std())
    assert abs(std * f ** 0.5 - 1) < 0.05


@pytest.mark.parametrize("backend,j_backend", BACKENDS)
def test_moe_apply_matches_reference(setup, backend, j_backend):
    """Layer 0's MoE on a (2, 40, d) input: 80 tokens route in groups of 2
    (40 groups), so capacity (8 slots) drops nothing; and a (1, 1, d)
    decode-shaped input."""
    jcfg, cfg, params, _, _ = setup
    jff = _layer0_ff(jcfg, params)
    ff = _port_moe(cfg, jff)
    r = np.random.default_rng(5)
    for shape in ((2, 40, cfg.d_model), (1, 1, cfg.d_model)):
        x = r.standard_normal(shape).astype(np.float32)
        with jcore.use(backend=j_backend):
            want, waux = j_moe_apply(jff, jcfg, jnp.asarray(x))
        with use(backend=backend, device="cpu"), torch.no_grad():
            engine.reset_stats()
            got, aux = moe_apply(ff, cfg, torch.from_numpy(x))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                                   rtol=ATOL)
        np.testing.assert_allclose(float(aux), float(waux), atol=ATOL,
                                   rtol=ATOL)
        assert aux.dtype == torch.float32
        if backend == "engine":
            # up, gate (silu fused) and down: three grouped launches
            assert engine.stats()["grouped_gemm"]["launches"] == 3


def test_top_k_breaks_ties_like_the_reference():
    probs = np.array([[0.25, 0.25, 0.25, 0.25],
                      [0.1, 0.3, 0.3, 0.3],
                      [0.4, 0.1, 0.4, 0.1],
                      [0.2, 0.2, 0.5, 0.1]], np.float32)
    vals, idx = top_k(torch.from_numpy(probs), 2)
    jv, ji = jax.lax.top_k(jnp.asarray(probs), 2)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jv))


@pytest.mark.parametrize("backend,j_backend", BACKENDS)
def test_routing_tie_matches_reference(setup, backend, j_backend):
    """A zero router: every token's probabilities tie and top-2 takes
    experts 0 and 1 (the lower indices).  2048 tokens route in groups of
    64 with 40 capacity slots an expert, so each group drops 24 tokens'
    choices; y and aux as the reference's."""
    jcfg, cfg, params, _, _ = setup
    jff = dict(_layer0_ff(jcfg, params))
    jff["router"] = {"w": jnp.zeros_like(jff["router"]["w"])}
    ff = _port_moe(cfg, jff)
    x = np.random.default_rng(6).standard_normal(
        (2, 1024, cfg.d_model)).astype(np.float32)
    with jcore.use(backend=j_backend):
        want, waux = j_moe_apply(jff, jcfg, jnp.asarray(x))
    with use(backend=backend, device="cpu"), torch.no_grad():
        got, aux = moe_apply(ff, cfg, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=ATOL)
    np.testing.assert_allclose(float(aux), float(waux), atol=ATOL, rtol=ATOL)


@pytest.mark.parametrize("backend,j_backend", BACKENDS)
def test_logits_and_aux_match_reference(setup, backend, j_backend):
    jcfg, cfg, params, model, tokens = setup
    with jcore.use(backend=j_backend):
        want, _, waux = JLanguageModel.apply(params, jcfg, jnp.asarray(tokens))
    with use(backend=backend, device="cpu"), torch.no_grad():
        engine.reset_stats()
        got, _, aux = model.apply(torch.from_numpy(tokens).long())
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=ATOL)
    np.testing.assert_allclose(float(aux), float(waux), atol=ATOL, rtol=ATOL)
    if backend == "engine":
        assert engine.stats()["grouped_gemm"]["launches"] == \
            3 * cfg.num_layers


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
    """One train step on a batch of 2 x 16: loss, nll, aux loss,
    grad_norm and every gradient leaf (router and expert banks
    included)."""
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
        st = engine.stats()["grouped_gemm"]
        # per layer: up, gate, down forward plus the gate's pre-activation
        # recompute; three backward walks
        assert st["launches"] == 4 * cfg.num_layers
        assert st["launches_bwd"] == 3 * cfg.num_layers
    for key in ("loss", "nll", "aux_loss", "grad_norm", "lr"):
        np.testing.assert_allclose(float(got[key]), float(want[key]),
                                   rtol=1e-5, err_msg=key)
    assert float(got["aux_loss"]) > 0
    assert set(box["grads"]) == set(j_box["grads"])
    for name, g in box["grads"].items():
        np.testing.assert_allclose(g.numpy(), j_box["grads"][name].numpy(),
                                   atol=1e-5, rtol=1e-4, err_msg=name)


def test_weight_decay_ranks_are_the_reference(setup):
    """The expert banks are 3-D in the port and 4-D in the reference
    (stacked over the scanned layers): AdamW decays them by the latter."""
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
    assert want["blocks.0.ff.w_up.w"] == 4
    assert want["blocks.1.ff.router.w"] == 3


def test_continuous_path_raises_for_moe(setup):
    _, _, _, model, _ = setup
    # Continuous batching of a mixture of experts is ported: paged pools
    # sharing one block table, and a run that serves every request in
    # vocabulary (token identity with the static path is not promised).
    paged = model.init_cache(2, 16, paged=PageSpec(8, 4, 4))
    assert all(c.tables is paged[0].tables for c in paged)
    with use(device="cpu"):
        res = run_continuous(model)
    assert res["metrics"]["requests"] == 6
    assert all(((t >= 0) & (t < model.cfg.vocab_size)).all()
               for t in res["outputs"].values())


def test_serve_and_train_clis_on_cpu(capsys, tmp_path):
    from repro_torch.core import configure, get_config as engine_config
    before = engine_config()
    engine.reset_stats()
    try:
        serve_main(["--arch", ARCH, "--device", "cpu", "--batch", "2",
                    "--prompt-len", "10", "--gen", "3"])
        train_main(["--arch", ARCH, "--device", "cpu", "--steps", "2",
                    "--seq", "16", "--batch", "2", "--ckpt-dir",
                    str(tmp_path)])
    finally:
        configure(device=before.device, backend=before.backend,
                  fused=before.fused)
    out = capsys.readouterr().out
    assert f"arch={ARCH} device=cpu generated (2, 3)" in out
    # Two layers, two training steps: 3 backward walks a layer a step.
    line = next(ln for ln in out.splitlines()
                if ln.startswith("engine[grouped_gemm]"))
    assert "launches_bwd=12" in line


def test_train_loop_without_checkpoints(setup, tmp_path):
    """``save_every=0`` (the full-width MoE training run on the card, whose
    parameters and AdamW state would be a 34 GB write): no checkpoint, the
    steps all taken."""
    from repro_torch.data import SyntheticLMDataset
    from repro_torch.runtime.train_loop import (TrainLoopConfig,
                                                run_with_restarts)
    _, cfg, _, _, _ = setup
    opt = adamw(warmup_cosine(3e-3, 1, 10))
    ds = SyntheticLMDataset(cfg.vocab_size, 16, 2)

    def make_state():
        model = LanguageModel(cfg, device="cpu", seed=0)
        return model, opt.init(dict(model.named_parameters()))

    with use(backend="engine", device="cpu"):
        out = run_with_restarts(
            make_state, make_train_step(cfg, opt),
            lambda step: {k: torch.from_numpy(v)
                          for k, v in ds.host_batch(step).items()},
            TrainLoopConfig(total_steps=2, ckpt_dir=str(tmp_path),
                            save_every=0, max_restarts=0))
    assert len(out["metrics"]) == 2 and out["final_step"] == 2
    assert list(tmp_path.iterdir()) == []
