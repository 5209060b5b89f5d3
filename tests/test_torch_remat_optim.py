"""Per-group remat and ``scalable_adamw`` in the port against the
reference, on the CPU, from the same JAX-initialised parameters:

  * a recompute runs under the forward's engine configuration when the
    backward runs on another thread (as autograd runs a CUDA backward);
  * for reduced qwen3-0.6b, mamba2-130m, phi3.5-moe-42b and
    recurrentgemma-9b (8 layers: two groups and a remainder; also at 1,024
    tokens, where the local layers' sliding path checkpoints each chunk
    inside the checkpointed group), ``cfg.remat=True``: loss, the MoE
    auxiliary loss and every gradient leaf bit-equal to ``remat=False`` in
    the port, under both backends, and equal to the reference's train step
    under ``remat=True`` at the train-step tolerances (loss, nll,
    grad_norm and aux_loss 1e-5 relative; gradient leaves atol 1e-5 / rtol
    1e-4);
  * ``scalable_adamw`` with and without momentum against the reference
    over 3 updates fed the same gradients, on a model-shaped tree whose
    grouped and remainder matrices are factored: parameters, the bf16
    first moment, ``r``, ``c`` and the unfactored ``v`` within atol 1e-6,
    and the same leaves factored; a stacked 1-D leaf the reference would
    factor across 128 layers raises;
  * the reference's quadratic-convergence and small-state cases
    (tests/test_optim.py);
  * a checkpoint round trip of factored state (bf16 ``m`` kept bf16) and
    a resume that equals the uninterrupted run bit for bit.
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
from repro.models import LanguageModel as JLanguageModel
from repro.optim import adamw as j_adamw
from repro.optim import scalable_adamw as j_scalable_adamw
from repro.optim import warmup_cosine as j_warmup_cosine
from repro.optim.adamw import is_factored_leaf as j_is_factored_leaf
from repro.runtime.steps import make_train_step as j_make_train_step

from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
from repro_torch.configs import get_config, reduced_config
from repro_torch.convert import (opt_state_from_jax_numpy,
                                 params_from_jax_numpy, reference_ndims,
                                 reference_shapes)
from repro_torch.core import use
from repro_torch.data import SyntheticLMDataset
from repro_torch.models import LanguageModel
from repro_torch.optim import (adamw, is_factored_leaf, scalable_adamw,
                               warmup_cosine)
from repro_torch.runtime.steps import make_loss_fn, make_train_step
from repro_torch.runtime.train_loop import TrainLoopConfig, run_with_restarts

BACKENDS = ["torch", "engine"]
REMAT_ARCHS = {
    "qwen3-0.6b": {},
    "mamba2-130m": dict(ssm_chunk=4, d_model=48, ssm_head_dim=8),
    "phi3.5-moe-42b": {},
    "recurrentgemma-9b": dict(num_layers=8),
}
# (arch, batch, seq): recurrentgemma also at 1,024 tokens (the sliding path)
REMAT_CASES = [(a, 2, 16) for a in REMAT_ARCHS] \
    + [("recurrentgemma-9b", 1, 1024)]


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


_SETUPS = {}


def _setup(arch, **extra):
    """(jcfg, cfg, numpy params, JAX params) with ``remat=True``."""
    key = (arch, tuple(sorted(extra.items())))
    if key not in _SETUPS:
        over = dict(REMAT_ARCHS.get(arch, {}), remat=True, **extra)
        jcfg = j_reduced_config(j_get_config(arch), **over)
        cfg = reduced_config(get_config(arch), **over)
        params = JLanguageModel.init(jax.random.PRNGKey(0), jcfg)
        _SETUPS[key] = (jcfg, cfg, _np_tree(params), params)
    return _SETUPS[key]


def _model(cfg, np_params):
    model = LanguageModel(cfg, device="cpu", seed=1)
    model.load_state_dict(params_from_jax_numpy(np_params, cfg, "cpu"),
                          strict=True)
    return model


def _loss_and_grads(cfg, model, batch):
    total, metrics = make_loss_fn(cfg)(model, batch)
    names, params = zip(*model.named_parameters())
    grads = torch.autograd.grad(total, params)
    return total.detach(), metrics, dict(zip(names, grads))


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("arch,b,s", REMAT_CASES)
def test_remat_gradients_bit_equal_to_no_remat(arch, b, s, backend):
    _, cfg, np_params, _ = _setup(arch)
    batch = {k: torch.from_numpy(v) for k, v in
             SyntheticLMDataset(cfg.vocab_size, s, b).host_batch(0).items()}
    plain_cfg = dataclasses.replace(cfg, remat=False)
    # The embedding's backward (an accumulating index_put) adds in a
    # thread-dependent order on the CPU unless deterministic algorithms
    # are asked for: two runs without remat differ in the last bit.
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        with use(backend=backend, device="cpu"):
            got = _loss_and_grads(cfg, _model(cfg, np_params), batch)
            want = _loss_and_grads(plain_cfg, _model(plain_cfg, np_params),
                                   batch)
    finally:
        torch.use_deterministic_algorithms(was)
    assert torch.equal(got[0], want[0])
    assert torch.equal(got[1]["aux_loss"], want[1]["aux_loss"])
    if cfg.num_experts:
        assert float(got[1]["aux_loss"].detach()) > 0
    assert set(got[2]) == set(want[2])
    for name in got[2]:
        assert torch.equal(got[2][name], want[2][name]), name


def test_remat_checkpoints_whole_groups_and_refuses_a_cache():
    """Eight layers, pattern of three: two checkpointed groups (each
    recomputed in the backward) and two remainder layers run once; a
    cache under remat with gradients on raises."""
    _, cfg, np_params, _ = _setup("recurrentgemma-9b")
    model = _model(cfg, np_params)
    calls = []
    for i, block in enumerate(model.blocks):
        block.register_forward_pre_hook(
            lambda _m, _a, i=i: calls.append(i))
    toks = torch.zeros((1, 8), dtype=torch.long)
    with use(backend="torch", device="cpu"):
        logits, _, _ = model.apply(toks)
        assert calls == list(range(8))
        logits.sum().backward()
    assert calls[8:] == [3, 4, 5, 0, 1, 2]  # groups recomputed, last first
    with use(backend="torch", device="cpu"), pytest.raises(ValueError):
        model.apply(toks, cache=model.init_cache(1, 8))


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "recurrentgemma-9b"])
def test_remat_recompute_runs_under_the_forwards_config(arch):
    """The backward of CUDA tensors runs on autograd's device thread, where
    the caller's ``use`` overrides are not set: a recompute must still run
    under the forward's configuration.  Here the backward is taken on
    another thread (the process default stays ``engine`` on ``cuda``);
    the gradients are the ones of a run without remat."""
    import threading
    _, cfg, np_params, _ = _setup(arch)
    batch = {k: torch.from_numpy(v) for k, v in
             SyntheticLMDataset(cfg.vocab_size, 16, 2).host_batch(0).items()}
    plain_cfg = dataclasses.replace(cfg, remat=False)
    with use(backend="torch", device="cpu"):
        want = _loss_and_grads(plain_cfg, _model(plain_cfg, np_params), batch)
        model = _model(cfg, np_params)
        total, _ = make_loss_fn(cfg)(model, batch)
    box = {}

    def backward():
        try:
            box["grads"] = torch.autograd.grad(total, list(model.parameters()))
        except Exception as e:  # reported below
            box["error"] = e

    worker = threading.Thread(target=backward)
    worker.start()
    worker.join(timeout=600)
    assert not worker.is_alive() and "error" not in box, box.get("error")
    for (name, _), g in zip(model.named_parameters(), box["grads"]):
        torch.testing.assert_close(g, want[2][name], rtol=0, atol=0,
                                   msg=name)


def _spy(opt, box, convert):
    def update(grads, *args, **kw):
        box["grads"] = convert(grads)
        return opt.update(grads, *args, **kw)
    return type(opt)(opt.init, update)


@pytest.mark.parametrize("arch,b,s", REMAT_CASES)
def test_remat_train_step_matches_reference_remat(arch, b, s):
    jcfg, cfg, np_params, jparams = _setup(arch)
    assert jcfg.remat and cfg.remat
    batch = JSyntheticLMDataset(jcfg.vocab_size, s, b).host_batch(0)
    j_box, box = {}, {}
    j_opt = _spy(j_adamw(j_warmup_cosine(3e-3, 1, 10)), j_box,
                 lambda g: params_from_jax_numpy(_np_tree(g), cfg, "cpu"))
    with jcore.use(backend="xla"):
        _, _, want = j_make_train_step(jcfg, j_opt)(
            jparams, j_opt.init(jparams),
            {k: jnp.asarray(v) for k, v in batch.items()}, jnp.asarray(0))
    model = _model(cfg, np_params)
    opt = _spy(adamw(warmup_cosine(3e-3, 1, 10)), box,
               lambda g: {k: v.clone() for k, v in g.items()})
    with use(backend="torch", device="cpu"):
        got = make_train_step(cfg, opt)(
            model, opt.init(dict(model.named_parameters())),
            {k: torch.from_numpy(v) for k, v in batch.items()}, 0)
    for key in ("loss", "nll", "grad_norm", "lr", "aux_loss"):
        np.testing.assert_allclose(float(got[key]), float(want[key]),
                                   rtol=1e-5, atol=1e-7, err_msg=key)
    assert set(box["grads"]) == set(j_box["grads"])
    for name, g in box["grads"].items():
        np.testing.assert_allclose(g.numpy(), j_box["grads"][name].numpy(),
                                   atol=1e-5, rtol=1e-4, err_msg=name)


# ---------------------------------------------------------------------------
# scalable_adamw
# ---------------------------------------------------------------------------

# Reduced recurrentgemma wide enough that its matrices are factored
# (both trailing dims >= 128): 8 layers, so grouped and remainder ones.
WIDE = dict(d_model=128, rglru_width=128, d_ff=256, num_heads=4,
            head_dim=32)


def _random_like(tree, seed, scale):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda x: (rng.standard_normal(x.shape) * scale).astype(np.float32),
        tree)


@pytest.mark.parametrize("scale", [1e-4, 10.0])
@pytest.mark.parametrize("use_momentum", [True, False])
def test_scalable_adamw_matches_reference(use_momentum, scale):
    """Three updates fed the same gradients (scale 10 clips them)."""
    jcfg, cfg, np_params, jparams = _setup("recurrentgemma-9b", **WIDE)
    grads = [_random_like(np_params, seed, scale) for seed in (3, 4, 5)]
    j_opt = j_scalable_adamw(j_warmup_cosine(1e-2, 1, 10),
                             use_momentum=use_momentum)
    j_state, j_params = j_opt.init(jparams), jparams
    for step, g in enumerate(grads):
        j_params, j_state, j_metrics = j_opt.update(
            jax.tree.map(jnp.asarray, g), j_state, j_params,
            jnp.asarray(step))

    model = _model(cfg, np_params)
    p = dict(model.named_parameters())
    opt = scalable_adamw(warmup_cosine(1e-2, 1, 10),
                         use_momentum=use_momentum)
    state = opt.init(p, shapes=reference_shapes(cfg, model))
    assert ("m" in state) == use_momentum
    want_init = opt_state_from_jax_numpy(_np_tree(j_opt.init(jparams)), cfg,
                                         "cpu")
    factored = {n for n, v in state["v"].items() if is_factored_leaf(v)}
    assert factored == {n for n, v in want_init["v"].items()
                        if isinstance(v, dict)}
    assert "blocks.0.mixer.gate_a.w" in factored  # grouped
    assert "blocks.7.mixer.gate_a.w" in factored  # remainder
    assert "embed.table" in factored and "blocks.0.mixer.lambda" \
        not in factored
    ndims = reference_ndims(cfg, model)
    with torch.no_grad():
        for step, g in enumerate(grads):
            metrics = opt.update(params_from_jax_numpy(g, cfg, "cpu"), state,
                                 p, step, ndims=ndims)
    np.testing.assert_allclose(float(metrics["grad_norm"]),
                               float(j_metrics["grad_norm"]), rtol=1e-5)
    want_p = params_from_jax_numpy(_np_tree(j_params), cfg, "cpu")
    want_s = opt_state_from_jax_numpy(_np_tree(j_state), cfg, "cpu")
    for name in p:
        np.testing.assert_allclose(p[name].detach().numpy(),
                                   want_p[name].numpy(), atol=1e-6, rtol=0,
                                   err_msg=name)
        if use_momentum:
            m = state["m"][name]
            assert m.dtype == want_s["m"][name].dtype == torch.bfloat16
            np.testing.assert_allclose(m.float().numpy(),
                                       want_s["m"][name].float().numpy(),
                                       atol=1e-6, rtol=0, err_msg=name)
        v, wv = state["v"][name], want_s["v"][name]
        pairs = [(v[k], wv[k]) for k in ("r", "c")] \
            if is_factored_leaf(v) else [(v, wv)]
        for got, want in pairs:
            assert got.shape == want.shape, name
            np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6,
                                       rtol=1e-6, err_msg=name)


def test_scalable_adamw_refuses_a_leaf_factored_across_layers():
    p = {"w": torch.zeros(256), "m": torch.zeros(64, 256)}
    opt = scalable_adamw(1e-3)
    assert not is_factored_leaf(opt.init(p)["v"]["w"])
    with pytest.raises(NotImplementedError, match="stacked"):
        opt.init(p, shapes={"w": (128, 256), "m": (64, 256)})
    assert j_is_factored_leaf(j_scalable_adamw(1e-3).init(
        {"w": jnp.zeros((128, 256))})["v"]["w"])


def _quadratic(params):
    return sum(torch.square(v - 3.0).sum() for v in params.values())


@pytest.mark.parametrize("make_opt", [
    lambda: adamw(0.1),
    lambda: scalable_adamw(0.1),
    lambda: scalable_adamw(0.1, use_momentum=False),
], ids=["adamw", "scalable", "scalable_no_momentum"])
def test_optimizer_converges_on_quadratic(make_opt):
    opt = make_opt()
    params = {"w": torch.zeros((256, 256)), "b": torch.zeros((256,))}
    state = opt.init(params)
    ndims = {k: v.ndim for k, v in params.items()}
    loss0 = float(_quadratic(params))
    for step in range(60):
        grads = {k: 2.0 * (v - 3.0) for k, v in params.items()}
        opt.update(grads, state, params, torch.tensor(step), ndims=ndims)
    assert float(_quadratic(params)) < 0.2 * loss0


def test_scalable_adamw_factored_state_is_small():
    opt = scalable_adamw(1e-3, use_momentum=False)
    params = {"w": torch.zeros((512, 1024))}
    state = opt.init(params)
    v = state["v"]["w"]
    assert set(v) == {"r", "c"}
    assert v["r"].shape == (512,) and v["c"].shape == (1024,)
    n_state = sum(x.numel() for x in v.values())
    assert n_state < 0.01 * params["w"].numel()


# ---------------------------------------------------------------------------
# checkpoint and resume of factored state
# ---------------------------------------------------------------------------

def _train_parts(use_momentum):
    _, cfg, np_params, _ = _setup("recurrentgemma-9b", **WIDE)
    opt = scalable_adamw(warmup_cosine(1e-2, 1, 4),
                         use_momentum=use_momentum)
    ds = SyntheticLMDataset(cfg.vocab_size, 16, 2)

    def make_state():
        model = _model(cfg, np_params)
        return model, opt.init(dict(model.named_parameters()),
                               shapes=reference_shapes(cfg, model))

    def batch_fn(step):
        return {k: torch.from_numpy(v) for k, v in
                ds.host_batch(step).items()}

    return make_state, batch_fn, make_train_step(cfg, opt)


def _flat_state(state):
    out = {}
    for k, tree in state.items():
        for name, v in tree.items():
            if is_factored_leaf(v):
                out.update({f"{k}/{name}/{f}": v[f] for f in v})
            else:
                out[f"{k}/{name}"] = v
    return out


@pytest.mark.parametrize("use_momentum", [True, False])
def test_factored_state_checkpoint_round_trip(use_momentum, tmp_path):
    make_state, batch_fn, step_fn = _train_parts(use_momentum)
    model, state = make_state()
    with use(backend="torch", device="cpu"):
        step_fn(model, state, batch_fn(0), 0)
    tree = {"params": dict(model.named_parameters()), "opt_state": state}
    save_checkpoint(str(tmp_path), 1, tree, async_write=False)
    fresh, fresh_state = make_state()
    restored, meta = restore_checkpoint(
        str(tmp_path), 1, {"params": dict(fresh.named_parameters()),
                           "opt_state": fresh_state})
    assert meta["step"] == 1
    got, want = _flat_state(restored["opt_state"]), _flat_state(state)
    assert set(got) == set(want) and any("/r" in k for k in got)
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k
    for name, p in model.named_parameters():
        assert torch.equal(restored["params"][name], p.detach())


@pytest.mark.parametrize("use_momentum", [True, False])
def test_factored_state_resume_is_exact(use_momentum, tmp_path):
    """Four steps straight against two steps, a restart from the step-2
    checkpoint and two more: the same parameters and state, bit for
    bit."""
    make_state, batch_fn, step_fn = _train_parts(use_momentum)
    with use(backend="torch", device="cpu"):
        straight = run_with_restarts(
            make_state, step_fn, batch_fn,
            TrainLoopConfig(total_steps=4, ckpt_dir=str(tmp_path / "a"),
                            save_every=2))
        run_with_restarts(make_state, step_fn, batch_fn, TrainLoopConfig(
            total_steps=2, ckpt_dir=str(tmp_path / "b"), save_every=2))
        resumed = run_with_restarts(make_state, step_fn, batch_fn,
                                    TrainLoopConfig(total_steps=4,
                                                    ckpt_dir=str(tmp_path / "b"),
                                                    save_every=2))
    assert len(resumed["metrics"]) == 2
    for (name, a), b in zip(straight["model"].named_parameters(),
                            resumed["model"].parameters()):
        assert torch.equal(a, b), name
    got, want = _flat_state(resumed["opt_state"]), \
        _flat_state(straight["opt_state"])
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k
