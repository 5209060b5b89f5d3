"""The port's training path against the reference on
``reduced_config(qwen3-0.6b)`` in float32, from the same JAX-initialised
parameters and the same batches: one train step (loss, nll, grad_norm and
every gradient leaf, also with ``microbatches=2``) under both backend
pairs; AdamW on its own, fed the same gradients; ``warmup_cosine``;
``softmax_cross_entropy``; the synthetic data stream; checkpoints; and
what tests/test_system.py checks, for the port (loss falls, resume is
exact, an injected fault is survived).

Tolerances: loss and nll 1e-5 relative, gradients atol 1e-6 / rtol 1e-4
(float32 on both sides; sums run in another order), grad_norm 1e-5
relative.  AdamW parameters and moments within 1e-6 (the same fp32 ops in
the same order).  Microbatch gradients are summed in bf16 on both sides,
so there they agree to two bf16 ulps of each leaf's largest entry.
"""
import math
import os
import threading

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
from repro.models.losses import softmax_cross_entropy as j_xent
from repro.optim import adamw as j_adamw
from repro.optim import warmup_cosine as j_warmup_cosine
from repro.runtime.steps import make_train_step as j_make_train_step

from repro_torch.checkpoint import (CheckpointManager, latest_step,
                                    restore_checkpoint, save_checkpoint)
from repro_torch.configs import get_config, reduced_config
from repro_torch.convert import (opt_state_from_jax_numpy,
                                 params_from_jax_numpy, reference_ndims)
from repro_torch.core import engine, use
from repro_torch.data import SyntheticLMDataset
from repro_torch.launch.train import main as train_main
from repro_torch.models import LanguageModel
from repro_torch.models.losses import softmax_cross_entropy
from repro_torch.optim import Optimizer, adamw, warmup_cosine
from repro_torch.runtime.steps import make_loss_fn, make_train_step
from repro_torch.runtime.train_loop import (TrainLoopConfig,
                                            run_with_restarts, train)

BATCH, SEQ = 4, 16


@pytest.fixture(autouse=True)
def _cpu_engine():
    with use(device="cpu", backend="engine"):
        engine.reset_stats()
        yield


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def setup():
    jcfg = j_reduced_config(j_get_config("qwen3-0.6b"))
    cfg = reduced_config(get_config("qwen3-0.6b"))
    params = JLanguageModel.init(jax.random.PRNGKey(0), jcfg)
    batch = JSyntheticLMDataset(jcfg.vocab_size, SEQ, BATCH).host_batch(0)
    return jcfg, cfg, params, batch


def _port_model(cfg, params):
    model = LanguageModel(cfg, device="cpu", seed=1)
    model.load_state_dict(params_from_jax_numpy(_np_tree(params), cfg,
                                                device="cpu"))
    return model


def _spy(opt, box, convert):
    """The optimizer with its update recording the gradients it is fed."""
    def update(grads, *args, **kw):
        box["grads"] = convert(grads)
        return opt.update(grads, *args, **kw)
    return type(opt)(opt.init, update)


@pytest.mark.parametrize("microbatches", [1, 2])
@pytest.mark.parametrize("backend,j_backend", [("torch", "xla"),
                                               ("engine", "pallas")])
def test_train_step_matches_reference(setup, backend, j_backend,
                                      microbatches):
    jcfg, cfg, params, batch = setup
    j_box, box = {}, {}
    j_opt = _spy(j_adamw(warmup_cosine_pair()[1]), j_box,
                 lambda g: params_from_jax_numpy(_np_tree(g), cfg, "cpu"))
    with jcore.use(backend=j_backend):
        j_step = j_make_train_step(jcfg, j_opt, microbatches=microbatches)
        _, _, want = j_step(params, j_opt.init(params),
                            {k: jnp.asarray(v) for k, v in batch.items()},
                            jnp.asarray(0))

    model = _port_model(cfg, params)
    opt = _spy(adamw(warmup_cosine_pair()[0]), box,
               lambda g: {k: v.clone() for k, v in g.items()})
    with use(backend=backend, device="cpu"):
        engine.reset_stats()
        got = make_train_step(cfg, opt, microbatches=microbatches)(
            model, opt.init(dict(model.named_parameters())),
            {k: torch.from_numpy(v) for k, v in batch.items()}, 0)
    if backend == "engine":
        st = engine.stats()
        assert st["flash_attention"]["launches"] == \
            cfg.num_layers * microbatches
        assert st["flash_attention"]["launches_bwd"] == \
            cfg.num_layers * microbatches
        assert st["gemm"]["launches"] >= \
            (7 * cfg.num_layers + 1) * microbatches

    for key in ("loss", "nll", "grad_norm", "lr"):
        np.testing.assert_allclose(float(got[key]), float(want[key]),
                                   rtol=1e-5, err_msg=key)
    assert set(box["grads"]) == set(j_box["grads"])
    for name, g in box["grads"].items():
        want_g = j_box["grads"][name].float().numpy()
        # bf16 sums: a rounding flip moves a sum by an ulp of its terms,
        # so the bound is two bf16 ulps of the leaf's largest entry.
        tol = dict(atol=1e-6, rtol=1e-4) if microbatches == 1 else \
            dict(atol=2.0 ** -7 * np.abs(want_g).max(), rtol=1e-2)
        np.testing.assert_allclose(g.float().numpy(), want_g, err_msg=name,
                                   **tol)


def warmup_cosine_pair(peak=3e-3, warmup=2, total=20):
    return (warmup_cosine(peak, warmup, total),
            j_warmup_cosine(peak, warmup, total))


def test_loss_fn_metrics_match_reference(setup):
    jcfg, cfg, params, batch = setup
    from repro.runtime.steps import make_loss_fn as j_make_loss_fn
    _, want = j_make_loss_fn(jcfg)(params,
                                   {k: jnp.asarray(v) for k, v in batch.items()})
    with use(backend="torch", device="cpu"), torch.no_grad():
        _, got = make_loss_fn(cfg)(_port_model(cfg, params),
                                   {k: torch.from_numpy(v)
                                    for k, v in batch.items()})
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_allclose(float(got[key]), float(want[key]),
                                   rtol=1e-5, atol=1e-7, err_msg=key)


def _random_like(tree, seed, scale):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda x: (rng.standard_normal(x.shape) * scale).astype(np.float32),
        _np_tree(tree))


@pytest.mark.parametrize("scales", [(1e-3, 1e-3), (10.0, 1e-2)])
def test_adamw_on_its_own_matches_reference(setup, scales):
    """Two AdamW updates fed the same gradients (the second scale set
    clips the first update): parameters and moments within 1e-6.  This
    is what catches the decay rule, which follows the reference's
    stacked ranks."""
    jcfg, cfg, params, _ = setup
    g1, g2 = (_random_like(params, s, sc) for s, sc in zip((3, 4), scales))
    j_opt = j_adamw(j_warmup_cosine(1e-2, 1, 10))
    j_state = j_opt.init(params)
    j_params = params
    for step, g in enumerate((g1, g2)):
        j_params, j_state, j_metrics = j_opt.update(
            jax.tree.map(jnp.asarray, g), j_state, j_params, jnp.asarray(step))

    p = params_from_jax_numpy(_np_tree(params), cfg, "cpu")
    state = opt_state_from_jax_numpy(_np_tree(j_opt.init(params)), cfg, "cpu")
    opt = adamw(warmup_cosine(1e-2, 1, 10))
    ndims = reference_ndims(cfg, p)
    for step, g in enumerate((g1, g2)):
        metrics = opt.update(params_from_jax_numpy(g, cfg, "cpu"), state, p,
                             step, ndims=ndims)
    np.testing.assert_allclose(float(metrics["grad_norm"]),
                               float(j_metrics["grad_norm"]), rtol=1e-5)
    want_p = params_from_jax_numpy(_np_tree(j_params), cfg, "cpu")
    want_s = opt_state_from_jax_numpy(_np_tree(j_state), cfg, "cpu")
    for name in p:
        np.testing.assert_allclose(p[name].numpy(), want_p[name].numpy(),
                                   atol=1e-6, rtol=0, err_msg=name)
        for k in ("m", "v"):
            np.testing.assert_allclose(state[k][name].numpy(),
                                       want_s[k][name].numpy(), atol=1e-6,
                                       rtol=0, err_msg=f"{k} {name}")


def test_decay_by_own_rank_would_not_match(setup):
    """The trap the stacked ranks avoid: deciding decay by the port's own
    (unstacked) rank leaves the per-layer norm scales undecayed."""
    jcfg, cfg, params, _ = setup
    p = params_from_jax_numpy(_np_tree(params), cfg, "cpu")
    ndims = reference_ndims(cfg, p)
    scales = [n for n in p if n.startswith("blocks.") and n.endswith("scale")]
    assert scales and all(p[n].ndim == 1 and ndims[n] == 2 for n in scales)
    assert ndims["final_norm.scale"] == 1 and ndims["embed.table"] == 2
    g = params_from_jax_numpy(_random_like(params, 5, 1e-3), cfg, "cpu")
    own = {k: v.clone() for k, v in p.items()}
    opt = adamw(1e-2)
    opt.update(g, opt.init(p), p, 0, ndims=ndims)
    opt.update(g, opt.init(own), own, 0,
               ndims={k: v.ndim for k, v in own.items()})
    assert all(not torch.equal(p[n], own[n]) for n in scales)


def test_reference_ndims_with_a_remainder_layer():
    """Three layers over a two-block pattern: one scanned group of two
    (stacked, rank + 1) and one remainder layer (not stacked)."""
    over = dict(block_pattern=("attn", "attn"), num_layers=3)
    jcfg = j_reduced_config(j_get_config("qwen3-0.6b"), **over)
    cfg = reduced_config(get_config("qwen3-0.6b"), **over)
    tree = _np_tree(JLanguageModel.init(jax.random.PRNGKey(0), jcfg))
    model = LanguageModel(cfg, device="cpu")
    ndims = reference_ndims(cfg, model)
    want = {}
    for i in range(2):
        for name, arr in _flat(tree["blocks"]["groups"][f"b{i}"]):
            want[f"blocks.{i}.{name}"] = arr.ndim
    for name, arr in _flat(tree["blocks"]["rem"][0]):
        want[f"blocks.2.{name}"] = arr.ndim
    want.update({"embed.table": 2, "final_norm.scale": 1})
    assert ndims == want


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


@pytest.mark.parametrize("args", [(3e-3, 10, 100), (1e-3, 0, 7),
                                  (5e-4, 5, 5, 0.0)])
def test_warmup_cosine_matches_reference(args):
    lr, j_lr = warmup_cosine(*args), j_warmup_cosine(*args)
    for step in range(0, 12):
        np.testing.assert_allclose(float(lr(step)),
                                   float(j_lr(jnp.asarray(step))),
                                   rtol=1e-6, err_msg=str(step))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("z_loss,masked", [(0.0, False), (1e-4, True)])
def test_softmax_cross_entropy_matches_reference(dtype, z_loss, masked):
    """Loss, metrics and d(logits) (in the logits' dtype), within 1e-5
    (fp32) or one bf16 ulp of the gradient (bf16)."""
    rng = np.random.default_rng(0)
    logits = (rng.standard_normal((3, 5, 50)) * 3).astype(np.float32)
    labels = rng.integers(0, 50, (3, 5)).astype(np.int32)
    mask = (rng.random((3, 5)) > 0.3).astype(np.float32) if masked else None
    jl = jnp.asarray(logits, dtype)

    def j_loss(x):
        return j_xent(x, jnp.asarray(labels), z_loss=z_loss,
                      mask=None if mask is None else jnp.asarray(mask))

    (j_val, j_metrics), j_grad = jax.value_and_grad(j_loss, has_aux=True)(jl)
    tl = torch.from_numpy(logits).to(getattr(torch, dtype)).requires_grad_()
    val, metrics = softmax_cross_entropy(
        tl, torch.from_numpy(labels), z_loss=z_loss,
        mask=None if mask is None else torch.from_numpy(mask))
    (grad,) = torch.autograd.grad(val, tl)
    assert grad.dtype == tl.dtype
    np.testing.assert_allclose(float(val.detach()), float(j_val), rtol=1e-5)
    for key in ("nll", "ppl_proxy"):
        np.testing.assert_allclose(float(metrics[key].detach()), float(j_metrics[key]),
                                   rtol=1e-5)
    tol = 1e-5 if dtype == "float32" else 1e-2
    np.testing.assert_allclose(grad.float().numpy(),
                               np.asarray(j_grad, np.float32), atol=tol,
                               rtol=tol)


@pytest.mark.parametrize("vocab,seq,batch,seed,branching",
                         [(512, 16, 4, 1234, 8), (128, 32, 8, 5, 4),
                          (151936, 128, 2, 1234, 8)])
def test_host_batch_equals_reference(vocab, seq, batch, seed, branching):
    ds = SyntheticLMDataset(vocab, seq, batch, seed=seed, branching=branching)
    j_ds = JSyntheticLMDataset(vocab, seq, batch, seed=seed,
                               branching=branching)
    for step in (0, 1, 17):
        got, want = ds.host_batch(step), j_ds.host_batch(step)
        for key in ("tokens", "labels"):
            assert got[key].dtype == want[key].dtype == np.int32
            np.testing.assert_array_equal(got[key], want[key])
    assert ds.unigram_floor_nats() == j_ds.unigram_floor_nats()


def test_grad_compress_is_not_ported(setup):
    _, cfg, _, _ = setup
    with pytest.raises(NotImplementedError, match="grad_compress"):
        make_train_step(cfg, adamw(1e-3), grad_compress=True)


# ---------------------------------------------------------------------------
# checkpoints and the loop (tests/test_system.py, for the port)
# ---------------------------------------------------------------------------

def test_checkpoint_round_trip_and_retention(tmp_path):
    tree = {"params": {"a.w": torch.arange(6.).reshape(2, 3),
                       "b": torch.ones(4, dtype=torch.bfloat16)},
            "opt_state": {"m": {"a.w": torch.full((2, 3), 0.5)}}}
    for step in (1, 2, 3, 4):
        save_checkpoint(str(tmp_path), step, tree, meta={"data_step": step},
                        max_to_keep=2, async_write=False)
    assert sorted(os.listdir(tmp_path)) == ["step_3", "step_4"]
    assert latest_step(str(tmp_path)) == 4
    zeros = {"params": {k: torch.zeros_like(v)
                        for k, v in tree["params"].items()},
             "opt_state": {"m": {"a.w": torch.zeros(2, 3)}}}
    got, meta = restore_checkpoint(str(tmp_path), 4, zeros)
    assert meta == {"step": 4, "data_step": 4}
    assert got["params"]["b"].dtype == torch.bfloat16
    for a, b in ((got["params"], tree["params"]),
                 (got["opt_state"]["m"], tree["opt_state"]["m"])):
        for k in b:
            assert torch.equal(a[k], b[k])
    with np.load(tmp_path / "step_4" / "arrays.npz") as arrays:
        assert set(arrays) == {"params/a.w", "params/b", "opt_state/m/a.w"}
    with pytest.raises(KeyError, match="missing"):
        restore_checkpoint(str(tmp_path), 4, {"other": torch.zeros(1)})


@pytest.mark.parametrize("dtype", [torch.float32, torch.int64, torch.bfloat16])
def test_async_save_is_a_snapshot(tmp_path, monkeypatch, dtype):
    """An asynchronous save writes the values the tensors held at the call,
    even when the caller changes them in place (as the next training step
    does) before the writer thread reaches them."""
    go = threading.Event()
    savez = np.savez

    def gated_savez(*args, **kwargs):
        go.wait(timeout=60)
        savez(*args, **kwargs)

    monkeypatch.setattr(np, "savez", gated_savez)
    w = torch.arange(6).reshape(2, 3).to(dtype)
    m = torch.ones(3, dtype=dtype)
    tree = {"params": {"w": w}, "opt_state": {"m": {"w": m}}}
    want = {"params": {"w": w.clone()}, "opt_state": {"m": {"w": m.clone()}}}
    writer = save_checkpoint(str(tmp_path), 1, tree)
    with torch.no_grad():
        w.add_(100)
        m.mul_(7)
    go.set()
    writer.join()
    got, _ = restore_checkpoint(str(tmp_path), 1, tree)
    assert torch.equal(got["params"]["w"], want["params"]["w"])
    assert torch.equal(got["opt_state"]["m"]["w"], want["opt_state"]["m"]["w"])


def _job(tmp_path, steps, vocab=128, seq=32, batch=8, save_every=10):
    cfg = reduced_config(get_config("qwen3-0.6b"), vocab_size=vocab)
    opt = adamw(5e-3)
    ds = SyntheticLMDataset(vocab, seq, batch, seed=5, branching=4)

    def make_state():
        model = LanguageModel(cfg, device="cpu", seed=0)
        return model, opt.init(dict(model.named_parameters()))

    def batch_fn(step):
        return {k: torch.from_numpy(v) for k, v in ds.host_batch(step).items()}

    loop = TrainLoopConfig(total_steps=steps, ckpt_dir=str(tmp_path),
                           save_every=save_every, log_every=1000)
    return cfg, make_train_step(cfg, opt), make_state, batch_fn, loop




def test_training_reduces_loss(tmp_path):
    _, step_fn, make_state, batch_fn, loop = _job(tmp_path, steps=40)
    out = train(step_fn, *make_state(), batch_fn, loop)
    first, last = out["metrics"][0]["nll"], out["metrics"][-1]["nll"]
    assert first > 0.8 * math.log(128)  # starts near random
    assert last < first - 0.5           # learns the bigram structure
    assert out["engine_stats"]["flash_attention"]["launches_bwd"] == \
        40 * 2


def _params(model):
    return {k: v.detach().clone() for k, v in model.named_parameters()}


def test_resume_from_checkpoint_is_exact(tmp_path):
    """20 steps straight against 10, a checkpoint, and 10 more."""
    _, step_fn, make_state, batch_fn, loop = _job(tmp_path / "a", steps=20,
                                                  save_every=100)
    ref = _params(train(step_fn, *make_state(), batch_fn, loop)["model"])

    _, step_fn, make_state, batch_fn, loop = _job(tmp_path / "b", steps=10)
    mid = train(step_fn, *make_state(), batch_fn, loop)
    model, opt_state = make_state()
    restored, meta = CheckpointManager(str(tmp_path / "b")).restore_latest(
        {"params": dict(model.named_parameters()), "opt_state": opt_state})
    assert meta["data_step"] == 10
    model.load_state_dict(restored["params"])
    loop.total_steps, loop.save_every = 20, 100
    out = train(step_fn, model, restored["opt_state"], batch_fn, loop,
                start_step=10)
    assert out["final_step"] == 20
    for name, p in _params(out["model"]).items():
        torch.testing.assert_close(p, ref[name], atol=1e-5, rtol=1e-5)
    del mid


@pytest.mark.parametrize("fail_at", [17, 3])
def test_supervisor_survives_fault_injection(tmp_path, fail_at):
    """A simulated node failure is survived by restarting from the last
    checkpoint -- at step 17 from step 10's, at step 3 from fresh state
    (make_state builds anew, so no weights a failed attempt stepped leak
    in) -- and the result equals an uninterrupted run's."""
    _, step_fn, make_state, batch_fn, loop = _job(tmp_path / "ref", steps=20,
                                                  save_every=100)
    ref = _params(train(step_fn, *make_state(), batch_fn, loop)["model"])
    _, step_fn, make_state, batch_fn, loop = _job(tmp_path / "f", steps=20)
    fired = {"n": 0}

    def injector(step):
        if step == fail_at and fired["n"] == 0:
            fired["n"] = 1
            raise RuntimeError("simulated node failure")

    out = run_with_restarts(make_state, step_fn, batch_fn, loop,
                            fault_injector=injector)
    assert (out["final_step"], out["restarts"], fired["n"]) == (20, 1, 1)
    for name, p in _params(out["model"]).items():
        torch.testing.assert_close(p, ref[name], atol=1e-5, rtol=1e-5)


def test_train_cli_on_cpu(tmp_path, capsys):
    from repro_torch.core import configure, get_config as engine_config
    before = engine_config()
    try:
        train_main(["--arch", "qwen3-0.6b", "--device", "cpu", "--steps", "3",
                    "--ckpt-dir", str(tmp_path)])
    finally:
        configure(device=before.device, backend=before.backend,
                  fused=before.fused)
    out = capsys.readouterr().out
    assert "device=cpu" in out and "step     2" in out
    assert "engine[flash_attention]: launches=6 launches_bwd=6" in out
    assert latest_step(str(tmp_path)) == 3


def test_optimizer_is_a_plain_pair():
    opt = adamw(1e-3)
    assert isinstance(opt, Optimizer)
    p = {"w": torch.ones(2, 2), "b": torch.ones(2)}
    state = opt.init(p)
    assert all(state[k][n].dtype == torch.float32 and not state[k][n].any()
               for k in ("m", "v") for n in p)
