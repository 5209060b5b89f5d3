"""A run with its timed path broken comes out not correct.

Each test skips the run's look for a card and drives the rest of a run on
the CPU, at a tiny width with the cell's traffic scaled down, through the
port's plain CPU versions; the break is planted in the program underneath:
a served token altered where it is produced, a training step that leaves
the state unchanged, a training step that leaves out half of its batch.
The limits are the cell's own."""
import copy
import functools
import time

import pytest

import run
from harness import files

BENCH = files.load_benchmark()


def tiny_cell(name):
    cell = files.cell(BENCH, name)
    cfg = copy.deepcopy(files.load_data("configs", cell["config"]))
    moe = bool(cfg["model"]["num_experts"])
    cfg["model"].update(num_layers=2, d_model=64, num_heads=4,
                        num_kv_heads=2 if moe else 4, head_dim=16, d_ff=128,
                        vocab_size=512, num_experts=4 if moe else 0,
                        num_experts_per_tok=2 if moe else 0, moe_group=64)
    traffic = files.load_data("traffic", cell["traffic"])
    if traffic["driver"] == "train":
        traffic.update(batch=2, seq=32, profile_steps=1)
    else:
        traffic.update(ramp_s=1.0, slots=4, page_size=4, profile_s=0.5,
                       sample_requests=2,
                       prompt_tokens={"median": 16, "sigma": 0.5, "min": 8,
                                      "max": 32},
                       prune={"prompt_min": 8, "prompt_max": 32,
                              "output_min": 4, "total_max": 42},
                       output_tokens={"median": 6, "sigma": 0.5, "min": 4,
                                      "max": 10})
        if traffic["driver"] == "open_loop":
            traffic["rate_per_s"] = 8.0
        else:
            traffic.update(backlog_requests=2000, ramp_admissions=4)
    limits = files.load_data("limits", name)
    return cell, cfg, traffic, limits


def drive(name, seed=2**31 + 5, driver=None):
    cell, cfg, traffic, limits = tiny_cell(name)
    if driver == "open_loop":
        traffic.update(driver="open_loop", rate_per_s=8.0)
        del traffic["ramp_admissions"], traffic["backlog_requests"]
    assert all(v is not None for v in limits["limits"].values()), \
        "the cell's limits are not set"
    result, _ = run.run_cell(BENCH, cell, cfg, traffic, limits, seed, 2.0,
                             False, "cpu", time.perf_counter())
    return result


def failed(result):
    return [k for k, v in result["check"].items() if v["value"] > v["limit"]]


@pytest.fixture
def steps_module():
    run.set_environment()
    from harness import port
    port._import()
    import repro_torch.runtime.steps as steps
    return steps


@pytest.mark.parametrize("driver", ["saturated", "open_loop"])
def test_served_token_altered(driver, steps_module, monkeypatch):
    real = steps_module.make_paged_serve_step

    def broken(model):
        step = real(model)

        def altered(cache, tokens, lengths, active):
            tok, cache, lengths = step(cache, tokens, lengths, active)
            return (tok + 1) % model.cfg.vocab_size, cache, lengths
        return altered

    monkeypatch.setattr(steps_module, "make_paged_serve_step", broken)
    result = drive("phi35moe-batch", driver=driver)
    assert result["correct"] is False
    assert failed(result) == ["mean_logit_gap"]


def test_train_state_unchanged(steps_module, monkeypatch):
    import repro_torch.optim as optim
    real = optim.adamw

    @functools.wraps(real)
    def broken(lr, **kw):
        opt = real(lr, **kw)
        return optim.Optimizer(opt.init, lambda *a, **k: {})

    monkeypatch.setattr(optim, "adamw", broken)
    result = drive("phi3mini-train")
    assert result["correct"] is False
    assert "change_gap" in failed(result)


def test_train_half_batch(steps_module, monkeypatch):
    real = steps_module.make_train_step

    def broken(cfg, optimizer, **kw):
        step = real(cfg, optimizer, **kw)

        def half(model, opt_state, batch, i):
            rows = batch["tokens"].shape[0] // 2
            return step(model, opt_state,
                        {k: v[:rows] for k, v in batch.items()}, i)
        return half

    monkeypatch.setattr(steps_module, "make_train_step", broken)
    result = drive("phi3mini-train")
    assert result["correct"] is False
    assert failed(result)


def test_a_backlog_that_runs_dry_fails_the_run():
    """A saturated cell whose backlog is all admitted inside the window
    would measure a half-empty batch: the run stops instead."""
    cell, cfg, traffic, limits = tiny_cell("phi35moe-batch")
    traffic.update(backlog_requests=6)
    with pytest.raises(RuntimeError, match="larger backlog"):
        run.run_cell(BENCH, cell, cfg, traffic, limits, 2**31 + 5, 2.0,
                     False, "cpu", time.perf_counter())
