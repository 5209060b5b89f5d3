"""The port's dense decoder against the reference on
``reduced_config(qwen3-0.6b)`` in float32, from the same JAX-initialised
parameters (``jax.tree.map(np.asarray, params)`` through
``repro_torch.convert``), plus the device policy and the import rule.
"""
import os
import re
import subprocess
import sys
from pathlib import Path

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

from repro_torch.configs import get_config, reduced_config
from repro_torch.convert import params_from_jax_numpy
from repro_torch.core import engine, use
from repro_torch.launch.serve import generate, main as serve_main
from repro_torch.models import LanguageModel

ROOT = Path(__file__).resolve().parents[1]
ATOL = 1e-4


@pytest.fixture(scope="module")
def setup():
    jcfg = j_reduced_config(j_get_config("qwen3-0.6b"))
    cfg = reduced_config(get_config("qwen3-0.6b"))
    assert cfg == type(cfg)(**{f: getattr(jcfg, f)
                              for f in cfg.__dataclass_fields__})
    params = JLanguageModel.init(jax.random.PRNGKey(0), jcfg)
    state = params_from_jax_numpy(jax.tree.map(np.asarray, params), cfg,
                                  device="cpu")
    model = LanguageModel(cfg, device="cpu", seed=1)
    model.load_state_dict(state, strict=True)
    tokens = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 16)).astype(np.int32)
    return jcfg, cfg, params, model, tokens


@pytest.mark.parametrize("backend,j_backend", [("torch", "xla"),
                                               ("engine", "pallas")])
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
        # 7 projections per layer plus the tied read-out; one flash call
        # per layer (causal prefill).
        assert st["gemm"]["launches"] >= 7 * cfg.num_layers + 1
        assert st["flash_attention"]["launches"] == cfg.num_layers


def test_generate_tokens_identical_to_reference(setup):
    jcfg, cfg, params, model, tokens = setup
    want = np.asarray(j_generate(jcfg, params, jnp.asarray(tokens),
                                 4)["tokens"])
    for backend in ("engine", "torch"):
        with use(backend=backend, device="cpu"):
            res = generate(model, torch.from_numpy(tokens), 4)
        np.testing.assert_array_equal(res["tokens"].numpy(), want)


def test_decode_step_matches_full_forward(setup):
    """Prefill + cached decode gives the logits a full forward gives."""
    _, cfg, _, model, tokens = setup
    from repro_torch.runtime.steps import make_prefill_step, make_serve_step
    t = torch.from_numpy(tokens).long()
    with use(device="cpu", backend="engine"), torch.no_grad():
        full, _, _ = model.apply(t)
        logits, cache = make_prefill_step(model, 16)({"tokens": t[:, :-1]})
        step, _, _ = make_serve_step(model)(cache, t[:, -1:],
                                            torch.tensor(15, dtype=torch.int32))
    torch.testing.assert_close(logits, full[:, -2], atol=ATOL, rtol=ATOL)
    torch.testing.assert_close(step, full[:, -1], atol=ATOL, rtol=ATOL)


def test_entry_points_need_a_device_without_cuda(setup):
    """With no device named, entry points run on CUDA; on a host without
    it they raise instead of falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA; the policy under test is its absence")
    _, cfg, params, _, _ = setup
    with pytest.raises(RuntimeError, match="CUDA"):
        LanguageModel(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        params_from_jax_numpy(jax.tree.map(np.asarray, params), cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        serve_main(["--arch", "qwen3-0.6b", "--gen", "2"])


def test_serve_cli_on_cpu(capsys):
    from repro_torch.core import configure, get_config as engine_config
    before = engine_config()
    try:
        serve_main(["--arch", "qwen3-0.6b", "--device", "cpu", "--batch",
                    "2", "--prompt-len", "8", "--gen", "3"])
    finally:
        configure(device=before.device, backend=before.backend)
    out = capsys.readouterr().out
    assert "device=cpu" in out and "generated (2, 3)" in out


def test_unported_configs_raise():
    cfg = reduced_config(get_config("qwen3-0.6b"), num_experts=4)
    with pytest.raises(NotImplementedError):
        LanguageModel(cfg, device="cpu")


def test_import_does_not_load_jax_or_reference():
    code = ("import sys\n"
            "import repro_torch, repro_torch.models, repro_torch.convert\n"
            "import repro_torch.launch.serve, repro_torch.runtime.steps\n"
            "import repro_torch.launch.train, repro_torch.runtime.train_loop\n"
            "import repro_torch.optim, repro_torch.data, repro_torch.checkpoint\n"
            "import repro_torch.models.losses\n"
            "import repro_torch.kernels.gemm, repro_torch.kernels.flash_attention\n"
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
            "       or m == 'repro' or m.startswith('repro.')]\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   cwd=ROOT, timeout=120)


_FORBIDDEN = re.compile(r"^\s*(import\s+jax\b|from\s+jax\b|import\s+repro\b(?!_)"
                        r"|from\s+repro\b(?!_)|import\s+repro\.|from\s+repro\.)")


def test_port_sources_never_import_jax_or_reference():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 10
    for path in files:
        for lineno, line in enumerate(path.read_text().splitlines(), 1):
            assert not _FORBIDDEN.match(line), f"{path}:{lineno}: {line}"
