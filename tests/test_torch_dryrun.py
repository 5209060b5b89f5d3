"""``repro_torch.launch.dryrun`` held to the reference's dry-run.

The reference compiles every cell on a forced 512-device XLA mesh; its
module sets ``XLA_FLAGS`` for 512 host devices when imported, so it is
never imported here: one subprocess prints its ``pick_optimizer``,
``pick_microbatches`` and serving-FSDP choices for every cell as JSON.

The per-device argument bytes of every ``ok`` cell are held to an oracle
built from the reference alone: its ``repro.runtime.steps`` shapes
(``jax.eval_shape``, no compile) under its ``repro.runtime.sharding``
specs on a shape-only mesh, each leaf's bytes divided by the product of
its spec's axis sizes.  They must be equal, with no tolerance.
"""
import functools
import itertools
import json
import math
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.configs import get_config as j_get_config
from repro.configs import list_configs
from repro.configs.shapes import SHAPES as J_SHAPES
from repro.configs.shapes import cell_applicable as j_cell_applicable
from repro.configs.shapes import input_specs as j_input_specs
from repro.optim import adamw as j_adamw
from repro.optim import scalable_adamw as j_scalable_adamw
from repro.optim import warmup_cosine as j_warmup_cosine
from repro.runtime import sharding as jshd
from repro.runtime import steps as jsteps

from repro_torch.configs import SHAPES, get_config
from repro_torch.launch import dryrun
from repro_torch.runtime import steps

ROOT = os.path.join(os.path.dirname(__file__), "..")
ARCHS = list_configs()
MESHES = {"pod": dict(data=16, model=16),
          "multipod": dict(pod=2, data=16, model=16)}
ALL_CELLS = list(itertools.product(ARCHS, list(J_SHAPES), list(MESHES)))
OK_CELLS = [c for c in ALL_CELLS
            if not j_cell_applicable(j_get_config(c[0]), J_SHAPES[c[1]])]

_CHOICES_SCRIPT = r"""
import json
import jax
import repro.launch.dryrun as d
from repro.configs import SHAPES, get_config, list_configs
from repro.launch.mesh import make_production_mesh
meshes = {"pod": make_production_mesh(),
          "multipod": make_production_mesh(multi_pod=True)}
out = {}
for arch in list_configs():
    cfg = get_config(arch)
    opt = d.pick_optimizer(cfg)
    state = opt.init({"w": jax.numpy.zeros((256, 256))})
    fp = [opt.init.__qualname__.split(".")[0], sorted(state),
          isinstance(state["v"]["w"], dict)]
    for shape, suite in SHAPES.items():
        for kind, mesh in meshes.items():
            # The serving rule, inline in the reference's run_cell.
            msize = mesh.shape.get("model", 1)
            fsdp = True if suite.kind == "train" else \
                2.0 * cfg.param_count() / msize / 2**30 > 8.0
            out[f"{arch}|{shape}|{kind}"] = dict(
                microbatches=d.pick_microbatches(cfg, suite), optimizer=fp,
                fsdp=fsdp, devices=len(jax.devices()))
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def choices():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", _CHOICES_SCRIPT], env=env,
                         capture_output=True, text=True, timeout=300,
                         check=True)
    return json.loads(out.stdout.strip().splitlines()[-1])


class FakeMesh:
    """Shape-only mesh stand-in (``tests/test_sharding.py``'s), read by
    the reference's sharding rules."""

    def __init__(self, **axes):
        self.shape = dict(axes)
        self.axis_names = tuple(axes)


def _optimizer_fingerprint(opt):
    """(constructor, state keys, factored 256 x 256 leaf) of an optimizer, the
    same probe in both packages."""
    try:
        state = opt.init({"w": torch.zeros((256, 256))})
    except Exception:
        state = opt.init({"w": jnp.zeros((256, 256))})
    return [opt.init.__qualname__.split(".")[0], sorted(state),
            isinstance(state["v"]["w"], dict)]


@pytest.mark.parametrize("arch,shape,mesh", ALL_CELLS)
def test_choices_match_reference(choices, arch, shape, mesh):
    want = choices[f"{arch}|{shape}|{mesh}"]
    assert want["devices"] == 512  # the subprocess's forced host mesh
    cfg, suite = get_config(arch), SHAPES[shape]
    assert dryrun.pick_microbatches(cfg, suite) == want["microbatches"]
    assert _optimizer_fingerprint(dryrun.pick_optimizer(cfg)) == \
        want["optimizer"]
    fsdp = True if suite.kind == "train" else \
        dryrun.serve_fsdp(cfg, dryrun.make_shape_mesh(mesh))
    assert fsdp == want["fsdp"]


# ---------------------------------------------------------------------------
# argument bytes: the reference's shapes under its placements
# ---------------------------------------------------------------------------

def _leaf_bytes(leaf, spec, mesh) -> int:
    parts = 1
    for axis in spec:
        for a in ((axis,) if isinstance(axis, str) else axis or ()):
            parts *= mesh.shape[a]
    numel = math.prod(leaf.shape)
    assert numel % parts == 0
    return numel // parts * jnp.dtype(leaf.dtype).itemsize


def _tree_bytes(shapes, specs, mesh) -> int:
    leaves = jax.tree.leaves(shapes)
    spec_leaves = jax.tree.leaves(specs, is_leaf=lambda x: isinstance(x, P))
    assert len(leaves) == len(spec_leaves)
    return sum(_leaf_bytes(x, s, mesh) for x, s in zip(leaves, spec_leaves))


@functools.lru_cache(maxsize=None)
def _ref_params(arch):
    return jsteps.param_shapes(j_get_config(arch))


def _ref_optimizer(fingerprint):
    sched = j_warmup_cosine(3e-4, 1000, 100000)
    name, keys, _ = fingerprint
    if name == "adamw":
        return j_adamw(sched)
    return j_scalable_adamw(sched, use_momentum="m" in keys)


def reference_argument_bytes(arch, shape, mesh_kind, choice):
    """The oracle: per-device bytes of the reference's step arguments."""
    cfg, suite = j_get_config(arch), J_SHAPES[shape]
    mesh = FakeMesh(**MESHES[mesh_kind])
    pshapes = _ref_params(arch)
    out = {}
    if suite.kind == "train":
        pspecs = jshd.param_pspecs(pshapes, cfg, mesh, fsdp=True)
        out["params"] = _tree_bytes(pshapes, pspecs, mesh)
        oshapes = jsteps.opt_state_shapes(
            cfg, _ref_optimizer(choice["optimizer"]), pshapes)
        out["opt_state"] = _tree_bytes(
            oshapes, jshd.opt_pspecs(oshapes, pshapes, cfg, mesh), mesh)
    else:
        served = jax.tree.map(
            lambda s: jax.ShapeDtypeStruct(s.shape, jnp.bfloat16)
            if s.dtype == jnp.float32 else s, pshapes)
        pspecs = jshd.param_pspecs(served, cfg, mesh, fsdp=choice["fsdp"])
        out["params"] = _tree_bytes(served, pspecs, mesh)
    if suite.kind == "decode":
        cshapes = jsteps.cache_shapes(cfg, suite.global_batch, suite.seq_len)
        out["cache"] = _tree_bytes(
            cshapes, jshd.cache_pspecs(cshapes, cfg, mesh), mesh)
    ispecs = j_input_specs(cfg, suite)
    bspecs = jshd.batch_pspecs(ispecs, mesh)
    out["batch"] = sum(_leaf_bytes(ispecs[k], bspecs[k], mesh)
                       for k in ispecs)
    if suite.kind == "train":
        out["step"] = 4  # the int32 step counter
    return out


@functools.lru_cache(maxsize=None)
def _meta_model(arch):
    return steps.param_shapes(get_config(arch))


@pytest.mark.parametrize("arch,shape,mesh", OK_CELLS)
def test_argument_bytes_equal_reference(choices, arch, shape, mesh):
    want = reference_argument_bytes(arch, shape, mesh,
                                    choices[f"{arch}|{shape}|{mesh}"])
    got = dryrun.argument_bytes(get_config(arch), SHAPES[shape],
                                dryrun.make_shape_mesh(mesh),
                                model=_meta_model(arch))
    assert got == want


def test_sixty_four_ok_cells():
    assert len(OK_CELLS) == 64 and len(ALL_CELLS) == 80


def test_meta_model_holds_no_storage():
    model = _meta_model("grok-1-314b")
    params = list(model.parameters())
    assert all(p.is_meta for p in params)
    ref = sum(math.prod(x.shape)
              for x in jax.tree.leaves(_ref_params("grok-1-314b")))
    assert sum(p.numel() for p in params) == ref > 316e9


def test_spec_bytes():
    mesh = dryrun.ShapeMesh(pod=2, data=16, model=16)
    assert mesh.size() == 512
    assert dryrun.spec_bytes((64, 128), 4, ("data", "model"), mesh) == 128
    assert dryrun.spec_bytes((64, 128), 2, ((("pod", "data")), None),
                             mesh) == 512
    assert dryrun.spec_bytes((), 4, (), mesh) == 4
    with pytest.raises(ValueError):
        dryrun.spec_bytes((6,), 4, ("data",), mesh)


# ---------------------------------------------------------------------------
# one full-width cell
# ---------------------------------------------------------------------------

def test_full_width_decode_cell():
    """qwen3-0.6b x decode_32k on the pod mesh: every projection and the
    tied read-out is one engine GEMM a layer for each of the 128 tokens,
    and the dense-cache attention is two products outside the engine."""
    cfg = get_config("qwen3-0.6b")
    rec = dryrun.run_cell("qwen3-0.6b", "decode_32k", "pod", save=False,
                          _cache={("model", "qwen3-0.6b"):
                                  _meta_model("qwen3-0.6b")})
    assert rec["status"] == "ok" and rec["chips"] == 256
    model = _meta_model("qwen3-0.6b")
    linear = sum(p.numel() for n, p in model.named_parameters()
                 if p.ndim == 2)  # every weight; the table is the read-out
    b, s = 128, 32768
    fam = rec["cost"]["families"]
    assert set(fam) == {"gemm"}
    assert fam["gemm"]["calls"] == 7 * cfg.num_layers + 1
    assert fam["gemm"]["flops"] == 2 * b * linear
    attn = 2 * 2 * b * cfg.num_heads * s * cfg.head_dim * cfg.num_layers
    assert rec["cost"]["non_engine_flops"] * 256 == attn
    assert rec["cost"]["flops_per_device"] * 256 == fam["gemm"]["flops"]
    assert rec["memory"]["temp_bytes"] is None
    assert rec["memory"]["peak_per_device"] is None
    assert rec["collectives"] is None and rec["gaps"]
    parts = rec["memory"]["argument_parts"]
    assert rec["memory"]["alias_bytes"] == parts["cache"]
    assert rec["memory"]["argument_bytes"] == sum(parts.values())
    for key in ("arch", "shape", "mesh", "kind", "params", "active_params",
                "chips", "status", "memory", "cost", "collectives",
                "collective_bytes_per_device"):
        assert key in rec


# ---------------------------------------------------------------------------
# the sweep and the command line
# ---------------------------------------------------------------------------

def test_run_all_resumes(tmp_path, monkeypatch):
    cells = [("qwen3-0.6b", "long_500k", "pod"),
             ("mamba2-130m", "long_500k", "pod"),
             ("mamba2-130m", "long_500k", "multipod")]
    monkeypatch.setattr(dryrun, "all_cells", lambda: iter(cells))
    assert dryrun.run_all(results_dir=str(tmp_path)) == []
    recs = {p.name: json.loads(p.read_text()) for p in tmp_path.iterdir()}
    assert len(recs) == 3
    skip = recs["qwen3-0.6b__long_500k__pod.json"]
    assert skip["status"] == "skip" and "quadratic" in skip["reason"]
    ok = recs["mamba2-130m__long_500k__multipod.json"]
    assert ok["status"] == "ok" and ok["chips"] == 512
    pod = recs["mamba2-130m__long_500k__pod.json"]
    assert pod["cost"]["families"] == ok["cost"]["families"]
    assert ok["cost"]["flops_per_device"] * 2 == \
        pod["cost"]["flops_per_device"]
    # Resume: a kept record is not traced again.
    monkeypatch.setattr(dryrun, "run_cell", None)
    assert dryrun.run_all(results_dir=str(tmp_path)) == []


def test_run_all_records_errors(tmp_path, monkeypatch):
    monkeypatch.setattr(dryrun, "all_cells",
                        lambda: iter([("qwen3-0.6b", "decode_32k", "pod")]))

    def broken(*a, **kw):
        raise RuntimeError("boom")

    monkeypatch.setattr(dryrun, "run_cell", broken)
    assert dryrun.run_all(results_dir=str(tmp_path)) == \
        [("qwen3-0.6b", "decode_32k", "pod")]
    rec = json.loads((tmp_path / "qwen3-0.6b__decode_32k__pod.json")
                     .read_text())
    assert rec["status"] == "error" and "boom" in rec["error"]


def test_main_writes_a_record(tmp_path):
    with pytest.raises(SystemExit) as e:
        dryrun.main(["--arch", "internvl2-1b", "--shape", "long_500k",
                     "--mesh", "multipod", "--results-dir", str(tmp_path)])
    assert e.value.code == 0
    rec = json.loads((tmp_path / "internvl2-1b__long_500k__multipod.json")
                     .read_text())
    assert rec["status"] == "skip"


def test_main_needs_a_cell():
    with pytest.raises(SystemExit) as e:
        dryrun.main(["--arch", "qwen3-0.6b"])
    assert e.value.code == 2


# ---------------------------------------------------------------------------
# kernel rows of chip_smoke.py against kernel_roofline
# ---------------------------------------------------------------------------

def _bound(nbytes, ops, peak):
    byte_ms, op_ms = nbytes / 3.35e12 * 1e3, ops / peak * 1e3
    return dict(byte_ms=byte_ms, op_ms=op_ms, bound_ms=max(byte_ms, op_ms),
                bound_by="bytes" if byte_ms >= op_ms else "operations")


def test_roofline_beside_bound():
    m, n, k = 1024, 3072, 1024
    gemm = dict(kernel="gemm_fused", case="prefill_up", main_path=True,
                shape=[0, m, n, k], layout="nn", epilogue=None,
                dtype="bfloat16", accumulate=False,
                **_bound(2 * (m * k + k * n + m * n), 2 * m * n * k, 989e12))
    flash = dict(kernel="flash_fwd_fused", case="c", main_path=True,
                 shape=[64, 256, 256, 128], causal=True, dtype="bfloat16",
                 **_bound(1.0, 1.0, 989e12))
    other = dict(kernel="rglru_scan", case="x", bound_ms=1.0)
    rows = dryrun.roofline_beside_bound([gemm, flash, other], (96, 24))
    assert [r["kernel"] for r in rows] == ["gemm_fused", "flash_fwd_fused"]
    assert rows[0]["agree"] and not rows[1]["agree"]
    assert rows[0]["roofline"]["bytes"] == 2 * (m * k + k * n + m * n)
    assert rows[0]["roofline"]["flops"] == 2 * m * n * k


@pytest.mark.parametrize("row,family", [
    (dict(kernel="gemm_quant", shape=[16, 1024, 512], layout="nn",
          epilogue=None, a_dtype="bfloat16", out_dtype="bfloat16",
          mode="w8a16"), "gemm"),
    (dict(kernel="gemm_quant", shape=[16, 1024, 512], layout="nn",
          epilogue=None, a_dtype="bfloat16", out_dtype="float32",
          mode="int8"), "gemm"),
    (dict(kernel="flash_bwd_fused", shape=[8, 64, 64, 64], causal=False,
          dtype="float32"), "flash_attention_bwd"),
    (dict(kernel="flash_decode_int8", shape=[8, 16, 8, 128, 16],
          dtype="bfloat16"), "flash_decode"),
    (dict(kernel="ssd_chunk_diag", shape=[96, 4, 256, 128, 64],
          dtypes=["bfloat16", "float32", "float32"]), "ssd_chunk"),
    (dict(kernel="ssd_scan_bwd", shape=[2, 3, 16, 8, 12],
          dtypes=["float32"] * 3), "ssd_chunk_bwd"),
    (dict(kernel="grouped_bwd", rows=512, k=64, n=96, group_sizes=[1] * 4,
          epilogue="bias", dtype="bfloat16"), "grouped_gemm_bwd"),
    (dict(kernel="grouped_quant", rows=512, k=64, n=96, group_sizes=[1] * 8,
          epilogue=None, x_dtype="bfloat16", out_dtype="float32",
          mode="int8"), "grouped_gemm"),
    (dict(kernel="transpose", shape=[0, 300, 100], dtype="float32"),
     "transpose"),
])
def test_row_descriptor(row, family):
    desc = dryrun._row_descriptor(row, (96, 24))
    assert desc.family == family
    if row["kernel"] == "ssd_chunk_diag":
        assert desc.groups == 384 and desc.chunks == 0
    if row["kernel"] == "flash_decode_int8":
        assert (desc.pages, desc.max_blocks) == (96, 24)
    if row.get("mode") == "int8":
        assert desc.compute_dtype == "int8"


def test_unknown_row_schema_is_reported():
    rows = dryrun.roofline_beside_bound(
        [dict(kernel="gemm_fused", case="broken", shape=[1, 2])], (1, 1))
    assert rows[0]["agree"] is False and "error" in rows[0]
