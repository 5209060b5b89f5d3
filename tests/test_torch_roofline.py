"""``repro_torch.launch.roofline`` and ``hlo_cost.descriptor_cost`` held to
the reference's ``repro.launch.roofline`` and ``repro.launch.hlo_cost``.

Under ``TPU_V5E`` every function must give the reference's values, key
for key: ``kernel_roofline`` over descriptors of every family and quant
variant (built in both packages from the same fields, as
``tests/test_engine.py`` builds them), ``model_flops`` for every
architecture and kind, ``analyze_record`` and ``render_table`` over
hand-built records in the reference's schema.  The one renamed key is
``fits_16gb``, which the port calls ``fits_hbm`` (it reads the machine's
``hbm_bytes``).  The port's own records carry no collective or peak
memory: those terms stay ``None``.
"""
import json

import pytest

from repro.configs import get_config as j_get_config
from repro.configs import list_configs
from repro.configs.shapes import SHAPES as J_SHAPES
from repro.core import descriptor as jd
from repro.core.machine import TPU_V5E as J_TPU
from repro.launch import hlo_cost as jhlo
from repro.launch import roofline as jroof

from repro_torch.configs import SHAPES, get_config
from repro_torch.core import descriptor as td
from repro_torch.core.machine import H100_SXM, TPU_V5E
from repro_torch.launch import hlo_cost as thlo
from repro_torch.launch import roofline as troof

ARCHS = list_configs()

# (class name, fields): one descriptor of every family and quant variant.
QUANTS = (None, "int8", "w8a16", "fp8")
SPECS = [
    ("GemmDescriptor", dict(m=64, n=96, k=32, layout="nt", epilogue="gelu")),
    ("GemmDescriptor", dict(m=4096, n=3072, k=1024, in_dtype="bfloat16",
                            out_dtype="bfloat16", epilogue="silu")),
    ("GemmDescriptor", dict(m=128, n=256, k=64, batch=8, accumulate=True,
                            in_dtype="bfloat16", out_dtype="float32")),
    ("FlashDescriptor", dict(batch_heads=8, sq=256, sk=256, d=64)),
    ("FlashDescriptor", dict(batch_heads=32, sq=1, sk=4000, d=64,
                             causal=False, dtype="bfloat16")),
    ("FlashBwdDescriptor", dict(batch_heads=64, sq=128, sk=128, d=128,
                                dtype="bfloat16")),
    ("FlashDecodeDescriptor", dict(num_seqs=8, pages=96, page_size=16,
                                   max_blocks=24, num_heads=16,
                                   num_kv_heads=8, head_dim=128,
                                   dtype="bfloat16")),
    ("GroupedGemmDescriptor", dict(t=300, k=96, n=160, num_experts=4)),
    ("GroupedGemmDescriptor", dict(t=4096, k=4096, n=6400, num_experts=16,
                                   dtype="bfloat16", epilogue="bias_silu")),
    ("GroupedGemmBwdDescriptor", dict(t=1024, k=512, n=768, num_experts=8,
                                      dtype="bfloat16", epilogue="bias")),
    ("SsdChunkDescriptor", dict(groups=12, q=64, n=32, p=64)),
    ("SsdChunkDescriptor", dict(groups=96, q=256, n=128, p=64, chunks=4,
                                dtype="bfloat16")),
    ("SsdChunkBwdDescriptor", dict(groups=192, q=256, n=128, p=64,
                                   chunks=4)),
    ("TransposeDescriptor", dict(rows=100, cols=300)),
    ("TransposeDescriptor", dict(rows=1024, cols=151936, batch=2,
                                 dtype="bfloat16")),
]
for _q in QUANTS[1:]:
    SPECS += [("GemmDescriptor", dict(m=512, n=1024, k=2048,
                                      in_dtype="bfloat16",
                                      out_dtype="bfloat16", quant=_q)),
              ("GroupedGemmDescriptor", dict(t=2048, k=1024, n=512,
                                             num_experts=8, dtype="bfloat16",
                                             quant=_q))]


def _pair(cls_name, fields):
    jf, tf = dict(fields), dict(fields)
    if fields.get("quant"):
        jf["quant"] = jd.resolve_quant(fields["quant"])
        tf["quant"] = td.resolve_quant(fields["quant"])
    return getattr(jd, cls_name)(**jf), getattr(td, cls_name)(**tf)


def _id(spec):
    cls, f = spec
    return f"{cls}-" + "-".join(f"{k}{v}" for k, v in f.items())


@pytest.mark.parametrize("spec", SPECS, ids=[_id(s) for s in SPECS])
@pytest.mark.parametrize("chips", [1, 256])
def test_kernel_roofline_matches_reference(spec, chips):
    jdesc, tdesc = _pair(*spec)
    assert tdesc.cache_key() == jdesc.cache_key()
    want = jroof.kernel_roofline(jdesc, J_TPU, chips)
    got = troof.kernel_roofline(tdesc, TPU_V5E, chips)
    assert got == want


@pytest.mark.parametrize("spec", SPECS, ids=[_id(s) for s in SPECS])
def test_descriptor_cost_matches_reference(spec):
    jdesc, tdesc = _pair(*spec)
    assert thlo.descriptor_cost(tdesc) == jhlo.descriptor_cost(jdesc)


def test_collective_ops_match_reference():
    assert thlo.COLLECTIVE_OPS == jhlo.COLLECTIVE_OPS


@pytest.mark.parametrize("spec", SPECS[:6], ids=[_id(s) for s in SPECS[:6]])
def test_kernel_roofline_h100(spec):
    """The port's own machine: the descriptor's dtype peak and the HBM3
    rate; the dominant term is the larger."""
    _, tdesc = _pair(*spec)
    r = troof.kernel_roofline(tdesc)
    dtype = getattr(tdesc, "dtype", None) or tdesc.in_dtype
    assert r["compute_s"] == tdesc.flops / H100_SXM.peak(dtype)
    assert r["memory_s"] == (tdesc.in_bytes + tdesc.out_bytes) / 3.35e12
    assert r["dominant"] == ("compute" if r["compute_s"] >= r["memory_s"]
                             else "memory")
    assert r["arithmetic_intensity"] == tdesc.arithmetic_intensity


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k"])
def test_model_flops_matches_reference(arch, shape):
    want = jroof.model_flops({}, j_get_config(arch), J_SHAPES[shape])
    assert troof.model_flops({}, get_config(arch), SHAPES[shape]) == want


def _record(arch="qwen3-0.6b", shape="train_4k", mesh="pod", chips=256,
            flops=3.1e13, nbytes=2.2e10, coll=4.4e9, peak=9.5e9):
    return {"arch": arch, "shape": shape, "mesh": mesh, "chips": chips,
            "status": "ok",
            "cost": {"flops_per_device": flops, "bytes_per_device": nbytes},
            "collective_bytes_per_device": coll,
            "memory": {"peak_per_device": peak}}


# Records in the reference's schema: each term dominant once, a cell that
# does not fit, and a decode cell.
RECORDS = [
    _record(),
    _record(flops=1e9, nbytes=8e11),
    _record(coll=9e12, peak=2e10),
    _record("grok-1-314b", "decode_32k", "multipod", 512, 2e11, 3e9, 1e8,
            1.7e10),
    _record("mamba2-130m", "prefill_32k", "pod", 256, 0.0, 1.0, 0.0, 1.0),
]


def _port_row(row):
    """A port row in the reference's key names."""
    row = dict(row)
    row["fits_16gb"] = row.pop("fits_hbm")
    return row


@pytest.mark.parametrize("rec", RECORDS)
def test_analyze_record_matches_reference(rec):
    want = jroof.analyze_record(json.loads(json.dumps(rec)))
    got = troof.analyze_record(json.loads(json.dumps(rec)), machine=TPU_V5E)
    assert _port_row(got) == want


def test_analyze_record_skip_and_error_are_none():
    for status in ("skip", "error"):
        rec = {"arch": "qwen3-0.6b", "shape": "long_500k", "status": status}
        assert troof.analyze_record(rec) is None
        assert jroof.analyze_record(rec) is None


def test_render_table_matches_reference():
    rows = [jroof.analyze_record(r) for r in RECORDS]
    skips = [{"arch": "qwen3-0.6b", "shape": "long_500k", "status": "skip"}]
    port_rows = [troof.analyze_record(r, machine=TPU_V5E) for r in RECORDS]
    assert troof.render_table(port_rows, skips) == \
        jroof.render_table(rows, skips)


def test_port_record_null_terms():
    """No collective and no peak: those stay None, the dominant term is
    the larger of the two computed, and the table shows a dash."""
    rec = _record(coll=None, peak=None)
    row = troof.analyze_record(rec)
    assert row["collective_s"] is None and row["peak_mem_gb"] is None
    assert row["fits_hbm"] is None
    assert row["dominant"] == ("compute" if row["compute_s"] >= row["memory_s"]
                               else "memory")
    assert row["compute_s"] == rec["cost"]["flops_per_device"] / 989e12
    table = troof.render_table([row], [])
    assert table.splitlines()[-1].endswith("| — | — |")
    assert "| — | **" in table


def test_fits_reads_the_machines_memory():
    rec = _record(peak=50 * 2**30)
    assert troof.analyze_record(rec, machine=H100_SXM)["fits_hbm"] is True
    assert troof.analyze_record(rec, machine=TPU_V5E)["fits_hbm"] is False


def test_load_records_and_main(tmp_path, capsys):
    recs = [_record(coll=None, peak=None),
            _record(shape="prefill_32k", coll=None, peak=None),
            _record(mesh="multipod", chips=512, coll=None, peak=None),
            {"arch": "qwen3-0.6b", "shape": "long_500k", "mesh": "pod",
             "status": "skip", "reason": "x"}]
    for i, r in enumerate(recs):
        (tmp_path / f"r{i}.json").write_text(json.dumps(r))
    pods = troof.load_records("pod", str(tmp_path))
    assert len(pods) == 3 and all(r["mesh"] == "pod" for r in pods)
    assert len(troof.load_records("multipod", str(tmp_path))) == 1
    out = tmp_path / "table.md"
    troof.main(["--results-dir", str(tmp_path), "--write", str(out),
                "--json", str(tmp_path / "rows.json.out")])
    printed = capsys.readouterr().out
    assert "| qwen3-0.6b | long_500k | — | — | — | skip |" in printed
    assert printed.count("| qwen3-0.6b |") == 3
    assert out.read_text().count("\n| qwen3-0.6b |") == 3
    rows = json.loads((tmp_path / "rows.json.out").read_text())
    assert [r["shape"] for r in rows] == ["prefill_32k", "train_4k"]


def test_render_grid():
    rows = [troof.analyze_record(_record(shape=s, coll=None, peak=None))
            for s in ("decode_32k", "train_4k")]
    skips = [{"arch": "qwen3-0.6b", "shape": "long_500k", "status": "skip"}]
    grid = troof.render_grid(rows, skips).splitlines()
    assert grid[0] == "| arch | train_4k | decode_32k | long_500k |"
    assert len(grid) == 3 and grid[2].startswith("| qwen3-0.6b | ")
    cells = grid[2].split(" | ")
    assert cells[-1] == "skip |"
    r = rows[1]
    assert cells[1] == (f"{r['compute_s']:.3g} / {r['memory_s']:.3g} "
                        f"{r['dominant'][0].upper()}, {r['useful_ratio']:.2f}")
