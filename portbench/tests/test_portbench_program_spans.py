"""The readers of the program's own spans, on a synthetic slice.

The slice is three ``step`` spans of a served run: a decode step, a step
that admits one prompt, and another decode step, each with the program's
``moe``, ``cast`` and scheduler spans and the kernels launched inside
them.  The program's spans are function-scope events (``cat`` "cpu_op"),
as ``repro_torch/core/trace.py`` records them.  The same slice without
them gives every existing key and reader the same value."""
import pytest

from harness import files, program_spans, readers
from harness.trace import breakdown, parse

CFG = files.load_data("configs", "phi3.5-moe-42b.pp4")["model"]
MOE = "repro_torch.moe|tokens=64,groups=32,capacity_rows=4096,routed_rows=128"


def x(cat, name, ts, dur, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "args": args}


def kernel(name, launch, start, dur, corr):
    return [x("cuda_runtime", "cudaLaunchKernel", launch, 2,
              correlation=corr),
            x("kernel", name, start, dur, correlation=corr)]


def served(program=True):
    """Chrome events in microseconds: the slice [0, 1000), steps [0, 300),
    [300, 700) (admits a prompt of 97) and [700, 1000)."""
    ev = [x("user_annotation", "portbench.slice", 0, 1000)]
    ev += [x("user_annotation", "portbench.step", a, b - a)
           for a, b in ((0, 300), (300, 700), (700, 1000))]
    ev += [x("cpu_op", "aten::cumsum", 70, 10),
           x("cpu_op", "aten::copy_", 335, 4)]
    ev += kernel("vectorized_elementwise_kernel<8>", 35, 40, 35, 1)
    ev += kernel("vectorized_elementwise_kernel<8>", 335, 400, 100, 2)
    ev += kernel("vectorized_elementwise_kernel<8>", 740, 745, 20, 3)
    ev += kernel("grouped_wgmma_kernel", 780, 790, 50, 4)
    if program:
        ev += [x("cpu_op", "repro_torch.sched.decode|active=64", 10, 280),
               x("cpu_op", MOE, 20, 100),
               x("cpu_op", "repro_torch.cast|bytes=6", 30, 20),
               x("cpu_op", "repro_torch.moe.route", 60, 40),
               x("cpu_op", "repro_torch.sched.admit", 305, 390),
               x("cpu_op", "repro_torch.sched.prefill|rid=3,len=97", 310, 290),
               x("cpu_op", "repro_torch.moe|tokens=97,groups=97,"
                 "capacity_rows=12416,routed_rows=194", 320, 100),
               x("cpu_op", "repro_torch.cast|bytes=6", 330, 10),
               x("cpu_op", MOE, 720, 80),
               x("cpu_op", "repro_torch.cast|bytes=6", 730, 30)]
    return ev


def record(program=True):
    steps = [{"t0": t, "t1": t + 1, "active": 64, "admitted": adm,
              "traced": True} for t, adm in ((0, []), (1, [97]), (2, []))]
    return {"cfg": CFG, "steps": [dict(steps[0], traced=False)] + steps,
            "profile": parse(served(program))}


def read(metric, rec):
    return files.reader(metric)(rec)


def test_program_spans_carry_their_attributes():
    spans = program_spans.program_spans(parse(served()))
    assert [s[0] for s in spans][:4] == ["sched.decode", "moe", "cast",
                                         "moe.route"]
    assert spans[1][1] == {"tokens": 64, "groups": 32,
                           "capacity_rows": 4096, "routed_rows": 128}
    assert spans[5][1] == {"rid": 3, "len": 97}
    assert program_spans.program_spans(parse(served(False))) == []


def test_existing_keys_and_readers_read_the_same():
    with_, without = parse(served()), parse(served(False))
    for key in ("window", "kernels", "other_device", "launches", "spans",
                "busy"):
        assert with_[key] == without[key], key
    ops = [op for op in with_["cpu_ops"]
           if not op[0].startswith("repro_torch.")]
    assert ops == without["cpu_ops"]
    a, b = record(), record(False)
    for reader in (readers.device_idle, readers.host_ms_per_step,
                   readers.expert_roofline):
        assert reader(a) == reader(b)
    assert breakdown(with_)["device_ops"] == breakdown(without)["device_ops"]


def test_gap_names():
    """A gap that opens inside an operator keeps the operator's name; one
    that opens in Python inside a program span takes the innermost span's
    name, attributes and all; the gaps themselves are the same."""
    named = breakdown(parse(served()))["idle_gaps"]
    plain = breakdown(parse(served(False)))["idle_gaps"]
    assert [g[1] for g in named] == [g[1] for g in plain]
    assert sorted(g[0] for g in named) == sorted(
        ["step / python"] * 2 + ["step / aten::cumsum", "step / " + MOE,
                                 "step / repro_torch.sched.prefill|rid=3,"
                                 "len=97"])
    assert sorted(g[0] for g in plain) == sorted(
        ["step / python"] * 4 + ["step / aten::cumsum"])


def test_new_readers():
    rec = record()
    # decode steps' casts: 35 + 20 us of kernels over 2 decode steps
    assert read("cast_ms_per_step.batch", rec) == pytest.approx(0.0275)
    # moe less casts: (100 - 20) + (80 - 30) us over 2 decode steps
    assert read("moe_host_ms.batch", rec) == pytest.approx(0.065)
    assert read("expert_rows_useful.batch", rec) == pytest.approx(3.125)
    assert read("prefill_share.batch", rec) == pytest.approx(29.0)


def test_new_readers_find_nothing_without_program_spans():
    for metric in ("cast_ms_per_step.batch", "moe_host_ms.batch",
                   "expert_rows_useful.batch", "prefill_share.batch",
                   "recompute_ms.train"):
        assert read(metric, record(False)) is None
        assert read(metric, {"profile": None}) is None


def test_recompute_ms_reads_the_backward_spans():
    ev = [x("user_annotation", "portbench.slice", 0, 1000),
          x("user_annotation", "portbench.train_step", 0, 900),
          x("cpu_op", "repro_torch.matmul.recompute", 100, 50),
          x("cpu_op", "repro_torch.matmul.recompute", 500, 50)]
    ev += kernel("sm80_xmma_gemm_f32f32", 110, 120, 300, 1)
    ev += kernel("sm80_xmma_gemm_f32f32", 510, 520, 200, 2)
    ev += kernel("gemm_bf16_kernel", 600, 720, 100, 3)
    rec = {"profile": parse(ev), "profile_steps": 2}
    assert read("recompute_ms.train", rec) == pytest.approx(0.25)


def test_decode_steps_refuse_a_misaligned_slice():
    rec = record()
    rec["steps"] = rec["steps"][:3]
    with pytest.raises(RuntimeError):
        read("moe_host_ms.batch", rec)
