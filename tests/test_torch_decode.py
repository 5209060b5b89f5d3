"""Paged decode against the reference: the runtime decode tables, the
descriptor, the plan, and ``paged_decode_attention`` through its plain
version on the CPU.

  * ``DecodeTileSchedule.tables`` (torch ops) equal JAX's int32 tables bit
    for bit across the decode cases of tests/test_schedule.py, and the
    ported ``validate_tables`` passes; the per-slot row offsets bracket
    each slot's rows;
  * ``FlashDecodeDescriptor.cache_key()``, flops and bytes equal JAX's, and
    under ``TPU_V5E`` the plan predicts the reference's time;
  * ``paged_decode_attention`` (engine dispatch -> ``flash_decode`` ->
    its plain version on CPU tensors) against JAX's under
    ``use(backend="pallas")`` (interpret mode) and against
    ``ref_paged_decode_attention`` (both packages' oracles), with GQA
    groups of 1 and 2, lengths 0, 1, P - 1, P and several pages, shuffled
    page ids, and NaN in every dead page slot (the oracles gather whole
    pages, so they get the pools with NaN replaced by zeros).

Tolerances: float32 1e-5 (the same fp32 math in another summation
order); bfloat16 one bf16 ulp of the output's largest entry (scores, P
and the accumulator are fp32 on both sides and P is rounded to bf16 at
the same place, so the outputs differ only where the final rounding to
bf16 falls on the other side of a tie), and at most 2% of the bf16
elements may differ from the JAX kernel's at all (leaving out P's
rounding changes 8-29% of them on these cases, inside the ulp bound).
An empty slot's row is exactly 0.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jcore
from repro.core.blocking import plan_flash_decode as j_plan_flash_decode
from repro.core.descriptor import FlashDecodeDescriptor as JDescriptor
from repro.core.machine import TPU_V5E as J_TPU_V5E
from repro.core.schedule import DecodeTileSchedule as JDecodeTileSchedule
from repro.kernels.flash_attention.ops import (
    paged_decode_attention as j_paged_decode_attention)
from repro.kernels.flash_attention.ref import (
    ref_paged_decode_attention as j_ref_paged_decode_attention)
from repro.models.attention import PageSpec as JPageSpec
from repro.runtime.pages import PagePool as JPagePool
from repro.runtime.pages import pages_for as j_pages_for

from repro_torch.core import (H100_SXM, TPU_V5E, DecodeTileSchedule,
                              FlashDecodeDescriptor, engine,
                              flash_decode_legal, plan_flash_decode, use)
from repro_torch.kernels.flash_attention import (paged_decode_attention,
                                                 ref_paged_decode_attention)
from repro_torch.kernels.flash_attention.kernel import (LAUNCHES, FlashDecode,
                                                        flash_decode,
                                                        flash_decode_plain)

# tests/test_schedule.py's decode cases: (lengths, page_size, extra_pages)
DECODE_CASES = [
    ([0, 0, 0], 4, 2),
    ([5], 4, 0),
    ([16, 16], 16, 0),
    ([1, 33, 0, 7], 8, 3),
    ([9, 9, 9, 9, 9], 3, 0),
    ([100], 8, 5),
]


def _pool_tables(lengths, page_size, extra_pages):
    """The reference allocator's block tables with every slot grown to its
    length (as tests/test_schedule.py builds them)."""
    need = [j_pages_for(L, page_size) for L in lengths]
    spec = JPageSpec(num_pages=max(1, sum(need) + extra_pages),
                     page_size=page_size,
                     max_blocks=max(1, max(need, default=1)))
    pool = JPagePool(spec, len(lengths))
    for i, L in enumerate(lengths):
        pool.grow(i, L)
    return spec, pool.tables


@pytest.mark.parametrize("lengths,page_size,extra_pages", DECODE_CASES)
def test_decode_tables_equal_reference(lengths, page_size, extra_pages):
    spec, bt = _pool_tables(lengths, page_size, extra_pages)
    kw = dict(num_seqs=len(lengths), pages=spec.num_pages,
              page_size=page_size, max_blocks=spec.max_blocks)
    jsched, sched = JDecodeTileSchedule(**kw), DecodeTileSchedule(**kw)
    assert sched.max_tiles == jsched.max_tiles
    assert sched.max_len == jsched.max_len
    want = np.asarray(jsched.tables(jnp.asarray(bt),
                                    jnp.asarray(lengths, jnp.int32)))
    table, bstart = sched.tables_and_offsets(
        torch.from_numpy(bt), torch.tensor(lengths, dtype=torch.int32))
    assert table.dtype == torch.int32 and bstart.dtype == torch.int32
    np.testing.assert_array_equal(table.numpy(), want)
    assert sched.validate_tables(table.numpy(), bt, np.asarray(lengths))
    # bstart brackets each slot's rows: first at its start, last at its end
    b = bstart.numpy()
    assert b[0] == 0 and b[-1] == sum(max(-(-L // page_size), 1)
                                      for L in lengths)
    for s in range(len(lengths)):
        rows = want[b[s]:b[s + 1]]
        assert (rows[:, 0] == s).all() and rows[0, 3] == 1 \
            and rows[-1, 4] == 1


def test_decode_schedule_static_bounds():
    sched = DecodeTileSchedule(num_seqs=3, pages=5, page_size=4,
                               max_blocks=4)
    assert sched.max_tiles == 5 + 3 and sched.max_len == 16
    bt = np.asarray([[0, 1, 0, 0], [2, 3, 4, 0], [0, 0, 0, 0]], np.int32)
    lengths = np.asarray([8, 12, 0], np.int32)
    table = sched.tables(torch.from_numpy(bt), torch.from_numpy(lengths))
    want = JDecodeTileSchedule(num_seqs=3, pages=5, page_size=4,
                               max_blocks=4).tables(jnp.asarray(bt),
                                                    jnp.asarray(lengths))
    np.testing.assert_array_equal(table.numpy(), np.asarray(want))
    assert sched.validate_tables(table.numpy(), bt, lengths)


DESCS = [dict(num_seqs=8, pages=96, page_size=16, max_blocks=24,
              num_heads=16, num_kv_heads=8, head_dim=128, dtype="bfloat16"),
         dict(num_seqs=3, pages=24, page_size=8, max_blocks=6, num_heads=4,
              num_kv_heads=2, head_dim=16, dtype="float32")]


@pytest.mark.parametrize("kw", DESCS)
def test_decode_descriptor_and_plan_match_reference(kw):
    desc, jdesc = FlashDecodeDescriptor(**kw), JDescriptor(**kw)
    assert desc.cache_key() == jdesc.cache_key()
    assert (desc.flops, desc.in_bytes, desc.out_bytes) == \
        (jdesc.flops, jdesc.in_bytes, jdesc.out_bytes)
    plan, jplan = plan_flash_decode(desc, TPU_V5E), \
        j_plan_flash_decode(jdesc, J_TPU_V5E)
    assert plan.fused and jplan.fused
    assert plan.tile_schedule().max_tiles == jplan.tile_schedule().max_tiles
    assert plan.predicted_seconds(TPU_V5E) == pytest.approx(
        jplan.predicted_seconds(J_TPU_V5E), rel=1e-12)
    assert plan_flash_decode(desc, H100_SXM).predicted_seconds(H100_SXM) > 0


def test_decode_plan_rejects_what_the_kernel_does_not_take():
    big = FlashDecodeDescriptor(num_seqs=2, pages=8, page_size=128,
                                max_blocks=4, num_heads=4, num_kv_heads=4,
                                head_dim=64)
    assert not flash_decode_legal(big, H100_SXM)
    assert flash_decode_legal(big, TPU_V5E)
    with pytest.raises(NotImplementedError, match="page size"):
        plan_flash_decode(big, H100_SXM)


# (S, pages, P, max_blocks, h, hkv, hd, lengths)
ATTN_CASES = [
    (4, 16, 8, 4, 2, 2, 16, [0, 1, 7, 8]),
    (5, 24, 8, 4, 4, 2, 16, [32, 17, 0, 9, 1]),
    (3, 12, 16, 4, 4, 2, 32, [15, 16, 40]),
]


def _attn_inputs(case, seed):
    S, pages, P, B, h, hkv, hd, lengths = case
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((S, h, hd)).astype(np.float32)
    k = rng.standard_normal((pages, P, hkv, hd)).astype(np.float32)
    v = rng.standard_normal((pages, P, hkv, hd)).astype(np.float32)
    bt = rng.permutation(pages)[:S * B].reshape(S, B).astype(np.int32)
    # Every dead page slot holds NaN: past each slot's length in its own
    # pages, and all of every page no slot has live.
    live = np.zeros((pages, P), bool)
    for s, L in enumerate(lengths):
        for pos in range(L):
            live[bt[s, pos // P], pos % P] = True
    k[~live], v[~live] = np.nan, np.nan
    return q, k, v, bt, np.asarray(lengths, np.int32)


def _bf16_ulp(x: np.ndarray) -> float:
    top = float(np.abs(x).max())
    return 2.0 ** (np.floor(np.log2(top)) - 7) if top > 0 else 0.0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ATTN_CASES)
def test_paged_decode_matches_reference(case, dtype):
    q, k, v, bt, lengths = _attn_inputs(case, seed=len(case[-1]))
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    tq, tk, tv = (torch.from_numpy(x).to(tdt) for x in (q, k, v))
    with use(device="cpu"):
        engine.reset_stats(entries=False)
        before = dict(LAUNCHES)
        got = paged_decode_attention(tq, tk, tv, torch.from_numpy(bt),
                                     torch.from_numpy(lengths))
        assert engine.stats()["flash_decode"]["launches"] == 1
        assert LAUNCHES == before  # CPU tensors: the plain version, no kernel
    assert got.dtype == tdt and got.shape == q.shape
    assert torch.isfinite(got.float()).all()
    for s, L in enumerate(lengths):
        if L == 0:
            assert torch.equal(got[s], torch.zeros_like(got[s]))
    jq, jk, jv = (jnp.asarray(x, jdt) for x in (q, k, v))
    with jcore.use(backend="pallas"):
        want = j_paged_decode_attention(jq, jk, jv, jnp.asarray(bt),
                                        jnp.asarray(lengths))
    want = np.asarray(want.astype(jnp.float32))
    # The oracles gather whole pages: scrub the NaNs they would multiply.
    kz, vz = np.nan_to_num(k, nan=0.0), np.nan_to_num(v, nan=0.0)
    ref = ref_paged_decode_attention(
        tq, torch.from_numpy(kz).to(tdt), torch.from_numpy(vz).to(tdt),
        torch.from_numpy(bt), torch.from_numpy(lengths)).float().numpy()
    j_ref = np.asarray(j_ref_paged_decode_attention(
        jq, jnp.asarray(kz, jdt), jnp.asarray(vz, jdt), jnp.asarray(bt),
        jnp.asarray(lengths)).astype(jnp.float32))
    tol = 1e-5 if dtype == "float32" else _bf16_ulp(want)
    g = got.float().numpy()
    np.testing.assert_allclose(g, want, atol=tol, rtol=0,
                               err_msg="vs JAX pallas (interpret)")
    if dtype == "bfloat16":
        assert (g != want).mean() <= 0.02, (g != want).mean()
    np.testing.assert_allclose(ref, j_ref, atol=tol, rtol=0,
                               err_msg="port oracle vs JAX oracle")
    if dtype == "float32":
        np.testing.assert_allclose(g, ref, atol=tol, rtol=0,
                                   err_msg="vs ref_paged_decode_attention")


def test_decode_state_is_rewritten_in_place():
    """One cached state serves every batch composition: the table and the
    offsets keep their storage across updates."""
    sched = DecodeTileSchedule(num_seqs=2, pages=6, page_size=4,
                               max_blocks=3)
    exe = FlashDecode(sched, "cpu")
    ptrs = (exe.table.data_ptr(), exe.bstart.data_ptr())
    bt = torch.tensor([[0, 1, 2], [3, 4, 5]], dtype=torch.int32)
    for lengths in ([5, 0], [12, 9], [0, 0]):
        exe.update(bt, torch.tensor(lengths, dtype=torch.int32))
        assert (exe.table.data_ptr(), exe.bstart.data_ptr()) == ptrs
        assert int(exe.bstart[-1]) == sum(max(-(-L // 4), 1)
                                          for L in lengths)


def test_decode_state_rebuilds_only_on_changed_inputs(monkeypatch):
    """The same block tables and lengths, unchanged, keep the table; an
    in-place rewrite of the block tables (refresh_tables) rebuilds it."""
    sched = DecodeTileSchedule(num_seqs=2, pages=6, page_size=4,
                               max_blocks=3)
    builds = []
    real = DecodeTileSchedule.tables_and_offsets
    monkeypatch.setattr(DecodeTileSchedule, "tables_and_offsets",
                        lambda self, *a: builds.append(1) or real(self, *a))
    exe = FlashDecode(sched, "cpu")
    bt = torch.tensor([[0, 1, 2], [3, 4, 5]], dtype=torch.int32)
    lengths = torch.tensor([5, 2], dtype=torch.int32)
    exe.update(bt, lengths)
    exe.update(bt, lengths)
    assert len(builds) == 1
    bt.copy_(torch.tensor([[5, 4, 3], [2, 1, 0]], dtype=torch.int32))
    exe.update(bt, lengths)
    assert len(builds) == 2
    np.testing.assert_array_equal(
        exe.table.numpy(), real(sched, bt, lengths)[0].numpy())
    exe.update(bt, lengths.clone())
    assert len(builds) == 3


def test_decode_wrapper_checks_shapes():
    sched = DecodeTileSchedule(num_seqs=2, pages=6, page_size=4,
                               max_blocks=3)
    exe = FlashDecode(sched, "cpu")
    q = torch.zeros(2, 4, 8)
    pool = torch.zeros(6, 4, 2, 8)
    with pytest.raises(ValueError):
        flash_decode(exe, q, pool, torch.zeros(6, 4, 2, 4))
    with pytest.raises(ValueError):
        flash_decode(exe, torch.zeros(3, 4, 8), pool, pool)
    # KV-int8 pools are ported: scales come in pairs, with int8 pools
    tables = torch.zeros(2, 3, dtype=torch.int32)
    lengths = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="together"):
        paged_decode_attention(q, pool, pool, tables, lengths,
                               k_scale=torch.ones(6, 4))
    with pytest.raises(ValueError, match="int8"):
        paged_decode_attention(q, pool, pool, tables, lengths,
                               k_scale=torch.ones(6, 4),
                               v_scale=torch.ones(6, 4))


@pytest.mark.gpu
def test_decode_kernel_on_card(cuda_device):
    """On the card the wrapper launches flash_decode.cu (no plain path)."""
    q, k, v, bt, lengths = _attn_inputs(ATTN_CASES[1], seed=0)
    tq, tk, tv = (torch.from_numpy(x).to(cuda_device).bfloat16()
                  for x in (q, k, v))
    S, pages, P, B = ATTN_CASES[1][:4]
    exe = FlashDecode(DecodeTileSchedule(num_seqs=S, pages=pages,
                                         page_size=P, max_blocks=B),
                      cuda_device)
    exe.update(torch.from_numpy(bt).to(cuda_device),
               torch.from_numpy(lengths).to(cuda_device))
    n0 = LAUNCHES["flash_decode"]
    got = flash_decode(exe, tq, tk, tv)
    torch.cuda.synchronize()
    assert LAUNCHES["flash_decode"] == n0 + 1
    want = flash_decode_plain(exe, tq, tk, tv)
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2,
                               rtol=2e-2)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    return torch.device("cuda")
