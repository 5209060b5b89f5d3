"""The port's tile tables equal the reference's, and both validators pass.

Shapes: the GEMM cases of tests/test_schedule.py and the flash cases of
tests/test_schedule.py and tests/test_kernels_other.py (flash parity).
"""
import numpy as np
import pytest

import jax  # noqa: F401  (JAX stays on the CPU: tests/conftest.py)
import torch  # noqa: F401

from repro.core import GemmDescriptor as JGemmDescriptor
from repro.core import plan_gemm as j_plan_gemm
from repro.core.schedule import flash_tile_schedule as j_flash_tile_schedule
from repro.core.schedule import flatten_regions as j_flatten_regions
from repro.core.schedule import pack_table as j_pack_table

from repro_torch.core import TPU_V5E, GemmDescriptor, plan_gemm
from repro_torch.core.blocking import Region
from repro_torch.core.schedule import (flash_tile_schedule, flatten_regions,
                                       pack_table, plan_launches)

GEMM_CASES = [(1, 1, 1), (7, 33, 100), (128, 128, 128), (300, 500, 128),
              (513, 129, 257), (80, 80, 512), (1, 2048, 64), (640, 640, 512)]

# (sq, sk, bq, bk, causal)
FLASH_CASES = [
    (256, 256, 128, 128, True), (96, 96, 64, 64, True),
    (100, 100, 64, 32, True), (130, 70, 64, 32, False),
    (1, 1, 64, 64, True), (7, 300, 8, 128, True), (512, 512, 128, 64, False),
    (256, 256, 128, 128, False), (100, 100, 64, 32, False),
    (130, 70, 64, 32, True), (33, 257, 32, 128, True), (33, 257, 32, 128, False),
    (2048, 2048, 128, 128, True), (256, 256, 64, 64, True),
]


@pytest.mark.parametrize("m,n,k", GEMM_CASES)
def test_gemm_tables_equal_reference(m, n, k):
    jplan = j_plan_gemm(JGemmDescriptor(m=m, n=n, k=k))
    jsched = jplan.tile_schedule()
    regions = [Region(r.row0, r.col0, r.rows, r.cols, r.bm, r.bn)
               for r in jplan.regions]
    sched = flatten_regions(m, n, k, jplan.bk, regions)
    assert sched.validate() and jsched.validate()
    np.testing.assert_array_equal(pack_table(sched.tiles),
                                  j_pack_table(jsched.tiles))
    assert sched.blocks == jsched.blocks
    assert (sched.bk, sched.k_steps) == (jsched.bk, jsched.k_steps)
    # the port's own TPU_V5E plan flattens to the same table
    own = plan_gemm(GemmDescriptor(m=m, n=n, k=k), TPU_V5E).tile_schedule()
    np.testing.assert_array_equal(pack_table(own.tiles),
                                  j_pack_table(jsched.tiles))


@pytest.mark.parametrize("m,n,k", GEMM_CASES)
def test_gemm_tables_on_h100_plans_validate(m, n, k):
    """Plans for the card cover C exactly once too."""
    plan = plan_gemm(GemmDescriptor(m=m, n=n, k=k))
    sched = plan.tile_schedule()
    assert sched.validate()
    owned = np.zeros((m, n), np.int64)
    for row0, col0, row_end, col_end, *_ in sched.tiles:
        owned[row0:row_end, col0:col_end] += 1
    assert (owned == 1).all()
    j = j_flatten_regions(m, n, k, plan.bk, plan.regions)
    np.testing.assert_array_equal(pack_table(sched.tiles),
                                  j_pack_table(j.tiles))


@pytest.mark.parametrize("sq,sk,bq,bk,causal", FLASH_CASES)
def test_flash_tables_equal_reference(sq, sk, bq, bk, causal):
    sched = flash_tile_schedule(sq, sk, bq, bk, causal)
    jsched = j_flash_tile_schedule(sq, sk, bq, bk, causal)
    assert sched.validate() and jsched.validate()
    np.testing.assert_array_equal(pack_table(sched.tiles),
                                  j_pack_table(jsched.tiles))
    assert (sched.num_tiles, sched.dense_tiles) == \
        (jsched.num_tiles, jsched.dense_tiles)


@pytest.mark.parametrize("sq,sk,bq,bk,causal", FLASH_CASES)
def test_flash_q_block_index_brackets_each_run(sq, sk, bq, bk, causal):
    """The per-q-block (row_start, row_count) index the CUDA kernel walks:
    each run opens with `first`, closes with `last`, and the runs tile the
    table in order."""
    sched = flash_tile_schedule(sq, sk, bq, bk, causal)
    index = sched.q_block_index()
    assert index.dtype == np.int32 and index.shape == (sched.num_q_blocks, 2)
    table = pack_table(sched.tiles)
    pos = 0
    for start, count in index:
        assert start == pos and count >= 1
        run = table[start:start + count]
        assert run[0, 6] == 1 and run[-1, 7] == 1
        assert (run[:, 0] == run[0, 0]).all()
        pos += count
    assert pos == sched.num_tiles


def test_plan_launches():
    plan = plan_gemm(GemmDescriptor(m=640, n=640, k=512), TPU_V5E,
                     force_block=(256, 256))
    assert plan_launches(plan, fused=True) == 1
    assert plan_launches(plan, fused=False) == len(plan.regions) > 1
