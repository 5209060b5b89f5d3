"""The yardstick's counts against hand computation."""
import pytest

from harness import files, roofline as R
from harness.trace import covered, gaps, union

MOE = files.load_data("configs", "phi3.5-moe-42b.pp4")["model"]
MINI = files.load_data("configs", "phi3-mini-3.8b.pp4")["model"]


def test_one_gemm():
    # 4096 x 3072 x 8192 at bf16: 2*m*k*n FLOPs, each operand once.
    m, k, n = 4096, 3072, 8192
    flops = 2 * m * k * n
    nbytes = 2 * (m * k + k * n + m * n)
    assert R.gemm_bound_s(m, k, n) == pytest.approx(
        max(flops / 989e12, nbytes / 3.35e12))
    assert flops / 989e12 > nbytes / 3.35e12         # compute-bound
    assert R.gemm_bound_s(16, 4096, 6400) == pytest.approx(
        2 * (16 * 4096 + 4096 * 6400 + 16 * 6400) / 3.35e12)


def test_one_causal_flash():
    # b 8, s 4096, 32 heads of 96, one layer: forward 2*b*h*s^2*d FLOPs
    # (half of QK^T and PV), backward 2.5 times that.
    cfg = dict(MINI, num_layers=1)
    fwd = 2 * 8 * 32 * 4096 ** 2 * 96
    assert R.attention_flops_fwd(8, 4096, 32, 96) == fwd
    q = 8 * 4096 * 32 * 96 * 2
    assert R.attention_train_bound_s(cfg, 8, 4096) == pytest.approx(
        max(fwd / 989e12, (4 * q + 8 * 32 * 4096 * 4) / 3.35e12)
        + max(2.5 * fwd / 989e12, (8 * q + 2 * 8 * 32 * 4096 * 4)
              / 3.35e12))


def test_one_grouped_decode_step():
    # 64 tokens, top-2 of 16 experts, d 4096, f 6400, one layer.
    cfg = dict(MOE, num_layers=1)
    hit = 16 * (1 - (14 / 16) ** 64)
    assert hit == pytest.approx(15.997, abs=1e-3)
    rows = 128
    nbytes = 3 * hit * 4096 * 6400 * 2 + rows * 2 * (3 * 4096 + 3 * 6400)
    flops = 6 * rows * 4096 * 6400
    assert R.expert_bound_s(cfg, 64) == pytest.approx(
        max(flops / 989e12, nbytes / 3.35e12))
    assert nbytes / 3.35e12 > flops / 989e12         # bytes-bound
    assert R.expert_bound_s(cfg, 0) == 0.0


def test_linear_train_counts_three_products_a_map():
    cfg = dict(MINI, num_layers=1)
    T = 32768
    want = 0.0
    for k, n, c in [(3072, 3072, 1), (3072, 3072, 2), (3072, 3072, 1),
                    (3072, 8192, 2), (8192, 3072, 1), (3072, 32064, 1)]:
        want += c * (R.gemm_bound_s(T, k, n) + R.gemm_bound_s(T, n, k)
                     + R.gemm_bound_s(k, T, n))
    assert R.linear_train_bound_s(cfg, T) == pytest.approx(want)


def test_train_flops_and_mfu_counts():
    cfg = dict(MINI, num_layers=1)
    per_tok = 4 * 3072 * 3072 + 3 * 3072 * 8192 + 3072 * 32064
    assert R.dense_params_per_token(cfg) == per_tok
    assert R.train_step_flops(cfg, 8, 4096) == pytest.approx(
        3 * (2 * per_tok * 8 * 4096 + 2 * 8 * 32 * 4096 ** 2 * 96))


def test_kernel_families():
    assert R.family("void (anonymous namespace)::grouped_wgmma_kernel<1>") \
        == "grouped"
    assert R.family("flash_fused_wgmma<128>") == "flash"
    assert R.family("flash_bwd_wgmma<128>") == "flash"
    assert R.family("flash_decode_split<2>") == "other"
    assert R.family("gemm_bf16_kernel<0>") == "gemm"
    assert R.family("sm90_xmma_gemm_bf16bf16_bf16f32") == "gemm"
    assert R.family("nvjet_tst_128x256_64x4") == "gemm"
    assert R.family("ampere_sgemm_128x64_nn") == "gemm"
    assert R.family("void at::native::elementwise_kernel<128, 4>") == "other"


def test_interval_union_and_gaps():
    busy = union([(0, 2), (1, 3), (5, 6), (9, 12)], (0.5, 10))
    assert busy == [(0.5, 3), (5, 6), (9, 10)]
    assert gaps(busy, (0.5, 10)) == [(3, 5), (6, 9)]
    assert covered(busy, 2, 5.5) == pytest.approx(1.5)
