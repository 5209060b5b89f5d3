"""The paged decode kernel's routes: which one each call takes, the rules
route A's launch derives (its cluster size and each rank's chunk of a
slot's rows), the premise of its split walk, and each route against its
plain version on the card.

  * ``choose_decode_route``, ``decode_cluster`` and ``decode_chunk`` are
    pure functions, checked here on the CPU, with the serving shape of
    chip_smoke's ``continuous`` phase (8 slots, 16 query / 8 KV heads of
    128, pages of 16, 24 blocks: a cluster of 2 on the card's 132 SMs).
  * The premise (plain torch): route A splits a slot's rows over the
    ranks of a cluster, and the reference rounds P = exp(s - m_t) to q's
    dtype against the running max m_t of the sequential walk.  Starting
    each rank's running max at the lower ranks' maximum keeps every m_t,
    so the split walk with the ranks' sums added (each page scaled by
    exp(m_t - m_T)) stays within one bf16 ulp of the output's largest
    entry of ``flash_decode_plain`` (the sequential walk), with at most
    2% of the bf16 elements differing at all, on tests/test_torch_decode.py's
    cases (NaN in every dead page slot, lengths 0, 1, P - 1, P) and on
    longer slots, for clusters of 1, 2, 3 and 8.  Rounding P against each
    chunk's own max instead moves more of them.
  * The ``gpu`` tests hold route A to the plain version on the card at
    those edges (at head dim 64, route A's smallest, and with GQA groups
    of 1, 2, 3, 4 and 8), at the full serving shape (bf16 and int8 pools)
    and on a slot longer than a block's ring, and route B at fp32 and at
    the CPU cases' head dim 16, with chip_smoke's
    tolerance, atol = rtol = 2e-2 for bf16 and 1e-4 for fp32 (the kernel
    sums in fp32 in another order than the plain walk); an empty slot's
    row is exactly 0.

This file imports no JAX, so ``python -m pytest -m gpu
tests/test_torch_decode_routes.py`` runs on the card's machine.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import H100_SXM, DecodeTileSchedule
from repro_torch.kernels.flash_attention import kernel as fk
from repro_torch.kernels.flash_attention.kernel import (
    NEG_INF, FlashDecode, choose_decode_route, decode_chunk, decode_cluster,
    flash_decode, flash_decode_plain)

BF, F32, I8 = torch.bfloat16, torch.float32, torch.int8
H100_SMS = 132
# chip_smoke's continuous pool: 8 slots, 96 pages of 16, 24 blocks, Qwen3's
# 16 query / 8 KV heads of 128, and its serve_ragged lengths.
SERVE = (8, 96, 16, 24, 16, 8, 128, [0, 1, 16, 17, 300, 255, 100, 33])

# tests/test_torch_decode.py's cases (S, pages, P, max_blocks, h, hkv, hd,
# lengths), then longer slots whose walks a cluster splits several ways.
ATTN_CASES = [
    (4, 16, 8, 4, 2, 2, 16, [0, 1, 7, 8]),
    (5, 24, 8, 4, 4, 2, 16, [32, 17, 0, 9, 1]),
    (3, 12, 16, 4, 4, 2, 32, [15, 16, 40]),
]
LONG_CASES = [
    (3, 48, 4, 16, 4, 2, 16, [63, 0, 37]),
    (2, 48, 8, 24, 8, 2, 32, [191, 100]),
]
# On the card: those cases at head dim 64 (16 and 32 take route B), GQA
# groups of 3 and 8, and internvl2-1b's group of 7 (14 query heads over 2
# KV heads of 64) on its serving pages of 16.
CARD_CASES = [c[:6] + (64,) + c[7:] for c in ATTN_CASES + LONG_CASES] + [
    (3, 24, 8, 8, 24, 8, 64, [0, 33, 64]),
    (2, 16, 16, 8, 16, 2, 128, [100, 17]),
    (4, 40, 16, 10, 14, 2, 64, [0, 1, 100, 160]),
]


def _attn_inputs(case, seed):
    """tests/test_torch_decode.py's inputs: numpy draws from ``seed``,
    shuffled page ids, NaN in every dead page slot."""
    S, pages, P, B, h, hkv, hd, lengths = case
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((S, h, hd)).astype(np.float32)
    k = rng.standard_normal((pages, P, hkv, hd)).astype(np.float32)
    v = rng.standard_normal((pages, P, hkv, hd)).astype(np.float32)
    bt = rng.permutation(pages)[:S * B].reshape(S, B).astype(np.int32)
    live = np.zeros((pages, P), bool)
    for s, L in enumerate(lengths):
        for pos in range(L):
            live[bt[s, pos // P], pos % P] = True
    k[~live], v[~live] = np.nan, np.nan
    return q, k, v, bt, np.asarray(lengths, np.int32)


def _state(case, bt, lengths, device):
    S, pages, P, B = case[:4]
    exe = FlashDecode(DecodeTileSchedule(num_seqs=S, pages=pages,
                                         page_size=P, max_blocks=B), device)
    exe.update(torch.as_tensor(bt).to(device),
               torch.as_tensor(lengths).to(device))
    return exe


def _bf16_ulp(x: torch.Tensor) -> float:
    top = float(x.float().abs().max())
    return 2.0 ** (np.floor(np.log2(top)) - 7) if top > 0 else 0.0


# ---------------------------------------------------------------------------
# The rules (CPU)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seqs,hkv,max_blocks,want", [
    (8, 8, 24, 2),     # the serving shape: 64 pairs, 2 blocks each
    (16, 8, 24, 1),    # 128 pairs: C = 1, one block a pair
    (8, 32, 24, 1),    # more pairs than SMs: still one block
    (1, 8, 24, 8),     # capped at the portable cluster size
    (1, 8, 3, 3),      # capped by max_blocks: a slot walks at most 3 rows
    (1, 1, 1, 1),
    (4, 8, 24, 4),     # 32 pairs, 132 // 32 = 4
    (3, 8, 24, 5),     # 24 pairs, 132 // 24 = 5: not a power of two
])
def test_decode_cluster_rule(seqs, hkv, max_blocks, want):
    got = decode_cluster(seqs, hkv, max_blocks, H100_SMS)
    assert got == want
    assert 1 <= got <= min(fk.DECODE_MAX_CLUSTER, max_blocks)
    assert got == 1 or seqs * hkv * got <= H100_SMS


def test_decode_cluster_serving_shape():
    """chip_smoke's continuous pool splits each (slot, KV head) over a
    cluster of 2: 128 blocks on the card's 132 SMs."""
    S, _, _, B, _, hkv = SERVE[:6]
    assert decode_cluster(S, hkv, B, H100_SMS) == 2
    assert fk.DECODE_MAX_CLUSTER == H100_SXM.gemm_max_cluster == 8


@pytest.mark.parametrize("n", list(range(0, 26)) + [97])
@pytest.mark.parametrize("clusters", [1, 2, 3, 5, 8])
def test_decode_chunks_partition_a_slot(n, clusters):
    """The ranks' chunks tile [start, start + n) in rank order, sizes
    differing by at most one (a rank may get none)."""
    start = 11
    chunks = [decode_chunk(start, start + n, clusters, r)
              for r in range(clusters)]
    assert chunks[0][0] == start and chunks[-1][1] == start + n
    assert all(a[1] == b[0] for a, b in zip(chunks, chunks[1:]))
    sizes = [hi - lo for lo, hi in chunks]
    assert min(sizes) >= 0 and max(sizes) - min(sizes) <= 1


@pytest.mark.parametrize("q_dt,kv_dt,group,page,hd,ptrs,want", [
    (BF, BF, 2, 16, 128, (0, 256, 512), "A"),     # Qwen3 serving
    (BF, BF, 7, 16, 64, (0, 256, 512), "A"),      # internvl2-1b serving
    (BF, I8, 2, 16, 128, (0, 256, 512), "A"),     # its KV-int8 pools
    (BF, BF, 1, 8, 64, (), "A"),
    (BF, BF, 8, 64, 64, (), "A"),                 # route A's limits
    (BF, I8, 4, 4, 64, (), "A"),
    (F32, F32, 2, 16, 128, (), "B"),              # fp32 q
    (F32, I8, 2, 16, 128, (), "B"),
    (BF, BF, 16, 16, 128, (), "B"),               # a group past 8
    (BF, BF, 2, 128, 128, (), "B"),               # a page past 64 rows
    (BF, BF, 2, 6, 128, (), "B"),                 # a page not a multiple of 4
    (BF, BF, 2, 16, 96, (), "B"),                 # head dims off the set
    (BF, BF, 2, 16, 36, (), "B"),
    (BF, BF, 1, 8, 16, (), "B"),                  # the CPU tests' head dims
    (BF, BF, 2, 16, 32, (), "B"),
    (BF, I8, 2, 16, 8, (), "B"),                  # 8-byte int8 rows
    (BF, BF, 2, 16, 128, (0, 8, 512), "B"),       # a base TMA cannot read
])
def test_choose_decode_route_rule(q_dt, kv_dt, group, page, hd, ptrs, want):
    assert choose_decode_route(q_dt, kv_dt, group, page, hd, ptrs) == want


def test_route_a_limits_are_the_machines():
    assert H100_SXM.decode_a_max_group <= H100_SXM.decode_max_group
    assert H100_SXM.decode_a_max_page <= H100_SXM.decode_max_page
    assert max(H100_SXM.decode_a_head_dims) <= H100_SXM.decode_max_head_dim
    # Every route-A head dim gives 16-byte pool rows in both pool types,
    # and rows of at least a group's worth of 8-element lanes.
    assert all(hd % 16 == 0 and hd // 8 >= H100_SXM.decode_a_max_group
               for hd in H100_SXM.decode_a_head_dims)


def test_cpu_tensors_take_the_plain_version_and_count_no_route():
    case = ATTN_CASES[1]
    q, k, v, bt, lengths = _attn_inputs(case, seed=0)
    exe = _state(case, bt, lengths, "cpu")
    tq, tk, tv = (torch.from_numpy(x).to(BF) for x in (q, k, v))
    before = (dict(fk.LAUNCHES), dict(fk.DECODE_ROUTES))
    got = flash_decode(exe, tq, tk, tv)
    assert (dict(fk.LAUNCHES), dict(fk.DECODE_ROUTES)) == before
    assert torch.equal(got, flash_decode_plain(exe, tq, tk, tv))


# ---------------------------------------------------------------------------
# The premise: the split walk with the prefix max (plain torch)
# ---------------------------------------------------------------------------

def _split_walk(exe, q, k_pool, v_pool, clusters, own_max=False,
                k_scale=None, v_scale=None):
    """Route A's arithmetic in plain torch.  Rank r of a ``clusters``-block
    cluster walks its :func:`decode_chunk` of each slot's rows; its running
    max starts at the lower ranks' chunk maximum (at NEG_INF with
    ``own_max``: P rounded against the chunk's own max); each page adds
    exp(m_t - m_T) round(P) V to acc and exp(m_t - m_T) sum(p) to l, m_T
    the slot's final max; the ranks' sums add up and drain through
    acc / max(l, 1e-30)."""
    S, h, hd = q.shape
    P, hkv = k_pool.shape[1], k_pool.shape[2]
    rep, scale = h // hkv, hd ** -0.5
    qg = q.float().reshape(S, hkv, rep, hd)
    table, bstart = exe.table.tolist(), exe.bstart.tolist()
    cols = torch.arange(P)
    out = torch.zeros_like(q)
    floor = torch.full((hkv, rep, 1), NEG_INF)
    for s in range(S):
        pages = []
        for _, page, k_len, _, _ in table[bstart[s]:bstart[s + 1]]:
            live = cols < k_len
            k = torch.where(live[:, None, None], k_pool[page].float(), 0.0)
            sc = torch.einsum("grd,pgd->grp", qg[s], k) * scale
            if k_scale is not None:
                sc = sc * torch.where(live, k_scale[page], 0.0)
            pages.append((page, live, torch.where(live, sc, NEG_INF)))
        chunks = [decode_chunk(0, len(pages), clusters, r)
                  for r in range(clusters)]
        cmax = [torch.stack([floor[..., 0]] + [sc.amax(-1) for _, _, sc
                                               in pages[lo:hi]]).amax(0)
                [..., None] for lo, hi in chunks]
        m_fin = torch.stack(cmax).amax(0)
        acc = torch.zeros((hkv, rep, hd))
        l = torch.zeros((hkv, rep, 1))
        for r, (lo, hi) in enumerate(chunks):
            m = floor if own_max or r == 0 else \
                torch.stack(cmax[:r]).amax(0)
            for page, live, sc in pages[lo:hi]:
                m = torch.maximum(m, sc.amax(-1, keepdim=True))
                p = torch.exp(sc - m)
                fac = torch.exp(m - m_fin)
                l = l + fac * p.sum(-1, keepdim=True)
                if v_scale is not None:
                    p = p * torch.where(live, v_scale[page], 0.0)
                v = torch.where(live[:, None, None], v_pool[page].float(), 0.0)
                acc = acc + fac * torch.einsum(
                    "grp,pgd->grd", p.to(q.dtype).float(), v)
        out[s] = (acc / torch.clamp_min(l, 1e-30)).reshape(h, hd).to(q.dtype)
    return out


def _premise_inputs(case, seed):
    q, k, v, bt, lengths = _attn_inputs(case, seed)
    exe = _state(case, bt, lengths, "cpu")
    return exe, *(torch.from_numpy(x).to(BF) for x in (q, k, v))


@pytest.mark.parametrize("clusters", [1, 2, 3, 8])
@pytest.mark.parametrize("case", ATTN_CASES + LONG_CASES)
def test_split_walk_with_prefix_max_matches_sequential_walk(case, clusters):
    exe, q, k, v = _premise_inputs(case, seed=len(case[-1]))
    want = flash_decode_plain(exe, q, k, v)
    got = _split_walk(exe, q, k, v, clusters)
    g, w = got.float(), want.float()
    assert torch.isfinite(g).all()
    for s, L in enumerate(case[-1]):
        if L == 0:
            assert torch.equal(got[s], torch.zeros_like(got[s]))
    assert (g - w).abs().max() <= _bf16_ulp(w)
    assert (g != w).float().mean() <= 0.02


def test_split_walk_int8_pools_matches_sequential_walk():
    """The same premise over KV-int8 pools (the scales folded as the
    kernel folds them), at the serving shape's group and a long slot."""
    from repro_torch.models.attention import quantize_kv_rows
    case = LONG_CASES[1]
    exe, q, k, v = _premise_inputs(case, seed=5)
    (kq, ks), (vq, vs) = (quantize_kv_rows(torch.nan_to_num(t))
                          for t in (k, v))
    want = flash_decode_plain(exe, q, kq, vq, ks, vs)
    for clusters in (1, 2, 3, 8):
        got = _split_walk(exe, q, kq, vq, clusters, k_scale=ks, v_scale=vs)
        g, w = got.float(), want.float()
        assert (g - w).abs().max() <= _bf16_ulp(w)
        assert (g != w).float().mean() <= 0.02


def test_rounding_against_the_chunks_own_max_moves_more():
    """The variant that starts each rank at NEG_INF (P rounded against its
    chunk's own max) differs from the sequential walk in more elements
    than the prefix-max walk does, over the cases split 2, 3 and 8 ways."""
    prefix = own = total = 0
    for case in ATTN_CASES + LONG_CASES:
        exe, q, k, v = _premise_inputs(case, seed=len(case[-1]))
        want = flash_decode_plain(exe, q, k, v).float()
        for clusters in (2, 3, 8):
            prefix += int((_split_walk(exe, q, k, v, clusters).float()
                           != want).sum())
            own += int((_split_walk(exe, q, k, v, clusters, own_max=True)
                        .float() != want).sum())
            total += want.numel()
    assert own > prefix, (own, prefix, total)
    assert own - prefix > 0.005 * total, (own, prefix, total)


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    return torch.device("cuda")


def _run(exe, q, k, v, ks=None, vs=None):
    """One kernel call, the route it took and the plain version's output."""
    before = dict(fk.DECODE_ROUTES)
    name = "flash_decode" if ks is None else "flash_decode_int8"
    n0 = fk.LAUNCHES[name]
    got = flash_decode(exe, q, k, v, ks, vs)
    torch.cuda.synchronize()
    assert fk.LAUNCHES[name] == n0 + 1
    taken = [r for r in fk.DECODE_ROUTES if fk.DECODE_ROUTES[r] != before[r]]
    assert len(taken) == 1
    return got, taken[0], flash_decode_plain(exe, q, k, v, ks, vs)


def _check(got, want, lengths, tol):
    assert torch.isfinite(got.float()).all()
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)
    for s, L in enumerate(lengths):
        if L == 0:
            assert torch.equal(got[s], torch.zeros_like(got[s]))


@pytest.mark.gpu
@pytest.mark.parametrize("case", CARD_CASES)
def test_route_a_edges_on_card(cuda_device, case):
    q, k, v, bt, lengths = _attn_inputs(case, seed=1)
    exe = _state(case, bt, lengths, cuda_device)
    tq, tk, tv = (torch.from_numpy(x).to(cuda_device).to(BF)
                  for x in (q, k, v))
    got, route, want = _run(exe, tq, tk, tv)
    assert route == "A"
    _check(got, want, case[-1], 2e-2)


def _serve_inputs(device, quant):
    S, pages, P, B, h, hkv, hd, lengths = SERVE
    gen = torch.Generator(device=device).manual_seed(0)
    q = torch.randn((S, h, hd), generator=gen, device=device).to(BF)
    k, v = (torch.randn((pages, P, hkv, hd), generator=gen, device=device)
            .to(BF) for _ in range(2))
    perm = torch.randperm(pages, generator=torch.Generator().manual_seed(3))
    bt = torch.zeros((S, B), dtype=torch.int32)
    used = 0
    for slot, n in enumerate(-(-L // P) for L in lengths):
        bt[slot, :n] = perm[used:used + n]
        used += n
    exe = _state(SERVE, bt, torch.tensor(lengths, dtype=torch.int32), device)
    if not quant:
        return exe, q, k, v, None, None
    from repro_torch.models.attention import quantize_kv_rows
    (kq, ks), (vq, vs) = (quantize_kv_rows(t) for t in (k, v))
    return exe, q, kq, vq, ks, vs


@pytest.mark.gpu
@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
def test_route_a_serving_shape_on_card(cuda_device, quant):
    exe, q, k, v, ks, vs = _serve_inputs(cuda_device, quant)
    got, route, want = _run(exe, q, k, v, ks, vs)
    assert route == "A"
    _check(got, want, SERVE[-1], 2e-2)


@pytest.mark.gpu
@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
def test_route_a_streams_a_slot_longer_than_its_ring_on_card(cuda_device,
                                                            quant):
    """Pages of 64 rows at head dim 128: a block's ring holds 4 bf16 pages
    (or 8 int8 ones), and 72 (slot, KV head) pairs leave a cluster of 1, so
    the 20-page slots stream through the ring in rounds."""
    case = (9, 200, 64, 20, 16, 8, 128,
            [1280, 0, 1, 1279, 640, 63, 64, 65, 1000])
    q, k, v, bt, lengths = _attn_inputs(case, seed=2)
    exe = _state(case, bt, lengths, cuda_device)
    assert decode_cluster(9, 8, 20, H100_SMS) == 1
    tq, tk, tv = (torch.from_numpy(x).to(cuda_device).to(BF)
                  for x in (q, k, v))
    ks = vs = None
    if quant:
        from repro_torch.models.attention import quantize_kv_rows
        (tk, ks), (tv, vs) = (quantize_kv_rows(torch.nan_to_num(t))
                              for t in (tk, tv))
    got, route, want = _run(exe, tq, tk, tv, ks, vs)
    assert route == "A"
    _check(got, want, case[-1], 2e-2)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [F32, BF], ids=["fp32", "bf16-hd16"])
def test_route_b_on_card(cuda_device, dtype):
    case = ATTN_CASES[1]
    q, k, v, bt, lengths = _attn_inputs(case, seed=4)
    exe = _state(case, bt, lengths, cuda_device)
    tq, tk, tv = (torch.from_numpy(x).to(cuda_device).to(dtype)
                  for x in (q, k, v))
    got, route, want = _run(exe, tq, tk, tv)
    assert route == "B"
    _check(got, want, case[-1], 1e-4 if dtype == F32 else 2e-2)
