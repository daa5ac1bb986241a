"""The split-K arithmetic of K4 and K1 on the CPU (no GPU needed).

``csrc/decode_split.cuh`` (instantiated by ``decode_attention.cu`` for K4
and ``paged_attention.cu`` for K1) splits a sequence's cache — contiguous,
or read through a block table — into at most 8 contiguous runs of 64-row
tiles, one per block of a thread-block cluster, the split set by the cache's
capacity (K4: S; K1: the table's n * page); each block takes the G query
heads of its kv head in slices of at most 1024 / hd heads, keeps a partial
online softmax (m, l, acc) per head, and rank 0 combines the partials in
rank order. :func:`split_k_decode` and :func:`split_k_paged_decode` do the
same algorithm in PyTorch fp32 with the kernel's split boundaries and head
slices, and are held against the port's plain versions and the JAX Pallas
kernels in interpret mode at the fp32 tolerance, 2e-5: the split changes
only the order of the sums. The helpers live here, not in the package: the
card runs the kernels, the CPU the plain versions.
"""
import math
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)  # the suite runs several workers at once: leave them cores

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jax_ref  # noqa: E402
from repro.kernels.decode_attention import decode_attention as jax_decode  # noqa: E402
from repro.kernels.paged_attention import paged_decode_attention as jax_paged_decode  # noqa: E402
from repro_torch.kernels import decode_attention as tdec  # noqa: E402
from repro_torch.kernels import paged_attention as tpaged  # noqa: E402
from repro_torch.kernels.ref import decode_attn_ref, paged_decode_attn_ref  # noqa: E402

TOL = dict(rtol=2e-5, atol=2e-5)  # fp32, tests/test_kernels.py
TILE = 64        # csrc/decode_split.cuh: kTile
MAX_SPLITS = 8   # csrc/decode_split.cuh: kMaxSplits (the portable cluster size)
SLICE_WIDTH = 1024  # csrc/decode_split.cuh: kSliceWidth, the outputs of one head slice
NEG_INF = -1e30
CSRC = Path(tdec.__file__).resolve().parent / "csrc"
SOURCE = CSRC / "decode_split.cuh"


def split_tiles(s: int) -> list[tuple[int, int]]:
    """The kernel's split layout for a cache of S rows: split i takes tiles
    [i * n / splits, (i + 1) * n / splits) of the n = ceil(S / 64); it
    depends on S only."""
    n = -(-s // TILE)
    splits = min(MAX_SPLITS, n)
    return [(i * n // splits, (i + 1) * n // splits) for i in range(splits)]


def slice_heads(g: int, hd: int) -> int:
    """Heads per slice: as many as give at most SLICE_WIDTH outputs."""
    return min(g, SLICE_WIDTH // hd)


def split_partial(q, k, v, n: int, tiles: tuple[int, int], scale: float):
    """One split's online softmax over its tiles below cur_len = n, tile by
    tile as the kernel sweeps them, each tile serving the G heads slice by
    slice. q: (G, hd); k, v: (S, hd) — the sequence's rows in logical order.
    Returns (m, l, acc) of shapes (G,), (G,), (G, hd); an empty split is
    (-1e30, 0, 0)."""
    g, hd = q.shape
    gs = slice_heads(g, hd)
    m = torch.full((g,), NEG_INF)
    l = torch.zeros(g)
    acc = torch.zeros(g, hd)
    for t in range(*tiles):
        r0, r1 = t * TILE, min((t + 1) * TILE, n)
        if r0 >= r1:
            break
        for h0 in range(0, g, gs):
            sl = slice(h0, min(h0 + gs, g))
            s = (q[sl] @ k[r0:r1].T) * scale              # (heads, rows)
            m_new = torch.maximum(m[sl], s.max(dim=1).values)
            p = torch.exp(s - m_new[:, None])
            alpha = torch.exp(m[sl] - m_new)
            l[sl] = l[sl] * alpha + p.sum(dim=1)
            acc[sl] = acc[sl] * alpha[:, None] + p @ v[r0:r1]  # P stays fp32
            m[sl] = m_new
    return m, l, acc


def combine(parts):
    """Rank 0's combine: rescale each split's partial by exp(m_i - m) in rank
    order, sum, divide by l (l == 0 -> 1: cur_len 0 gives exact zeros)."""
    m = parts[0][0]
    for mi, _, _ in parts[1:]:
        m = torch.maximum(m, mi)
    l = torch.zeros_like(m)
    acc = torch.zeros_like(parts[0][2])
    for mi, li, ai in parts:
        w = torch.exp(mi - m)
        l = l + w * li
        acc = acc + w[:, None] * ai
    return acc / torch.where(l == 0, torch.ones_like(l), l)[:, None]


def split_k_decode(q, k, v, cur_len):
    """q: (B, H, hd); k, v: (B, S, KV, hd); cur_len: (B,) -> (B, H, hd), in
    fp32, by K4's split-K over (sequence, kv head)."""
    b, h, hd = q.shape
    s, kv = k.shape[1], k.shape[2]
    g = h // kv
    scale = 1.0 / math.sqrt(hd)
    out = torch.empty(b, h, hd)
    for bi in range(b):
        n = max(0, min(int(cur_len[bi]), s))
        for j in range(kv):
            qg = q[bi, j * g:(j + 1) * g].float()
            parts = [split_partial(qg, k[bi, :, j].float(), v[bi, :, j].float(), n, tiles, scale)
                     for tiles in split_tiles(s)]
            out[bi, j * g:(j + 1) * g] = combine(parts)
    return out


def paged_rows(block_table, b: int, page: int, p: int, capacity: int):
    """The (page, slot) of each logical row j < capacity of sequence b, as
    the kernel's ``Paged`` policy reads it: page block_table[b, j // page]
    clamped into [0, P), slot j % page."""
    j = torch.arange(capacity)
    phys = block_table[b, j // page].long().clamp(0, p - 1)
    return phys, j % page


def split_k_paged_decode(q, k_pages, v_pages, block_table, cur_len):
    """q: (B, H, hd); pages: (P, page, KV, hd); block_table: (B, n); cur_len:
    (B,) -> (B, H, hd), in fp32, by K1's split-K: the splits from the
    table's capacity n * page, each row read through the block table."""
    b, h, hd = q.shape
    p, page, kv, _ = k_pages.shape
    cap = block_table.shape[1] * page
    g = h // kv
    scale = 1.0 / math.sqrt(hd)
    out = torch.empty(b, h, hd)
    for bi in range(b):
        n = max(0, min(int(cur_len[bi]), cap))
        phys, slot = paged_rows(block_table, bi, page, p, cap)
        for j in range(kv):
            qg = q[bi, j * g:(j + 1) * g].float()
            k = k_pages[phys, slot, j].float()  # (capacity, hd) in logical order
            v = v_pages[phys, slot, j].float()
            parts = [split_partial(qg, k, v, n, tiles, scale) for tiles in split_tiles(cap)]
            out[bi, j * g:(j + 1) * g] = combine(parts)
    return out


def inputs(seed, b, s, h, kv, hd):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, h, hd)).astype(np.float32),
            rng.standard_normal((b, s, kv, hd)).astype(np.float32),
            rng.standard_normal((b, s, kv, hd)).astype(np.float32))


def test_split_constants_match_the_kernel_source():
    src = SOURCE.read_text() + (CSRC / "row_policy.cuh").read_text()  # the sweep and its row policies
    assert re.search(r"constexpr int kTile = 64;", src)
    assert re.search(r"constexpr int kMaxSplits = 8;", src)
    assert re.search(r"constexpr int kThreads = 256;", src) and re.search(r"constexpr int kMaxPairs = 2;", src)
    assert "constexpr int kSliceWidth = 2 * kMaxPairs * kThreads;" in src  # 1024 outputs per head slice
    assert "std::min(kMaxSplits, (capacity + kTile - 1) / kTile)" in src  # splits from the capacity only
    assert "split * n_all / splits" in src and "(split + 1) * n_all / splits" in src
    # K4 reads row b * batch + j (batch = S for a contiguous cache; more for
    # one layer of stacked caches, read in place), K1 page block_table[b, j /
    # page] (clamped) at slot j % page
    assert "return (int64_t)b * batch + j;" in src
    assert "decode_split::Contiguous{S, batch}" in (CSRC / "decode_attention.cu").read_text()
    assert "row_policy::Contiguous{S, S}" in (CSRC / "flash_attention.cu").read_text()  # K3: contiguous
    assert "min(max(table[(int64_t)b * n + j / page], 0), P - 1)" in src and "phys * page + j % page" in src
    for name, policy in (("decode_attention.cu", "Contiguous"), ("paged_attention.cu", "Paged")):
        text = (CSRC / name).read_text()
        assert '#include "decode_split.cuh"' in text and "decode_split::sweep<D>" in text
        assert f"decode_split::{policy}" in text


@pytest.mark.parametrize("s", [1, 64, 65, 300, 512, 513, 1024, 4096, 4100])
def test_split_layout_covers_every_tile_once(s):
    tiles = split_tiles(s)
    n = -(-s // TILE)
    assert len(tiles) == min(MAX_SPLITS, n)
    assert tiles[0][0] == 0 and tiles[-1][1] == n
    assert all(a[1] == b[0] for a, b in zip(tiles, tiles[1:]))  # contiguous, in rank order
    sizes = [t1 - t0 for t0, t1 in tiles]
    assert min(sizes) >= 1 and max(sizes) - min(sizes) <= 1      # balanced


# (S, cur_len, block_k for the Pallas kernel: it must divide S)
CASES = [
    (512, 1, 128),     # one row: splits 1-7 empty
    (512, 64, 128),    # a split boundary (one tile per split)
    (512, 65, 128),    # one row past it
    (1024, 128, 256),  # a split boundary, two tiles per split
    (1024, 129, 256),
    (300, 300, 100),   # cur_len == S, S not a multiple of 64 (5 splits)
    (4100, 4100, 205), # S > 8 * 64: 65 tiles over 8 splits of 8-9 tiles
    (4100, 2000, 205), # the splits past cur_len empty
]


@pytest.mark.parametrize("s,n,block_k", CASES)
def test_split_combine_matches_plain_and_pallas(s, n, block_k):
    qn, kn, vn = inputs(s + n, 2, s, 8, 2, 32)
    cur = np.array([n, max(1, n // 3)], dtype=np.int32)
    got = split_k_decode(torch.from_numpy(qn), torch.from_numpy(kn), torch.from_numpy(vn), torch.from_numpy(cur))
    want = decode_attn_ref(torch.from_numpy(qn), torch.from_numpy(kn), torch.from_numpy(vn), torch.from_numpy(cur))
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)
    pallas = jax_decode(jnp.asarray(qn), jnp.asarray(kn), jnp.asarray(vn), jnp.asarray(cur),
                        block_k=block_k, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), **TOL)


@pytest.mark.parametrize("s", [300, 512, 4100])
def test_split_combine_gives_exact_zeros_at_empty_cache(s):
    """cur_len 0: every split is empty, (m, l, acc) = (-1e30, 0, 0), and the
    combine writes exact zeros, as the plain version does (the Pallas kernel
    has no guard there and returns the mean of V, ROADMAP Queue 3)."""
    qn, kn, vn = inputs(5, 2, s, 4, 1, 32)
    cur = torch.tensor([0, 7], dtype=torch.int32)
    q, k, v = torch.from_numpy(qn), torch.from_numpy(kn), torch.from_numpy(vn)
    empty = split_partial(q[0], k[0, :, 0], v[0, :, 0], 0, split_tiles(s)[0], 0.1)
    assert torch.equal(empty[0], torch.full_like(empty[0], NEG_INF)) and not empty[1].any() and not empty[2].any()
    got = split_k_decode(q, k, v, cur)
    assert torch.equal(got[0], torch.zeros_like(got[0]))
    np.testing.assert_allclose(got.numpy(), decode_attn_ref(q, k, v, cur).numpy(), **TOL)


# (B, n, page, P, H, KV, hd, cur_len): K1's split layout from the table's
# width, rows through a scattered block table (one entry out of range:
# clamped), and head slices where G * hd exceeds one slice (1536, 6144)
PAGED_CASES = [
    (2, 4, 16, 12, 8, 2, 32, [64, 17]),        # one tile per split
    (2, 9, 16, 24, 4, 1, 32, [144, 65]),       # 3 splits: a split boundary mid-page
    (2, 40, 16, 90, 4, 2, 16, [640, 300]),     # 10 tiles over 8 splits
    (2, 3, 16, 8, 24, 2, 128, [48, 20]),       # starcoder2-3b's group: G * hd = 1536, 2 slices
    (1, 2, 16, 4, 48, 1, 128, [29]),           # granite-34b's group: 6144, 6 slices
]


@pytest.mark.parametrize("b,n,page,p,h,kv,hd,lens", PAGED_CASES)
def test_paged_split_combine_matches_plain_and_pallas(b, n, page, p, h, kv, hd, lens):
    rng = np.random.default_rng(n * page + h)
    kpn = rng.standard_normal((p, page, kv, hd)).astype(np.float32)
    vpn = rng.standard_normal((p, page, kv, hd)).astype(np.float32)
    qn = rng.standard_normal((b, h, hd)).astype(np.float32)
    btn = rng.permutation(np.arange(1, p))[: b * n].reshape(b, n).astype(np.int32)
    cur = np.asarray(lens, np.int32)
    q, kp, vp = torch.from_numpy(qn), torch.from_numpy(kpn), torch.from_numpy(vpn)
    bt, ct = torch.from_numpy(btn), torch.from_numpy(cur)
    got = split_k_paged_decode(q, kp, vp, bt, ct)
    np.testing.assert_allclose(got.numpy(), paged_decode_attn_ref(q, kp, vp, bt, ct).numpy(), **TOL)
    pallas = jax_paged_decode(jnp.asarray(qn), jnp.asarray(kpn), jnp.asarray(vpn), jnp.asarray(btn),
                              jnp.asarray(cur), interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), **TOL)


def test_paged_split_clamps_a_table_entry_out_of_range():
    """An entry outside [0, P) reads the clamped page, as the kernel does,
    never out of the arena: rows past cur_len are masked, so a padded table
    row (page 0, the arena's scratch page) changes nothing."""
    rng = np.random.default_rng(3)
    kp = torch.from_numpy(rng.standard_normal((6, 16, 1, 32)).astype(np.float32))
    q = torch.from_numpy(rng.standard_normal((1, 2, 32)).astype(np.float32))
    bt = torch.tensor([[4, 99, 0]], dtype=torch.int32)  # 99 -> P - 1 = 5
    cur = torch.tensor([40], dtype=torch.int32)
    want = split_k_paged_decode(q, kp, kp, torch.tensor([[4, 5, 0]], dtype=torch.int32), cur)
    assert torch.equal(split_k_paged_decode(q, kp, kp, bt, cur), want)


@pytest.mark.parametrize("h,kv", [(24, 2), (48, 1)])
def test_wrappers_take_any_group_on_the_cpu(h, kv):
    """K4 and K1 take groups wider than one head slice (G * hd 1536 and 6144,
    starcoder2-3b's and granite-34b's): their checks pass, and the CPU
    wrappers (the plain versions) match the JAX package's reference."""
    hd, s, page, n, p = 128, 96, 16, 6, 14
    rng = np.random.default_rng(h)
    qn = rng.standard_normal((2, h, hd)).astype(np.float32)
    kn, vn = (rng.standard_normal((2, s, kv, hd)).astype(np.float32) for _ in range(2))
    cur = np.asarray([96, 33], np.int32)
    q, k, v, ct = (torch.from_numpy(x) for x in (qn, kn, vn, cur))
    tdec._check(q.bfloat16(), k.bfloat16(), v.bfloat16(), ct)
    want = np.asarray(jax_ref.decode_attn_ref(jnp.asarray(qn), jnp.asarray(kn), jnp.asarray(vn), jnp.asarray(cur)))
    np.testing.assert_allclose(tdec.decode_attention(q, k, v, ct).numpy(), want, **TOL)
    # the same rows laid out as pages through a scattered table
    btn = rng.permutation(np.arange(1, p))[: 2 * n].reshape(2, n).astype(np.int32)
    kpn, vpn = (np.zeros((p, page, kv, hd), np.float32) for _ in range(2))
    for b in range(2):
        for j in range(s):
            kpn[btn[b, j // page], j % page] = kn[b, j]
            vpn[btn[b, j // page], j % page] = vn[b, j]
    kp, vp, bt = torch.from_numpy(kpn), torch.from_numpy(vpn), torch.from_numpy(btn)
    tpaged._check_pages(q.bfloat16(), kp.bfloat16(), vp.bfloat16(), bt, ct, "paged_decode_attention", "cur_len")
    np.testing.assert_allclose(tpaged.paged_decode_attention(q, kp, vp, bt, ct).numpy(), want, **TOL)
