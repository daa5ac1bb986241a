"""K4's split-K arithmetic on the CPU (no GPU needed).

``csrc/decode_attention.cu`` splits a sequence's cache into at most 8
contiguous runs of 64-row tiles, one per block of a thread-block cluster;
each block keeps a partial online softmax (m, l, acc) and rank 0 combines
the partials in rank order. :func:`split_k_decode` does the same algorithm
in PyTorch fp32 with the kernel's split boundaries, and is held against the
port's plain version (``decode_attn_ref``) and the JAX Pallas kernel in
interpret mode at the fp32 tolerance, 2e-5: the split changes only the
order of the sums. The helper lives here, not in the package: the card runs
the kernel, the CPU the plain version.
"""
import math
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)  # the suite runs several workers at once: leave them cores

import jax.numpy as jnp  # noqa: E402

from repro.kernels.decode_attention import decode_attention as jax_decode  # noqa: E402
from repro_torch.kernels import decode_attention as tdec  # noqa: E402
from repro_torch.kernels.ref import decode_attn_ref  # noqa: E402

TOL = dict(rtol=2e-5, atol=2e-5)  # fp32, tests/test_kernels.py
TILE = 64        # csrc/decode_attention.cu: kTile
MAX_SPLITS = 8   # csrc/decode_attention.cu: kMaxSplits (the portable cluster size)
NEG_INF = -1e30
SOURCE = Path(tdec.__file__).resolve().parent / "csrc" / "decode_attention.cu"


def split_tiles(s: int) -> list[tuple[int, int]]:
    """The kernel's split layout for a cache of S rows: split i takes tiles
    [i * n / splits, (i + 1) * n / splits) of the n = ceil(S / 64); it
    depends on S only."""
    n = -(-s // TILE)
    splits = min(MAX_SPLITS, n)
    return [(i * n // splits, (i + 1) * n // splits) for i in range(splits)]


def split_partial(q, k, v, n: int, tiles: tuple[int, int], scale: float):
    """One split's online softmax over its tiles below cur_len = n, tile by
    tile as the kernel sweeps them. q: (G, hd); k, v: (S, hd). Returns (m,
    l, acc) of shapes (G,), (G,), (G, hd); an empty split is (-1e30, 0, 0)."""
    g, hd = q.shape
    m = torch.full((g,), NEG_INF)
    l = torch.zeros(g)
    acc = torch.zeros(g, hd)
    for t in range(*tiles):
        r0, r1 = t * TILE, min((t + 1) * TILE, n)
        if r0 >= r1:
            break
        s = (q @ k[r0:r1].T) * scale                      # (G, rows)
        m_new = torch.maximum(m, s.max(dim=1).values)
        p = torch.exp(s - m_new[:, None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=1)
        acc = acc * alpha[:, None] + p @ v[r0:r1]         # P stays fp32
        m = m_new
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


def inputs(seed, b, s, h, kv, hd):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, h, hd)).astype(np.float32),
            rng.standard_normal((b, s, kv, hd)).astype(np.float32),
            rng.standard_normal((b, s, kv, hd)).astype(np.float32))


def test_split_constants_match_the_kernel_source():
    src = SOURCE.read_text()
    assert re.search(r"constexpr int kTile = 64;", src)
    assert re.search(r"constexpr int kMaxSplits = 8;", src)
    assert "std::min(kMaxSplits, (S + kTile - 1) / kTile)" in src  # splits from S only
    assert "split * n_all / splits" in src and "(split + 1) * n_all / splits" in src


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
