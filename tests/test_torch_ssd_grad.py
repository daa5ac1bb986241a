"""The arithmetic of K6's gradient (``csrc/ssd_scan_bwd.cu``) walked on the
host: the first kernel's two walks over a sequence's chunks (the states
before each chunk, S_c, and the cotangents of the states after it, Z_c,
from the final state's dS back; on the card each in blocks of its own),
then the second kernel's per-chunk terms (the 64 x 64 products of an
attention backward, the states' terms, the per-row sums and their reverse
cumulative sum for ddt, dA_log and dD summed over every (b, chunk)), with a
group's heads split over blocks as the wrapper's ``grad_splits`` deals them
(each split sums its heads' dB and dC in head order into a partial, and the
partials add in split order), in float64, against the plain backward
(``kernels/ref.py: ssd_ref_bwd``) and ``jax.vjp`` of the reference's
``ssd_ref``: the algorithm is held at 1e-5 (the plain backward's fp32
sums). The kernel's bf16 roundings (each of S_c, Z_c, L o (C B^T), L o M and
the walks' w x and exp(cl) dy rounded once) are emulated apart, and held to
the card's limit: 2e-2 of each gradient's max (``tests/test_torch_kernels_cuda.py``,
``chip_smoke.py``)."""
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jax_ref  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels import ssd_scan as tssd  # noqa: E402

CSRC = Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "kernels" / "csrc"
TOL = 1e-5
GRAD_TOL = 2e-2  # the card's limit, of each gradient's max |g|


def _bf(t, on: bool):
    return t.float().to(torch.bfloat16).double() if on else t


def walk_backward(x, bm, cm, dt, a_log, d_skip, dy, dstate=None, q=tssd.GRAD_CHUNK, splits=1, bf16=False):
    """(dx, dbm, dcm, ddt, da_log, dd_skip) by the kernels' decomposition,
    in float64; rows past T zero-padded as the kernels zero-fill them; a
    group's heads dealt to ``splits`` blocks as the kernel takes them; with
    ``bf16``, the kernels' single roundings to bf16."""
    x, bm, cm, dt, dy = (v.double() for v in (x, bm, cm, dt, dy))
    b, t, h, p = x.shape
    g, n = bm.shape[2], bm.shape[3]
    hpg = h // g
    per = -(-hpg // splits)
    assert (splits - 1) * per < hpg, "every split holds a head"
    a = -torch.exp(a_log.double())
    nc = -(-t // q)
    pad = nc * q - t

    def padded(v):
        return torch.cat([v, v.new_zeros(v.shape[0], pad, *v.shape[2:])], 1)

    x, bm, cm, dt, dy = map(padded, (x, bm, cm, dt, dy))

    def chunk(v, c):
        return v[:, c * q:(c + 1) * q]

    # kernel 1: the walks (S forward, Z in reverse: independent blocks)
    s_before = torch.zeros(b, h, nc, p, n, dtype=torch.float64)
    z_after = torch.zeros_like(s_before)
    st = torch.zeros(b, h, p, n, dtype=torch.float64)
    for c in range(nc):
        s_before[:, :, c] = _bf(st, bf16)
        cl = torch.cumsum(chunk(dt, c) * a, 1)
        w = torch.exp(cl[:, -1:] - cl) * chunk(dt, c)
        bh = torch.repeat_interleave(chunk(bm, c), hpg, 2)
        update = torch.einsum("bjhp,bjhn->bhpn", _bf(chunk(x, c) * w[..., None], bf16), bh)
        st = torch.exp(cl[:, -1])[..., None, None] * st + update
    z = torch.zeros(b, h, p, n, dtype=torch.float64) if dstate is None else dstate.double()
    for c in reversed(range(nc)):
        z_after[:, :, c] = _bf(z, bf16)
        cl = torch.cumsum(chunk(dt, c) * a, 1)
        ch = torch.repeat_interleave(chunk(cm, c), hpg, 2)
        update = torch.einsum("bkhp,bkhn->bhpn", _bf(chunk(dy, c) * torch.exp(cl)[..., None], bf16), ch)
        z = torch.exp(cl[:, -1])[..., None, None] * z + update

    # kernel 2: each (chunk, b, group, split), the split's heads in order
    dx, ddt = torch.zeros_like(x), torch.zeros_like(dt)
    part = torch.zeros(splits, b, nc * q, g, 2, n, dtype=torch.float64)  # each split's dB, dC
    da, dd = torch.zeros(h, dtype=torch.float64), torch.zeros(h, dtype=torch.float64)
    causal = torch.ones(q, q, dtype=torch.bool).tril()
    for c in range(nc):
        rows = slice(c * q, (c + 1) * q)
        for bi in range(b):
            for gi in range(g):
                for sp in range(splits):
                    for hh in range(gi * hpg + sp * per, gi * hpg + min(hpg, (sp + 1) * per)):
                        X, DY = x[bi, rows, hh], dy[bi, rows, hh]
                        B, C, DT = bm[bi, rows, gi], cm[bi, rows, gi], dt[bi, rows, hh]
                        S, Z = s_before[bi, hh, c], z_after[bi, hh, c]
                        cl = torch.cumsum(DT * a[hh], 0)
                        E = torch.exp((cl[:, None] - cl[None, :]).clamp(max=0)) * causal
                        L = E * DT[None, :]
                        CB, M = C @ B.T, DY @ X.T
                        W1, W2 = _bf(L * CB, bf16), _bf(L * M, bf16)
                        A = L * M * CB
                        # phase 1 (rows i): dC, e
                        dys = DY @ S
                        e = torch.exp(cl) * (C * dys).sum(1)
                        part[sp, bi, rows, gi, 1] += torch.exp(cl)[:, None] * dys + W2 @ B
                        # phase 2 (rows j): dx, dB, q, s
                        zb = B @ Z.T
                        qj = (X * zb).sum(1)
                        f = torch.exp(cl[-1] - cl)
                        wj = f * DT
                        s = wj * qj
                        dx[bi, rows, hh] = wj[:, None] * zb + W1.T @ DY + d_skip[hh].double() * DY
                        part[sp, bi, rows, gi, 0] += wj[:, None] * (X @ Z) + W2.T @ C
                        # phase 3: dcl, its reverse cumulative sum, ddt, the partials
                        dcl = A.sum(1) - A.sum(0) + e - s
                        dcl[-1] += torch.exp(cl[-1]) * (Z * S).sum() + s.sum()
                        r = torch.flip(torch.cumsum(torch.flip(dcl, [0]), 0), [0])
                        ddt[bi, rows, hh] = (E * CB * M).sum(0) + f * qj + a[hh] * r
                        da[hh] += (DT * r).sum()
                        dd[hh] += (DY * X).sum()
    total = part[0]
    for sp in range(1, splits):  # the last split to finish adds the partials in split order
        total = total + part[sp]
    return dx[:, :t], total[:, :t, :, 0], total[:, :t, :, 1], ddt[:, :t], a * da, dd


def inputs(b, t, h, g, p, n, with_state, seed=0):
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(b, t, h, p, generator=gen)
    bm, cm = (torch.randn(b, t, g, n, generator=gen) * 0.5 for _ in range(2))
    dt = torch.nn.functional.softplus(torch.randn(b, t, h, generator=gen)) * 0.3
    a_log, d_skip = torch.randn(h, generator=gen) * 0.3, torch.randn(h, generator=gen)
    dy = torch.randn(b, t, h, p, generator=gen)
    ds = torch.randn(b, h, p, n, generator=gen) if with_state else None
    return x, bm, cm, dt, a_log, d_skip, dy, ds


NAMES = ("dx", "dbm", "dcm", "ddt", "da_log", "dd_skip")


@pytest.mark.parametrize("b,t,h,g,p,n,with_state", [
    (2, 150, 4, 2, 8, 16, True),   # two full chunks and a partial one, two groups
    (1, 37, 3, 1, 8, 8, False),    # one partial chunk
    (1, 128, 3, 1, 4, 8, True),    # whole chunks only
    (2, 65, 2, 1, 8, 16, False),   # one row past a chunk
    (1, 100, 6, 1, 8, 8, True),    # a group of 6 heads: splits of 1, 2 (runs of 3), 3 and 6
])
def test_walk_matches_the_plain_backward(b, t, h, g, p, n, with_state):
    """Every way the chunk kernel can deal a group's heads (one block,
    runs of two heads, one head a block, ...) gives the plain backward."""
    ins = inputs(b, t, h, g, p, n, with_state, seed=t)
    want = ref.ssd_ref_bwd(*(v.double() if v is not None else None for v in ins))
    hpg = h // g
    for splits in sorted({-(-hpg // per) for per in range(1, hpg + 1)}):
        got = walk_backward(*ins, splits=splits)
        for name, x, w in zip(NAMES, got, want):
            assert x.shape == w.shape, name
            assert float((x - w).abs().max()) <= TOL * float(w.abs().max()), (name, splits)


def test_walk_matches_jax_vjp():
    ins = inputs(1, 100, 4, 2, 8, 8, True, seed=5)
    _, vjp = jax.vjp(jax_ref.ssd_ref, *(jnp.asarray(v.numpy()) for v in ins[:6]))
    want = vjp((jnp.asarray(ins[6].numpy()), jnp.asarray(ins[7].numpy())))
    for name, x, w in zip(NAMES, walk_backward(*ins, splits=2), want):
        w = np.asarray(w)
        assert float(np.abs(x.numpy() - w).max()) <= TOL * float(np.abs(w).max()), name


def test_kernel_sources_state_the_wrappers_constants():
    """The chunk of 64 rows and the head dim of 64 that the wrapper sizes the
    workspaces by are the kernel's, and the build compiles both gradients."""
    from repro_torch.kernels import build

    src = (CSRC / "ssd_scan_bwd.cu").read_text()
    assert re.search(r"constexpr int kQ = (\d+);", src).group(1) == str(tssd.GRAD_CHUNK)
    assert re.search(r"constexpr int kP = (\d+);", src).group(1) == str(tssd.GRAD_HEAD_DIM)
    assert "atomicAdd(ticket" in src and "atomicAdd(" not in src.replace("atomicAdd(ticket", "")
    assert {"moe_gmm_bwd.cu", "ssd_scan_bwd.cu"} <= set(build.SOURCES)
    assert "atomicAdd(" not in (CSRC / "moe_gmm_bwd.cu").read_text()


@pytest.mark.parametrize("b,nc,g,hpg", [(2, 64, 1, 32), (2, 64, 1, 112), (1, 8, 1, 32), (1, 8, 1, 112),
                                         (1, 5, 1, 32), (2, 3, 2, 4), (1, 1, 1, 3), (4, 64, 1, 32)])
def test_grad_splits_deal_every_head_once(b, nc, g, hpg):
    """grad_splits' runs of contiguous heads cover a group once, none empty;
    at the train shapes (B = 2, T = 4096) it splits mamba2-370m's 32 and
    zamba2-7b's 112 heads in two, so that 256 blocks fill the card's 132 SMs
    at two blocks each."""
    n = tssd.grad_splits(b, nc, g, hpg, 132)
    per = -(-hpg // n)
    runs = [range(sp * per, min(hpg, (sp + 1) * per)) for sp in range(n)]
    assert 1 <= n <= hpg and all(len(r) > 0 for r in runs) and [h for r in runs for h in r] == list(range(hpg))
    if (b, nc) == (2, 64):
        assert n == 2 and nc * b * g * n <= tssd.GRAD_BLOCKS_PER_SM * 132


def test_single_bf16_roundings_keep_the_gradient_within_the_cards_limit():
    """Why the kernels round S_c, Z_c, L o (C B^T), L o M and the walks' w x
    and exp(cl) dy once to bf16 (no hi + lo pairs, unlike the forward's
    elementwise check): the gradients are held at 2e-2 of their max, and on
    unit-scale inputs (chip_smoke's recipe) the single roundings stay ~10x
    inside it."""
    gen = torch.Generator().manual_seed(28)
    b, t, h, g, p, n = 1, 192, 8, 1, 64, 128
    x = torch.randn(b, t, h, p, generator=gen).bfloat16().float()
    bm, cm = ((torch.randn(b, t, g, n, generator=gen) * 0.5).bfloat16().float() for _ in range(2))
    dt = torch.nn.functional.softplus(torch.randn(b, t, h, generator=gen))
    a_log, d_skip = torch.randn(h, generator=gen) * 0.3, torch.ones(h)
    dy = torch.randn(b, t, h, p, generator=gen).bfloat16().float()
    ds = torch.randn(b, h, p, n, generator=gen)
    ins = (x, bm, cm, dt, a_log, d_skip, dy, ds)
    want = ref.ssd_ref_bwd(*(v.double() for v in ins))
    for name, got, w in zip(NAMES, walk_backward(*ins, splits=2, bf16=True), want):
        assert float((got - w).abs().max()) <= GRAD_TOL / 5 * float(w.abs().max()), name


def test_single_bf16_roundings_hold_over_long_walks_at_a_slow_decay():
    """The same single roundings where a state reaches across many chunks
    (chip_smoke.py's "slow decay" cases: dt ~0.02, A_log ~ -2, a state
    keeps ~e^-0.2 of itself over a chunk), so that the gradients lean on
    the bf16 states of a walk of 16 chunks: still within the card's limit."""
    gen = torch.Generator().manual_seed(29)
    b, t, h, g, p, n = 1, 1024, 2, 1, 64, 128
    x = torch.randn(b, t, h, p, generator=gen).bfloat16().float()
    bm, cm = ((torch.randn(b, t, g, n, generator=gen) * 0.5).bfloat16().float() for _ in range(2))
    dt = torch.nn.functional.softplus(torch.randn(b, t, h, generator=gen) - 4.0)
    a_log, d_skip = torch.randn(h, generator=gen) * 0.3 - 2.0, torch.ones(h)
    dy = torch.randn(b, t, h, p, generator=gen).bfloat16().float()
    ins = (x, bm, cm, dt, a_log, d_skip, dy, None)
    want = ref.ssd_ref_bwd(*(v.double() if v is not None else None for v in ins))
    for name, got, w in zip(NAMES, walk_backward(*ins, splits=2, bf16=True), want):
        assert float((got - w).abs().max()) <= GRAD_TOL / 2 * float(w.abs().max()), name


@pytest.mark.parametrize("g,h,k", [(1, 6, 4), (2, 8, 2), (1, 4, 8)])
def test_chip_smokes_head_sliced_plain_backward_is_the_plain_backward(g, h, k):
    """chip_smoke.py checks K6's gradient at the train shapes against the
    plain backward run over slices of k of a group's heads in fp32
    (``ssd_plain_bwd_by_heads``: the per-head outputs put in place, dB and
    dC summed over the slices); here it equals the whole plain backward."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    x, bm, cm, dt, a_log, d_skip, dy, ds = inputs(2, 100, h, g, 8, 16, True, seed=h)
    ins = (x.bfloat16(), bm.bfloat16(), cm.bfloat16(), dt, a_log, d_skip)
    got = smoke.ssd_plain_bwd_by_heads(torch, tssd, ins, dy.bfloat16(), ds, k)
    want = ref.ssd_ref_bwd(*(v.float() for v in ins), dy.bfloat16().float(), ds)
    for name, a, w in zip(NAMES, got, want):
        assert a.dtype == torch.float32 and a.shape == w.shape, name
        assert float((a - w).abs().max()) <= TOL * float(w.abs().max()), name
