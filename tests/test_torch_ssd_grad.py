"""The arithmetic of K6's gradient (``csrc/ssd_scan_bwd.cu``) walked on the
host: the first kernel's two walks over a sequence's chunks (the states
before each chunk, S_c, and the cotangents of the states after it, Z_c,
from the final state's dS back), then the second kernel's per-chunk terms
(the 64 x 64 products of an attention backward, the states' terms, the
per-row sums and their reverse cumulative sum for ddt, dA_log and dD summed
over every (b, chunk)), in float64, against the plain backward
(``kernels/ref.py: ssd_ref_bwd``) and ``jax.vjp`` of the reference's
``ssd_ref``. The kernel's bf16 roundings are not emulated: the card's
checks (``tests/test_torch_kernels_cuda.py``, ``chip_smoke.py``) hold it at
2e-2 of each gradient's max; here the algorithm is held at 1e-5 (the plain
backward's fp32 sums)."""
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


def walk_backward(x, bm, cm, dt, a_log, d_skip, dy, dstate=None, q=tssd.GRAD_CHUNK):
    """(dx, dbm, dcm, ddt, da_log, dd_skip) by the kernels' decomposition,
    in float64; rows past T zero-padded as the kernels zero-fill them."""
    x, bm, cm, dt, dy = (v.double() for v in (x, bm, cm, dt, dy))
    b, t, h, p = x.shape
    g, n = bm.shape[2], bm.shape[3]
    hpg = h // g
    a = -torch.exp(a_log.double())
    nc = -(-t // q)
    pad = nc * q - t

    def padded(v):
        return torch.cat([v, v.new_zeros(v.shape[0], pad, *v.shape[2:])], 1)

    x, bm, cm, dt, dy = map(padded, (x, bm, cm, dt, dy))

    def chunk(v, c):
        return v[:, c * q:(c + 1) * q]

    # kernel 1: the walks
    s_before = torch.zeros(b, h, nc, p, n, dtype=torch.float64)
    z_after = torch.zeros_like(s_before)
    st = torch.zeros(b, h, p, n, dtype=torch.float64)
    for c in range(nc):
        s_before[:, :, c] = st
        cl = torch.cumsum(chunk(dt, c) * a, 1)
        w = torch.exp(cl[:, -1:] - cl) * chunk(dt, c)
        bh = torch.repeat_interleave(chunk(bm, c), hpg, 2)
        update = torch.einsum("bjhp,bjhn->bhpn", chunk(x, c) * w[..., None], bh)
        st = torch.exp(cl[:, -1])[..., None, None] * st + update
    z = torch.zeros(b, h, p, n, dtype=torch.float64) if dstate is None else dstate.double()
    for c in reversed(range(nc)):
        z_after[:, :, c] = z
        cl = torch.cumsum(chunk(dt, c) * a, 1)
        ch = torch.repeat_interleave(chunk(cm, c), hpg, 2)
        update = torch.einsum("bkhp,bkhn->bhpn", chunk(dy, c) * torch.exp(cl)[..., None], ch)
        z = torch.exp(cl[:, -1])[..., None, None] * z + update

    # kernel 2: each (chunk, b, group), its heads in order
    dx, dbm, dcm, ddt = (torch.zeros_like(v) for v in (x, bm, cm, dt))
    da, dd = torch.zeros(h, dtype=torch.float64), torch.zeros(h, dtype=torch.float64)
    causal = torch.ones(q, q, dtype=torch.bool).tril()
    for c in range(nc):
        rows = slice(c * q, (c + 1) * q)
        for bi in range(b):
            for hh in range(h):
                gi = hh // hpg
                X, DY = x[bi, rows, hh], dy[bi, rows, hh]
                B, C, DT = bm[bi, rows, gi], cm[bi, rows, gi], dt[bi, rows, hh]
                S, Z = s_before[bi, hh, c], z_after[bi, hh, c]
                cl = torch.cumsum(DT * a[hh], 0)
                E = torch.exp((cl[:, None] - cl[None, :]).clamp(max=0)) * causal
                L = E * DT[None, :]
                CB, M = C @ B.T, DY @ X.T
                W1, W2 = L * CB, L * M
                A = W2 * CB
                # phase 1 (rows i): dC, e
                dys = DY @ S
                e = torch.exp(cl) * (C * dys).sum(1)
                dcm[bi, rows, gi] += torch.exp(cl)[:, None] * dys + W2 @ B
                # phase 2 (rows j): dx, dB, q, s
                zb = B @ Z.T
                qj = (X * zb).sum(1)
                f = torch.exp(cl[-1] - cl)
                wj = f * DT
                s = wj * qj
                dx[bi, rows, hh] = wj[:, None] * zb + W1.T @ DY + d_skip[hh].double() * DY
                dbm[bi, rows, gi] += wj[:, None] * (X @ Z) + W2.T @ C
                # phase 3: dcl, its reverse cumulative sum, ddt, the partials
                dcl = A.sum(1) - A.sum(0) + e - s
                dcl[-1] += torch.exp(cl[-1]) * (Z * S).sum() + s.sum()
                r = torch.flip(torch.cumsum(torch.flip(dcl, [0]), 0), [0])
                ddt[bi, rows, hh] = (E * CB * M).sum(0) + f * qj + a[hh] * r
                da[hh] += (DT * r).sum()
                dd[hh] += (DY * X).sum()
    return dx[:, :t], dbm[:, :t], dcm[:, :t], ddt[:, :t], a * da, dd


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
])
def test_walk_matches_the_plain_backward(b, t, h, g, p, n, with_state):
    ins = inputs(b, t, h, g, p, n, with_state, seed=t)
    got = walk_backward(*ins)
    want = ref.ssd_ref_bwd(*(v.double() if v is not None else None for v in ins))
    for name, x, w in zip(NAMES, got, want):
        assert x.shape == w.shape, name
        assert float((x - w).abs().max()) <= TOL * float(w.abs().max()), name


def test_walk_matches_jax_vjp():
    ins = inputs(1, 100, 4, 2, 8, 8, True, seed=5)
    _, vjp = jax.vjp(jax_ref.ssd_ref, *(jnp.asarray(v.numpy()) for v in ins[:6]))
    want = vjp((jnp.asarray(ins[6].numpy()), jnp.asarray(ins[7].numpy())))
    for name, x, w in zip(NAMES, walk_backward(*ins), want):
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
