"""The chunk-parallel arithmetic of K6 on the CPU (no GPU needed).

``csrc/ssd_scan.cu`` cuts a sequence into chunks of 64 rows and gives them
to at most 8 ranks, each a contiguous run (rank r takes chunks
[r * n / R, (r + 1) * n / R) of n). A rank computes the carried state at
the start of its run itself, by the chunked state recurrence over every
chunk before it (x, B and dt only), then its own chunks' outputs, the state
passed chunk to chunk in order; the last rank's state at the end is the
final state. :func:`split_ssd` does the same in PyTorch float64 with the
kernel's chunk and rank layout, and is held against the port's plain version
and the JAX Pallas kernel in interpret mode at the SSD tolerance, 5e-4
(``tests/test_kernels.py``): the decomposition changes only the order of the
sums. The helpers live here, not in the package: the card runs the kernel,
the CPU the plain version.
"""
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)  # the suite runs several workers at once: leave them cores

import jax.numpy as jnp  # noqa: E402

from repro.kernels.ssd_scan import ssd_scan as jax_ssd_scan  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ssd_scan as tssd  # noqa: E402
from repro_torch.kernels.ref import ssd_ref  # noqa: E402
from repro_torch.models import ssm  # noqa: E402

SSD_TOL = dict(rtol=5e-4, atol=5e-4)  # tests/test_kernels.py
CHUNK = 64      # csrc/ssd_scan.cu: kQ
MAX_RANKS = 8   # csrc/ssd_scan.cu: kMaxRanks
SOURCE = Path(tssd.__file__).resolve().parent / "csrc" / "ssd_scan.cu"


def rank_runs(t: int) -> list[tuple[int, int]]:
    """The kernel's runs for T rows: rank r takes chunks [r * n / R, (r + 1)
    * n / R) of the n = ceil(T / 64), R = min(8, n)."""
    n = -(-t // CHUNK)
    ranks = min(MAX_RANKS, n)
    return [(r * n // ranks, (r + 1) * n // ranks) for r in range(ranks)]


def chunk_terms(x, bm, dt, a, c):
    """Chunk c of one (sequence, head): its rows, x (Q, P), B (Q, N), dt (Q,)
    and cum, the running sum of dt * a inside the chunk."""
    rows = slice(c * CHUNK, min((c + 1) * CHUNK, x.shape[0]))
    cum = torch.cumsum(dt[rows] * a, 0)
    return rows, x[rows], bm[rows], dt[rows], cum


def update(state, x, bm, dt, cum):
    """state' = exp(cum_Q) state + sum_j exp(cum_Q - cum_j) dt_j x_j B_j^T."""
    w = torch.exp(cum[-1] - cum) * dt
    return torch.exp(cum[-1]) * state + (x * w[:, None]).T @ bm


def split_ssd(x, bm, cm, dt, a_log, d_skip):
    """x: (B, T, H, P); bm/cm: (B, T, G, N); dt: (B, T, H); a_log, d_skip:
    (H,) -> y (B, T, H, P) and the final state (B, H, P, N), float64, by
    K6's ranks: each re-walks the state over the chunks before its run, then
    computes its run's outputs in order."""
    x, bm, cm, dt = (t.double() for t in (x, bm, cm, dt))
    b, t, h, p = x.shape
    g, n = bm.shape[2], bm.shape[3]
    y = torch.zeros(b, t, h, p, dtype=torch.float64)
    final = torch.zeros(b, h, p, n, dtype=torch.float64)
    runs = rank_runs(t)
    for bi in range(b):
        for hi in range(h):
            a = -float(np.exp(float(a_log[hi])))
            gi = hi // (h // g)
            xs, bs, cs, ds = x[bi, :, hi], bm[bi, :, gi], cm[bi, :, gi], dt[bi, :, hi]
            for r, (c_begin, c_end) in enumerate(runs):  # the ranks are independent
                state = torch.zeros(p, n, dtype=torch.float64)
                for c in range(c_end):
                    rows, xc, bc, dc, cum = chunk_terms(xs, bs, ds, a, c)
                    if c >= c_begin:  # one of the rank's own chunks: its outputs
                        q = len(dc)
                        causal = torch.ones(q, q, dtype=torch.bool).tril()
                        # L masked before exp: above the diagonal cum_i - cum_j > 0
                        li = torch.where(causal, cum[:, None] - cum[None, :], torch.full((q, q), -np.inf, dtype=torch.float64))
                        m = torch.exp(li) * dc[None, :] * (cs[rows] @ bc.T)
                        y[bi, rows, hi] = (m @ xc + torch.exp(cum)[:, None] * (cs[rows] @ state.T)
                                           + float(d_skip[hi]) * xc)
                    if c + 1 < c_end or r == len(runs) - 1:
                        state = update(state, xc, bc, dc, cum)
                if r == len(runs) - 1:
                    final[bi, hi] = state
    return y, final


def inputs(seed, b, t, h, g, p, n):
    """tests/test_kernels.py's SSD recipe from a numpy seed."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, t, h, p)).astype(np.float32)
    bm = (rng.standard_normal((b, t, g, n)) * 0.5).astype(np.float32)
    cm = (rng.standard_normal((b, t, g, n)) * 0.5).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, t, h)))).astype(np.float32)
    a_log = (rng.standard_normal(h) * 0.3).astype(np.float32)
    return x, bm, cm, dt, a_log, np.ones(h, np.float32)


def test_chunk_constants_match_the_kernel_source():
    src = SOURCE.read_text()
    assert re.search(r"constexpr int kQ = 64;", src)
    assert re.search(r"constexpr int kMaxRanks = 8;", src)
    assert "rank * nc / ranks" in src and "(rank + 1) * nc / ranks" in src  # contiguous runs
    assert "nc < kMaxRanks ? nc : kMaxRanks" in src                          # R = min(8, n)
    assert "if (c + 1 < c_end || last_rank)" in src  # the state moves on except after a non-last run
    assert "for (int c = 0; c < c_end; ++c)" in src  # every rank walks from chunk 0
    from repro_torch.kernels.build import SIGNATURES
    assert len(SIGNATURES["repro_ssd_scan_fwd"]) == 15  # x, bm, cm, dt, a_log, d_skip, y, state, 6 ints, stream


@pytest.mark.parametrize("t", [1, 37, 64, 65, 300, 512, 1100])
def test_rank_runs_cover_every_chunk_once(t):
    runs = rank_runs(t)
    n = -(-t // CHUNK)
    assert len(runs) == min(MAX_RANKS, n) and runs[0][0] == 0 and runs[-1][1] == n
    assert all(a[1] == b[0] for a, b in zip(runs, runs[1:]))  # contiguous, in rank order
    sizes = [c1 - c0 for c0, c1 in runs]
    assert min(sizes) >= 1 and max(sizes) - min(sizes) <= 1 and (n <= MAX_RANKS) == (max(sizes) == 1)


# (T, G, the Pallas kernel's chunk: it must divide T)
CASES = [(t, g, chunk) for g in (1, 2)
         for t, chunk in ((1, 1), (37, 37), (64, 64), (65, 65), (300, 100), (512, 256), (1100, 275))]


@pytest.mark.parametrize("t,g,chunk", CASES)
def test_split_matches_plain_and_pallas(t, g, chunk):
    x, bm, cm, dt, a_log, d_skip = inputs(t + g, 1, t, 4, g, 16, 8)
    args = [torch.from_numpy(v) for v in (x, bm, cm, dt, a_log, d_skip)]
    y, state = split_ssd(*args)
    want_y, want_state = ssd_ref(*args)
    np.testing.assert_allclose(y.numpy(), want_y.double().numpy(), **SSD_TOL)
    np.testing.assert_allclose(state.numpy(), want_state.double().numpy(), **SSD_TOL)
    pallas = jax_ssd_scan(*map(jnp.asarray, (x, bm, cm, dt, a_log, d_skip)), chunk=chunk, interpret=True)
    np.testing.assert_allclose(y.numpy(), np.asarray(pallas, np.float64), **SSD_TOL)


def test_wrapper_returns_the_state_on_cpu_and_meta():
    """``ssd_scan(..., return_state=True)``: the plain version's (y, state)
    on the CPU, empty tensors of the right shapes on meta."""
    args = [torch.from_numpy(v) for v in inputs(3, 1, 70, 4, 2, 16, 8)]
    args[0] = args[0].bfloat16()
    y, state = tssd.ssd_scan(*args, return_state=True)
    want_y, want_state = ssd_ref(*args)
    assert y.dtype == torch.bfloat16 and torch.equal(y, want_y.to(torch.bfloat16))
    assert torch.equal(state, want_state) and state.dtype == torch.float32
    my, ms = tssd.ssd_scan(*[a.to("meta") for a in args], return_state=True)
    assert my.device.type == ms.device.type == "meta"
    assert my.shape == (1, 70, 4, 16) and ms.shape == (1, 4, 16, 8) and ms.dtype == torch.float32


def test_ssd_chunked_on_meta_takes_the_kernel_route_for_the_state(monkeypatch):
    """The card path of ``ssd_chunked`` (meta tensors stand in for the card)
    asks K6 for y and the final state in one call: no second pass over x, B
    and dt for the state, no plain version."""
    calls = []

    def counted(*a, **kw):
        calls.append(kw.get("return_state"))
        return tssd.ssd_scan(*a, **kw)

    monkeypatch.setattr(ssm.kops, "ssd", counted)
    ops.reset_counts()
    arrays = [torch.from_numpy(v).to("meta") for v in inputs(7, 1, 300, 4, 1, 64, 128)]
    arrays[:3] = [a.to(torch.bfloat16) for a in arrays[:3]]
    y, state = ssm.ssd_chunked(*arrays, chunk=256)
    assert calls == [True]
    assert y.shape == (1, 300, 4, 64) and state.shape == (1, 4, 64, 128) and state.dtype == torch.float32
    assert not hasattr(ssm, "_final_state_only")  # the closed-form second pass is gone
    assert ops.counts()["ssd_scan"] == 0 and ops.counts()["ssd_ref"] == 0


# the kernel's rounding, emulated: L o (C B^T) and the state enter their
# products as a bf16 pair (hi + lo), w o x is rounded once, y once
def _bf(t):
    return t.to(torch.bfloat16).double()


def _pair(t):
    hi = _bf(t)
    return hi + _bf(t - hi)


def emulate(x, bm, cm, dt, a_log, d_skip, split: bool):
    """One sequence through the chunked recurrence with K6's bf16 roundings;
    ``split``: L o (C B^T) and the state as hi + lo pairs (the kernel), else
    each rounded once to bf16."""
    x, bm, cm, dt = (t.double() for t in (x, bm, cm, dt))
    _, t, h, p = x.shape
    g, n = bm.shape[2], bm.shape[3]
    y = torch.zeros(1, t, h, p, dtype=torch.float64)
    for hi in range(h):
        a = -float(np.exp(float(a_log[hi])))
        gi = hi // (h // g)
        state = torch.zeros(p, n, dtype=torch.float64)
        for c in range(-(-t // CHUNK)):
            rows, xc, bc, dc, cum = chunk_terms(x[0, :, hi], bm[0, :, gi], dt[0, :, hi], a, c)
            cc = cm[0, rows, gi]
            q = len(dc)
            li = torch.where(torch.ones(q, q, dtype=torch.bool).tril(), cum[:, None] - cum[None, :],
                             torch.full((q, q), -np.inf, dtype=torch.float64))
            m = torch.exp(li) * dc[None, :] * (cc @ bc.T)
            m, s = (_pair(m), _pair(state)) if split else (_bf(m), _bf(state))
            y[0, rows, hi] = _bf(m @ xc + torch.exp(cum)[:, None] * (cc @ s.T) + float(d_skip[hi]) * xc)
            w = torch.exp(cum[-1] - cum) * dc
            state = torch.exp(cum[-1]) * state + _bf(xc * w[:, None]).T @ bc
    return y


def test_split_products_keep_the_serve_case_within_the_bf16_tolerance():
    """Why K6 multiplies by L o (C B^T) and by the state as bf16 pairs: at
    mamba2-370m's serve shape on the card tests' unit-scale inputs
    (tests/test_torch_kernels_cuda.py, seed 31), one rounding of each to
    bf16 puts outputs beyond rtol = atol = 2e-2 of the plain version; the
    pairs keep every output inside it."""
    rng = np.random.default_rng(31)
    b, t, h, g, p, n = 1, 300, 32, 1, 64, 128
    x = torch.from_numpy(rng.standard_normal((b, t, h, p)).astype(np.float32)).to(torch.bfloat16)
    bm, cm = (torch.from_numpy((rng.standard_normal((b, t, g, n)) * 0.5).astype(np.float32)).to(torch.bfloat16)
              for _ in range(2))
    dt = torch.nn.functional.softplus(torch.from_numpy(rng.standard_normal((b, t, h)).astype(np.float32)))
    a_log = torch.from_numpy((rng.standard_normal(h) * 0.3).astype(np.float32))
    args = (x, bm, cm, dt, a_log, torch.ones(h))
    want = ssd_ref(*args)[0].double()

    def beyond(got):
        return int(((got - want).abs() > 2e-2 + 2e-2 * want.abs()).sum())

    assert beyond(emulate(*args, split=False)) > 0
    assert beyond(emulate(*args, split=True)) == 0
