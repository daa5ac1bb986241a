"""K3's gradient as the card computes it, on the CPU (no GPU needed).

``csrc/flash_attention_bwd.cu`` runs three kernels: prep (D = rowsum(dO * o)
with o the forward's fp32 output, and lse * log2 e, padded to whole query
tiles), the sweep (one block per
(b, kv head, split of the group's query heads, 128-row kv tile), the kv tile
the slowest grid index; each block walks its query tiles from the last
down, computes S^T, dP^T, P^T, dS^T, dV, dK and the tile's dQ contribution,
and adds that contribution to an fp32 accumulator in kv-tile order), and
post (dq from the accumulator; a split's dk and dv summed in split order).
:func:`sweep_gradient` does the same walk in PyTorch fp32 with the kernel's
tile sizes, head split, padding and masks, and is held against the port's
plain version ``mha_ref_bwd`` and ``jax.grad`` through the JAX package's
attention at the fp32 tolerance, 2e-5 (the walk changes only the order of
the sums), and with the kernel's bf16 roundings of P and dS against
``mha_ref_bwd`` at the card tests' 2e-2. Also here: the wrapper's split
count and workspace size, which a CPU test can check, and its refusals
before any build. The walk lives here, not in the package: the card runs
the kernels, the CPU the plain version.
"""
import math
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)  # the suite runs several workers at once: leave them cores

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jax_ops  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import flash_attention as tflash  # noqa: E402
from repro_torch.kernels.ref import mha_ref, mha_ref_bwd  # noqa: E402

FP32_TOL = 2e-5  # of each gradient's max: fp32, sums in another order
GRAD_TOL = 2e-2  # chip_smoke.py's GRAD_TOL: bf16 roundings of P and dS
SMS = 132        # an H100's streaming multiprocessors
CSRC = Path(tflash.__file__).resolve().parent / "csrc" / "flash_attention_bwd.cu"
LOG2E = 1.4426950408889634


def lse_of(q, k, causal):
    """The forward's row logsumexp (B, H, T), fp32."""
    b, t, h, hd = q.shape
    s, kv = k.shape[1], k.shape[2]
    kx = k.float().repeat_interleave(h // kv, dim=2)
    scores = torch.einsum("bthd,bshd->bhts", q.float(), kx) / math.sqrt(hd)
    if causal:
        scores = scores.masked_fill(torch.arange(s)[None, :] > torch.arange(t)[:, None], float("-inf"))
    return torch.logsumexp(scores, dim=-1)


def bf16(x):
    return x.to(torch.bfloat16).float()


def sweep_gradient(q, k, v, o, do, lse, causal, sms=SMS, round_bf16=False):
    """(dq, dk, dv) by the kernels' walk, in fp32; ``round_bf16`` rounds P
    and dS to bf16 before the products that take them, as the kernel does.
    Also returns, per (b, h, query tile), the kv tiles in the order their dQ
    contributions were added."""
    b, t, h, hd = q.shape
    s, kv = k.shape[1], k.shape[2]
    g = h // kv
    km, kn = tflash.GRAD_QUERY_ROWS[hd], tflash.GRAD_KV_ROWS
    nq, nkv = -(-t // km), -(-s // kn)
    splits = tflash.grad_splits(b, s, kv, g, sms)
    hps = -(-g // splits)
    scale = 1.0 / math.sqrt(hd)
    rnd = bf16 if round_bf16 else (lambda x: x)
    # prep: D and lse * log2 e over whole query tiles; a padded row has D = 0, lse = +inf
    dsum = torch.zeros(b, h, nq * km)
    dsum[..., :t] = (do.float() * o.float()).sum(-1).permute(0, 2, 1)
    lse2 = torch.full((b, h, nq * km), float("inf"))
    lse2[..., :t] = lse * LOG2E
    pad = lambda x, n: torch.cat([x.float(), x.new_zeros(x.shape[0], n - x.shape[1], *x.shape[2:]).float()], 1)  # noqa: E731
    qp, dop, kp, vp = pad(q, nq * km), pad(do, nq * km), pad(k, nkv * kn), pad(v, nkv * kn)
    dq_acc = torch.zeros(b, h, nq * km, hd)
    order = {}
    dk_part = torch.zeros(splits, b, nkv * kn, kv, hd)
    dv_part = torch.zeros_like(dk_part)
    kv_row = torch.arange(kn)[:, None]
    q_col = torch.arange(km)[None, :]
    for j in range(nkv):  # the grid's slowest index: the longest causal tiles first
        kr = slice(j * kn, (j + 1) * kn)
        qt_first = j * kn // km if causal else 0
        for sp in range(splits):
            for kvh in range(kv):
                heads = range(kvh * g + sp * hps, kvh * g + min(g, (sp + 1) * hps))
                for bb in range(b):
                    kt, vt = kp[bb, kr, kvh], vp[bb, kr, kvh]
                    dk_acc, dv_acc = torch.zeros(kn, hd), torch.zeros(kn, hd)
                    for qt in range(nq - 1, qt_first - 1, -1):  # the last query tile first
                        rows = slice(qt * km, (qt + 1) * km)
                        for hh in heads:
                            qq, dd = qp[bb, rows, hh], dop[bb, rows, hh]
                            x = (kt @ qq.T) * (scale * LOG2E) - lse2[bb, hh, rows][None, :]
                            if causal:
                                x = x.masked_fill(qt * km + q_col < j * kn + kv_row, float("-inf"))
                            p = rnd(torch.exp2(x))
                            ds = rnd(p * (vt @ dd.T - dsum[bb, hh, rows][None, :]))
                            dv_acc += p @ dd
                            dk_acc += ds @ qq
                            order.setdefault((bb, hh, qt), []).append(j)
                            dq_acc[bb, hh, rows] += ds.T @ kt
                    dk_part[sp, bb, kr, kvh] = dk_acc * scale
                    dv_part[sp, bb, kr, kvh] = dv_acc
    # post
    dq = (dq_acc[:, :, :t] * scale).permute(0, 2, 1, 3)
    dk = sum(dk_part[sp] for sp in range(splits))[:, :s]
    dv = sum(dv_part[sp] for sp in range(splits))[:, :s]
    return (dq, dk, dv), order


def within(got, want, tol, name):
    err = float((got.float() - want.float()).abs().max())
    assert err <= tol * float(want.float().abs().max()) + 1e-6, (name, err, float(want.abs().max()))


CASES = [  # b, t, s, h, kv, hd, causal
    (1, 300, 300, 8, 2, 64, True),    # head split (4 heads a group), ragged T
    (1, 200, 200, 6, 1, 128, True),   # granite's shape at a small size: one kv head, every head split
    (2, 130, 130, 4, 4, 112, False),  # MHA at 112 (run as 128), two batch rows
    (1, 150, 400, 4, 2, 128, True),   # T < S causal: kv tiles no query row sees
    (1, 400, 150, 4, 2, 64, True),    # T > S causal
    (1, 100, 260, 8, 2, 64, False),   # T != S non-causal
]


@pytest.mark.parametrize("b,t,s,h,kv,hd,causal", CASES)
def test_sweep_walk_matches_the_plain_gradient_and_jax(b, t, s, h, kv, hd, causal):
    rng = np.random.default_rng(7)
    qn, kn_, vn, dn = (rng.standard_normal(sh).astype(np.float32)
                       for sh in ((b, t, h, hd), (b, s, kv, hd), (b, s, kv, hd), (b, t, h, hd)))
    q, k, v, do = (torch.from_numpy(x) for x in (qn, kn_, vn, dn))
    o = mha_ref(q, k, v, causal=causal)
    (dq, dk, dv), order = sweep_gradient(q, k, v, o, do, lse_of(q, k, causal), causal)
    want = mha_ref_bwd(q, k, v, do, causal=causal)

    def jloss(q, k, v):
        return jnp.sum(jax_ops.attention(q, k, v, causal=causal) * dn)

    jwant = jax.grad(jloss, argnums=(0, 1, 2))(*(jnp.asarray(x) for x in (qn, kn_, vn)))
    for name, got, w, jw in zip(("dq", "dk", "dv"), (dq, dk, dv), want, jwant):
        within(got, w, FP32_TOL, name)
        within(got, torch.from_numpy(np.array(jw)), FP32_TOL, name)
    # the dQ counters' contract: the kv tiles that add to a query tile are
    # 0, 1, ..., n - 1, so tile 0 stores and tile j waits for j additions
    assert all(seq == list(range(len(seq))) for seq in order.values())
    km = tflash.GRAD_QUERY_ROWS[hd]
    assert {qt for (_, _, qt) in order} == set(range(-(-t // km)))  # every query tile is stored


@pytest.mark.parametrize("b,t,s,h,kv,hd,causal", CASES[:3])
def test_sweep_walk_with_the_kernels_bf16_roundings_stays_within_the_card_tolerance(b, t, s, h, kv, hd, causal):
    rng = np.random.default_rng(8)
    q, k, v, do = (torch.from_numpy(rng.standard_normal(sh).astype(np.float32)).to(torch.bfloat16)
                   for sh in ((b, t, h, hd), (b, s, kv, hd), (b, s, kv, hd), (b, t, h, hd)))
    o = mha_ref(q.float(), k.float(), v.float(), causal=causal)  # the forward's fp32 output
    got, _ = sweep_gradient(q, k, v, o, do, lse_of(q, k, causal), causal, round_bf16=True)
    for name, g, w in zip(("dq", "dk", "dv"), got, mha_ref_bwd(q, k, v, do, causal=causal)):
        within(bf16(g), w, GRAD_TOL, name)


def test_d_from_the_fp32_output_keeps_dq_and_dk_where_the_rows_of_v_share_a_component():
    """Why prep takes D = rowsum(dO * o) from the forward's fp32 output and
    not its bf16 rounding. Where the rows of V share a large common
    component (the enc-dec's cross-attention over the encoder's
    un-normalized states: 94-96 % of their energy is common to every
    position in a random model), dS = P (dP - D) cancels, and D's rounding
    error (2^-9 of |o|) becomes most of dS. The walk with the kernel's
    roundings stays within the card tolerance of ``mha_ref_bwd`` with the
    fp32 output, and leaves it by far with the bf16 one."""
    b, t, h, kv, hd = 1, 256, 4, 2, 64
    rng = np.random.default_rng(11)
    q, k, do = (torch.from_numpy(rng.standard_normal(sh).astype(np.float32)).to(torch.bfloat16)
                for sh in ((b, t, h, hd), (b, t, kv, hd), (b, t, h, hd)))
    common = rng.standard_normal((1, 1, kv, hd)) * 10.0
    v = torch.from_numpy((common + 0.1 * rng.standard_normal((b, t, kv, hd))).astype(np.float32)).to(torch.bfloat16)
    want = mha_ref_bwd(q, k, v, do, causal=False)
    lse = lse_of(q, k, False)
    errs = {}
    for label, o in (("fp32", mha_ref(q.float(), k.float(), v.float(), causal=False)),
                     ("bf16", mha_ref(q, k, v, causal=False))):
        got, _ = sweep_gradient(q, k, v, o, do, lse, False, round_bf16=True)
        errs[label] = {n: float((bf16(g) - w).abs().max() / w.abs().max()) for n, g, w in zip(("dq", "dk"), got, want)}
    assert max(errs["fp32"].values()) <= GRAD_TOL, errs
    assert min(errs["bf16"].values()) > 5 * GRAD_TOL, errs


@pytest.mark.parametrize("b,s,kv,group,sms,want", [
    (2, 4096, 8, 4, 132, 1),    # the train shape: 512 blocks fill the card
    (1, 512, 1, 48, 132, 24),   # granite-34b's 48/1: 4 blocks, 2 heads a split
    (2, 512, 1, 48, 132, 16),   # at B = 2: 8 blocks, 3 heads a split
    (1, 512, 8, 8, 132, 4),     # chameleon-34b's 64/8: 32 blocks, 2 heads a split
    (1, 300, 8, 4, 132, 4),     # T = 300, 32/8: 24 blocks, one head a split
    (1, 512, 32, 1, 132, 1),    # MHA: nothing to split
    (1, 1000, 2, 8, 132, 8),    # 16 blocks
    (1, 128, 1, 3, 132, 3),
    (4, 4096, 8, 4, 132, 1),
    (1, 512, 1, 48, 8, 2),      # a small card: 4 blocks, 2 splits of 24 heads
])
def test_grad_splits_table(b, s, kv, group, sms, want):
    n = tflash.grad_splits(b, s, kv, group, sms)
    assert n == want
    per = -(-group // n)
    assert (n - 1) * per < group <= n * per  # no split is empty


def test_grad_splits_never_split_a_grid_that_fills_the_card():
    for b in (1, 2, 4):
        for kv in (1, 2, 4, 8, 32):
            for s in (1, 127, 128, 129, 300, 512, 1000, 4096, 16384):
                for group in (1, 2, 4, 8, 16, 48):
                    blocks = b * kv * -(-s // 128)
                    n = tflash.grad_splits(b, s, kv, group, SMS)
                    assert 1 <= n <= group
                    if blocks >= SMS:
                        assert n == 1
                    elif group > 1:  # a grid short of the card splits
                        assert n > 1


def test_grad_workspace_numel():
    assert tflash.grad_workspace_numel(2, 4096, 8, 64, 1) == 0
    # 2 (dk, dv) x 24 splits x B 1 x KV 1 x 512 rows x 128 columns
    assert tflash.grad_workspace_numel(1, 512, 1, 128, 24) == 2 * 24 * 512 * 128
    # S rounded up to the 128-row kv tile; head dim 112 held as 128, 64 as 64
    assert tflash.grad_workspace_numel(1, 300, 2, 112, 3) == 2 * 3 * 2 * 384 * 128
    assert tflash.grad_workspace_numel(2, 300, 8, 64, 4) == 2 * 4 * 2 * 8 * 384 * 64


def test_wrapper_constants_match_the_kernel_source():
    src = CSRC.read_text()
    assert "return D <= 64 ? 128 : 64;" in src  # query_rows<D>()
    assert tflash.GRAD_QUERY_ROWS == {64: 128, 112: 64, 128: 64}
    assert re.search(r"constexpr int kN = (\d+);", src).group(1) == str(tflash.GRAD_KV_ROWS)
    assert "constexpr int kDqTile = 2 * 64 * 64;" in src and tflash.GRAD_DQ_TILE == 2 * 64 * 64
    assert "wgmma_tma.cuh" in build.HEADERS and '#include "wgmma_tma.cuh"' in src


@pytest.fixture
def no_build(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("the kernel library was built or loaded")

    monkeypatch.setattr(build, "load", refuse)
    monkeypatch.setattr(build, "build", refuse)


def _grad_args(hd=64, t=70, h=4, kv=2):
    """(q, k, v, the fp32 output, lse, dout) on the host."""
    q = torch.zeros(1, t, h, hd, dtype=torch.bfloat16)
    k = torch.zeros(1, t, kv, hd, dtype=torch.bfloat16)
    return q, k, k.clone(), q.float(), torch.zeros(1, h, t), q.clone()


def test_backward_refuses_an_unsupported_head_dim_before_any_build(no_build):
    q, k, v, out, lse, dout = _grad_args(hd=96)
    with pytest.raises(ValueError, match="head dim"):
        tflash.backward(q, k, v, out, lse, dout, True)


def test_backward_refuses_a_non_contiguous_lse_before_any_build(no_build):
    q, k, v, out, lse, dout = _grad_args()
    with pytest.raises(ValueError, match="lse"):
        tflash.backward(q, k, v, out, torch.zeros(1, 70, 4).transpose(1, 2), dout, True)
    with pytest.raises(ValueError, match="lse"):
        tflash.backward(q, k, v, out, lse.double(), dout, True)


def test_backward_refuses_host_tensors_before_any_build(no_build):
    with pytest.raises(ValueError, match="card"):
        tflash.backward(*_grad_args(), True)
