"""The port's cost analysis (``repro_torch.launch.cost_analysis``) and its
kernel formulas (``repro_torch.kernels.cost``), the counterpart of
``tests/test_hlo_analysis.py``: FLOPs of a known program, loop scaling, the
formulas against ``FlopCounterMode``'s count of the plain versions, the peak
tracker on synthetic programs, and every served family's shape-only step on
meta tensors (the card's branch without a launch) against the same step on
the CPU (the plain versions)."""
import dataclasses
import math

import pytest

torch = pytest.importorskip("torch")

from torch.utils._python_dispatch import _disable_current_modes  # noqa: E402
from torch.utils.checkpoint import checkpoint  # noqa: E402
from torch.utils.flop_counter import FlopCounterMode  # noqa: E402

from repro_torch import donate, tree  # noqa: E402
from repro_torch.configs import get_arch, reduced_config  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.kernels import build, ref  # noqa: E402
from repro_torch.kernels import cost as kc  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import moe_gmm as gm  # noqa: E402
from repro_torch.kernels import ops as kops  # noqa: E402
from repro_torch.kernels import ssd_scan as sd  # noqa: E402
from repro_torch.launch.cost_analysis import CostAnalysis, analyze  # noqa: E402
from repro_torch.models import ssm as ssm_mod  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.models.params import init_params, param_structs  # noqa: E402
from repro_torch.optim import adamw_state_defs  # noqa: E402
from repro_torch.training.train_step import init_train_state, make_train_step, value_and_grad  # noqa: E402

L, B, D = 12, 64, 128  # tests/test_hlo_analysis.py's program


def chain(x, ws):
    for w in ws.unbind(0):
        x = torch.tanh(x @ w)
    return x.sum()


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_loop_flops_match_analytic(device):
    """test_hlo_analysis.py::test_loop_scaled_flops_match_analytic on one
    device: 12 products of 64 x 128 x 128, exactly."""
    x, ws = torch.randn(B, D, device=device), torch.randn(L, D, D, device=device)
    s = analyze(chain, x, ws)
    assert s.flops == s.aten_flops == 12 * 2 * 64 * 128 * 128
    assert s.collective_bytes == 0.0 and s.kernel_calls == {}
    # each product reads its operands and writes its result once (fp32)
    assert s.bytes == 12 * 4 * (B * D + D * D + B * D)
    assert s.top_traffic[0]["op"] == "aten.mm" and s.top_traffic[0]["calls"] == 12


def micro_chain(x, ws, n: int = 2):
    acc = torch.zeros(D, D, device=x.device)
    for _ in kc.trips(n, "microbatches", like=x):
        h = chain(x, ws) * x
        acc.add_(h.T @ h)
        del h  # as the train step frees a microbatch's gradients before the next
    return acc


def test_scaled_microbatches_equal_a_direct_run():
    """test_hlo_analysis.py::test_while_trip_count_detected: the trip count
    is seen, and one iteration on meta counted twice equals both run on the
    CPU (where the loop always runs whole)."""
    x, ws = torch.randn(B, D, device="meta"), torch.randn(L, D, D, device="meta")
    scaled = analyze(micro_chain, x, ws)
    direct = analyze(micro_chain, torch.randn(B, D), torch.randn(L, D, D))
    assert scaled.loop_trips == {"microbatches": 2} and direct.loop_trips == {}
    assert scaled.flops == direct.flops == 2 * (12 * 2 * B * D * D + 2 * D * B * D)
    assert scaled.bytes == direct.bytes
    assert scaled.peak_bytes == direct.peak_bytes


def test_loops_scale_only_on_meta_and_only_in_the_analysing_thread():
    """A loop runs whole on a device under an analysis, and whole on meta in
    a thread the analysis does not own; a kernel that another thread calls
    meanwhile is not counted."""
    import threading

    meta, cpu = torch.empty(1, device="meta"), torch.empty(1)
    seen = {}

    def other():
        seen["meta"] = list(kc.trips(3, "x", like=meta))
        q = torch.empty(1, 8, 64, device="meta")
        kv = torch.empty(1, 16, 8, 64, device="meta")
        kops.decode_attention(q, kv, kv, torch.empty(1, dtype=torch.int32, device="meta"))

    mode = CostAnalysis()
    with mode:
        assert list(kc.trips(3, "x", like=cpu)) == [0, 1, 2]
        assert list(kc.trips(3, "x", like=meta)) == [0]
        th = threading.Thread(target=other)
        th.start()
        th.join()
    assert seen["meta"] == [0, 1, 2]
    s = mode.summary()
    assert s.loop_trips == {"x": 3} and s.kernel_calls == {}
    assert list(kc.trips(3, "x", like=meta)) == [0, 1, 2]  # no analysis open


# ------------------------------------------------------------ formulas


def counted(fn, *args, **kwargs) -> int:
    with FlopCounterMode(display=False) as fc:
        fn(*args, **kwargs)
    return fc.get_total_flops()


def randn(*shape, dtype=torch.bfloat16):
    return torch.randn(*shape).to(dtype)


@pytest.mark.parametrize("b,t,s,h,kv,hd", [(1, 37, 37, 4, 2, 64), (2, 16, 40, 8, 1, 128)])
def test_flash_formula_is_the_plain_products(b, t, s, h, kv, hd):
    """K3 non-causal: QK^T and PV, what mha_ref computes. Causal, the plain
    version still forms every (row, column) score and masks it; the kernel
    skips the masked tiles, and the formula counts half. The gradient: the
    kernel's five products (QK^T again, dP, dV, dQ, dK), where the plain
    backward, autograd through the forward in fp32, recomputes PV too: six."""
    q, k, v = randn(b, t, h, hd), randn(b, s, kv, hd), randn(b, s, kv, hd)
    plain = counted(fa.plain, q, k, v, causal=False)
    assert kc.flash_attention(b, t, s, h, kv, hd, causal=False).flops == plain
    assert kc.flash_attention(b, t, s, h, kv, hd, causal=True).flops == plain / 2
    plain_bwd = counted(fa.plain_bwd, q, k, v, randn(b, t, h, hd), causal=False)
    assert kc.flash_attention_grad(b, t, s, h, kv, hd, causal=False).flops == plain_bwd * 5 / 6
    assert kc.flash_attention_grad(b, t, s, h, kv, hd, causal=True).flops == plain_bwd * 5 / 12


@pytest.mark.parametrize("b,s,h,kv,hd", [(1, 300, 32, 8, 64), (3, 64, 48, 1, 128)])
def test_decode_formulas_are_the_plain_products(b, s, h, kv, hd):
    """K4 and K1 at cur_len = S: every row's score and value, what the plain
    versions compute (K1's gathers its pages into K4's layout first)."""
    q = randn(b, h, hd)
    k, v = randn(b, s, kv, hd), randn(b, s, kv, hd)
    full = torch.full((b,), s, dtype=torch.int32)
    assert kc.decode_attention(b, s, h, kv, hd).flops == counted(ref.decode_attn_ref, q, k, v, full)
    page = 16
    n = -(-s // page)
    kp, vp = randn(b * n + 1, page, kv, hd), randn(b * n + 1, page, kv, hd)
    table = torch.arange(1, b * n + 1, dtype=torch.int32).view(b, n)
    cur = torch.full((b,), n * page, dtype=torch.int32)
    assert kc.paged_decode_attention(b, n, page, h, kv, hd).flops == counted(
        ref.paged_decode_attn_ref, q, kp, vp, table, cur)
    # the data's own rows, where given (chip_smoke's bounds)
    assert kc.decode_attention(b, s, h, kv, hd, rows=7).flops == 4 * h * hd * 7


@pytest.mark.parametrize("e,c,d,f", [(4, 8, 64, 32), (8, 24, 32, 64)])
def test_moe_formulas_are_the_plain_products(e, c, d, f):
    """K5 over every row (and its gradient: dy w^T and xe^T dy)."""
    xe, w, dy = randn(e, c, d), randn(e, d, f), randn(e, c, f)
    assert kc.moe_gmm(e, c, d, f).flops == counted(gm.plain, xe, w)
    assert kc.moe_gmm_grad(e, c, d, f).flops == counted(gm.plain_bwd, xe, w, None, dy)


@pytest.mark.parametrize("t", [37, 64])
def test_ssd_formula_against_the_plain_dual_form(t):
    """K6 in one chunk (T <= 64), a group per head: the plain version is
    the whole dual form (C B^T, its weights times x, the final state), the
    kernel's chunk adds the carried state's term of y, 2 B H T P N, which is
    zero for the first chunk and which the plain version does not form."""
    b, h, p, n = 2, 4, 64, 64
    x, bm, cm = randn(b, t, h, p), randn(b, t, h, n), randn(b, t, h, n)
    dt, a_log, d_skip = torch.rand(b, t, h), torch.randn(h), torch.ones(h)
    plain = counted(sd.plain, x, bm, cm, dt, a_log, d_skip)
    assert kc.ssd_scan(b, t, h, h, p, n).flops == plain + 2 * b * h * t * p * n


def test_bounds_are_the_smoke_runs_formulas():
    """The formulas chip_smoke.py's bounds take from kernels/cost.py, written
    out as that script wrote them before they moved (so its Bound ms stay)."""
    for t, h, kv, hd, causal in ((300, 32, 8, 64, True), (1024, 32, 8, 64, True), (300, 16, 16, 64, False)):
        got = kc.flash_attention(1, t, t, h, kv, hd, causal)
        n = t * h * hd
        assert (got.flops, got.bytes) == (4 * h * t * t * hd / (2 if causal else 1), 2 * (n + 2 * t * kv * hd + n))
    for b, t, h, kv, hd, causal in ((2, 4096, 32, 8, 64, True), (1, 300, 48, 1, 128, False)):
        got = kc.flash_attention_grad(b, t, t, h, kv, hd, causal)
        q, k = b * t * h * hd, b * t * kv * hd
        assert got.flops == 5 * 2 * b * h * t * t * hd * (0.5 if causal else 1.0)
        assert got.bytes == 2 * (2 * q + 2 * k + 2 * k + q) + 4 * (q + b * h * t)
    got = kc.decode_attention(4, 512, 32, 8, 64, rows=1000)
    assert (got.flops, got.bytes) == (4 * 32 * 64 * 1000, 2 * (2 * 1000 * 8 * 64 + 2 * 4 * 32 * 64))
    got = kc.paged_chunk_attention(1, 64, 32, 16, 32, 8, 64, start=192)
    pairs = 64 * 192 + 64 * 65 // 2
    assert (got.flops, got.bytes) == (4 * 32 * 64 * pairs, 2 * (2 * 64 * 32 * 64 + 2 * 256 * 8 * 64) + 4 * 33)
    got = kc.moe_gmm(128, 8, 2048, 768, rows=8, active=8)
    assert (got.flops, got.bytes) == (2 * 8 * 2048 * 768, 2 * (8 * 2048 + 8 * 2048 * 768 + 128 * 8 * 768))
    chunks = [64] * 4 + [44]
    got = kc.ssd_scan(1, 300, 32, 1, 64, 128)
    assert got.flops == 32 * sum(2 * q * q * 128 + 2 * q * q * 64 + 4 * q * 128 * 64 for q in chunks)


# ------------------------------------------------------------------ peak

N = 1024  # fp32 values of one synthetic tensor: 4N bytes


def tracked(fn, *args, grad: bool = False):
    """(peak, the live bytes ``fn`` reports back) of ``fn(mode, *args)``."""
    mode = CostAnalysis(args)
    with torch.set_grad_enabled(grad), mode:
        out = fn(mode, *args)
    return mode.summary().peak_bytes, out


def test_peak_counts_each_storage_once_and_frees_at_del():
    def prog(mode, a):
        b = a * 2          # 8N
        c = b + 1          # 12N
        del b              # 8N
        d = c * c          # 12N
        del c              # 8N
        e = torch.cat([d, d])  # 16N
        return mode.live_bytes, e

    peak, (live, _) = tracked(prog, torch.empty(N, device="meta"))
    assert peak == 16 * N and live == 16 * N


def test_peak_views_and_in_place_ops_add_nothing():
    def prog(mode, a):
        v = a.view(32, -1)
        v.add_(1)
        u = v.t()[::2]
        u.mul_(2)
        w = a[: N // 2].clone()  # 6N
        w.mul_(3)
        return mode.live_bytes

    peak, live = tracked(prog, torch.empty(N, device="meta"))
    assert peak == live == 6 * N


@pytest.mark.parametrize("grad", [False, True])
def test_peak_saved_tensors_stay_live(grad):
    """``del`` frees a tensor autograd did not save; a saved one stays."""
    def prog(mode, a):
        b = a.sin()
        c = b.sin()  # saves b under grad
        del b
        return mode.live_bytes, c

    a = torch.empty(N, device="meta", requires_grad=grad)
    _, (live, _) = tracked(prog, a, grad=grad)
    assert live == (12 if grad else 8) * N


def test_peak_checkpoint_drops_and_recomputes():
    """Under a non-reentrant checkpoint the block's intermediate is not
    saved (the forward leaves the input and output live) and is made again
    in the backward."""
    def block(x):
        return x.sin().sin()

    def prog(mode, a, remat):
        out = checkpoint(block, a, use_reentrant=False) if remat else block(a)
        live = mode.live_bytes
        out.sum().backward()
        return live

    for remat, after in ((True, 8 * N), (False, 12 * N)):
        a = torch.empty(N, device="meta", requires_grad=True)
        mode = CostAnalysis(a)
        with mode:
            live = prog(mode, a, remat)
        assert live == after
        assert mode.summary().peak_bytes >= 12 * N  # the intermediate lives once either way


def test_peak_adds_a_meta_kernels_workspace():
    """K3's gradient on meta allocates dq, dk, dv and launches nothing; its
    workspace (the fp32 dQ accumulator, D, lse * log2 e, the counters) is
    added at the call, from kernels/cost.py."""
    b, t, h, kv, hd = 1, 300, 8, 2, 64
    meta = lambda *s, dt=torch.bfloat16: torch.empty(*s, dtype=dt, device="meta")  # noqa: E731
    q, k, v = meta(b, t, h, hd), meta(b, t, kv, hd), meta(b, t, kv, hd)
    out32, lse, dout = meta(b, t, h, hd, dt=torch.float32), meta(b, h, t, dt=torch.float32), meta(b, t, h, hd)
    before = build.LAUNCHES.total()
    s = analyze(fa.backward, q, k, v, out32, lse, dout, True)
    assert build.LAUNCHES.total() == before
    ws = kc.flash_attention_grad(b, t, t, h, kv, hd).workspace_bytes
    assert ws > 0 and s.workspace_bytes == ws
    assert s.peak_bytes == s.input_bytes + 2 * (q.numel() + k.numel() + v.numel()) + ws
    assert s.kernel_calls == dict.fromkeys(("flash_attention_bwd_prep", "flash_attention_bwd",
                                            "flash_attention_bwd_post"), 1)


# ------------------------------------------------- families, meta vs CPU

FAMILIES = {"dense": "llama3.2-1b", "moe": "qwen3-moe-30b-a3b", "vlm": "chameleon-34b", "ssm": "mamba2-370m",
            "hybrid": "zamba2-7b", "audio": "seamless-m4t-medium"}
# each kernel's calls (kernels/cost.py's launches) and the plain version that
# stands in for it on the CPU
PLAIN_OF = {"flash_attention": "mha_ref", "flash_attention_bwd": "mha_ref_bwd", "decode_attention": "decode_attn_ref",
            "moe_gmm": "gmm_ref", "moe_gmm_bwd_dx": "gmm_ref_bwd", "ssd_scan": "ssd_ref",
            "ssd_scan_bwd_walk": "ssd_ref_bwd"}
# a gradient's other kernels, launched once with the one above
PAIRED = {"flash_attention_bwd_prep": "flash_attention_bwd", "flash_attention_bwd_post": "flash_attention_bwd",
          "moe_gmm_bwd_dw": "moe_gmm_bwd_dx", "ssd_scan_bwd_chunk": "ssd_scan_bwd_walk"}


def card_width(arch: str):
    """The reduced config at widths the kernels take: heads of 64 and, for
    the SSM families, a state of 64 over heads of 64 (the card's branch
    checks them on meta as it does on the card)."""
    cfg = get_arch(arch)
    changes = {"d_head": 64} if cfg.num_heads else {}
    if cfg.ssm_state:
        changes.update(ssm_state=64, ssm_head_dim=64)
    return dataclasses.replace(reduced_config(cfg), **changes)


class _PlainAttention(torch.autograd.Function):
    """K3's plain forward and plain backward as one opaque op (as the card's
    autograd runs K3's kernels)."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        ctx.save_for_backward(q, k, v)
        ctx.causal = causal
        with _disable_current_modes():
            return PLAIN_MHA(q, k, v, causal=causal)

    @staticmethod
    def backward(ctx, dout):
        q, k, v = ctx.saved_tensors
        with _disable_current_modes():
            g = fa.plain_bwd(q, k, v, dout, causal=ctx.causal)
        return (*(x.to(y.dtype) for x, y in zip(g, (q, k, v))), None)


PLAIN_MHA = fa.plain


@pytest.fixture
def opaque_plain(monkeypatch):
    """The CPU step with the plain versions counted as the kernels they
    stand in for: their own aten ops unseen by the analysis (the forwards
    run inside their custom ops already), K3's gradient the plain backward
    (not autograd through the plain forward), and the SSM prefill through
    K6's plain version (not the chunked scan the CPU takes)."""
    def mha(q, k, v, causal=True):
        if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
            return _PlainAttention.apply(q, k, v, causal)
        return PLAIN_MHA(q, k, v, causal=causal)

    def hidden(fn):
        def run(*args, **kwargs):
            with _disable_current_modes():
                return fn(*args, **kwargs)
        return run

    chunked = ssm_mod.ssd_chunked

    def ssd_chunked(x, bm, cm, dt, a_log, d_skip, chunk, init_state=None):
        if init_state is None:
            return kops.ssd(x.contiguous(), bm.contiguous(), cm.contiguous(), dt.contiguous(), a_log, d_skip,
                            return_state=True)
        return chunked(x, bm, cm, dt, a_log, d_skip, chunk, init_state)

    monkeypatch.setattr(fa, "plain", mha)
    monkeypatch.setattr(gm, "plain_bwd", hidden(gm.plain_bwd))
    monkeypatch.setattr(sd, "plain_bwd", hidden(sd.plain_bwd))
    monkeypatch.setattr(ssm_mod, "ssd_chunked", ssd_chunked)


def run_kind(model, kind: str, shape, args, grad: bool):
    """The cell's program on ``args`` under a cost analysis: (summary,
    gradient leaves or outputs)."""
    mode = CostAnalysis(args)
    with torch.set_grad_enabled(grad), donate.donating(kind == "decode"), mode:
        if kind == "train":
            _, _, grads = value_and_grad(model, *args)
            out = tree.leaves(grads)
        elif kind == "prefill":
            out = tree.leaves(model.prefill_fn(*args))
        else:
            out = tree.leaves(model.decode_fn(*args))
    return mode.summary(), [(tuple(x.shape), x.dtype) for x in out]


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_meta_step_is_the_cpu_step(family, kind, opaque_plain):
    """A family's step at its reduced config on meta tensors (the card's
    branch of every kernel, no launch) against the same step on the CPU: the
    same output or gradient leaves (shapes, dtypes), the same FLOPs outside
    the kernels, and each kernel called as often as its plain version."""
    cfg = card_width(FAMILIES[family])
    model = build_model(cfg)
    shape = ShapeConfig("t", 64, 2, kind)
    defs = model.input_defs(shape)

    def args_on(device):
        if device == "meta":
            ins = param_structs(defs)
            params = param_structs(model.param_defs)
            cache = param_structs(model.cache_defs(shape))
        else:
            ins = model.make_inputs(shape, 0, device="cpu")
            if kind == "decode":
                ins["cur_len"] = torch.full_like(ins["cur_len"], 5)
            params = model.init(0, device="cpu")
            cache = init_params(model.cache_defs(shape), 0, device="cpu")
        return (params, ins) if kind != "decode" else (params, ins, cache)

    before = build.LAUNCHES.total()
    meta, meta_out = run_kind(model, kind, shape, args_on("meta"), kind == "train")
    assert build.LAUNCHES.total() == before  # the card's branch, no launch
    ref.CALLS.update(dict.fromkeys(ref.CALLS, 0))
    cpu, cpu_out = run_kind(model, kind, shape, args_on("cpu"), kind == "train")
    assert meta_out == cpu_out
    assert meta.aten_flops == cpu.aten_flops
    assert {k: meta.kernel_calls.get(k, 0) for k in PLAIN_OF} == {k: ref.CALLS[p] for k, p in PLAIN_OF.items()}
    assert all(meta.kernel_calls.get(k, 0) == meta.kernel_calls.get(main, 0) for k, main in PAIRED.items())
    assert meta.kernel_flops > 0 or family == "ssm" and kind == "decode"
    assert meta.peak_bytes >= meta.input_bytes > 0


def micro_llama(n_micro: int = 2):
    cfg = dataclasses.replace(card_width("llama3.2-1b"), microbatches=n_micro)
    return build_model(cfg), ShapeConfig("t", 64, 4, "train")


def test_meta_train_step_scales_its_microbatches(opaque_plain):
    """The train step's microbatch loop runs once on meta and counts n
    times; the CPU step runs it whole and counts the same FLOPs outside the
    kernels, and its plain versions run as often as the meta run recorded
    the kernels."""
    model, shape = micro_llama()
    step = make_train_step(model)
    state = param_structs({"params": model.param_defs, "opt": adamw_state_defs(model.param_defs)})
    with donate.donating():
        scaled = analyze(step, state, param_structs(model.input_defs(shape)))
    ref.CALLS.update(dict.fromkeys(ref.CALLS, 0))
    direct = analyze(step, init_train_state(model, 0, device="cpu"), model.make_inputs(shape, 0, device="cpu"))
    assert scaled.loop_trips == {"microbatches": 2} and direct.loop_trips == {}
    assert scaled.aten_flops == direct.aten_flops
    assert {k: scaled.kernel_calls.get(k, 0) for k in PLAIN_OF} == {k: ref.CALLS[p] for k, p in PLAIN_OF.items()}


def test_an_analysed_step_trains_as_a_bare_step():
    """Under an analysis a CPU step runs every microbatch: it leaves the
    params, moments and metrics a bare step leaves, bit for bit."""
    model, shape = micro_llama()
    step = make_train_step(model)
    batch = model.make_inputs(shape, 0, device="cpu")
    bare, bare_m = step(init_train_state(model, 0, device="cpu"), batch)
    mode = CostAnalysis()
    with mode:
        seen, seen_m = step(init_train_state(model, 0, device="cpu"), batch)
    assert mode.summary().aten_flops > 0
    assert all(torch.equal(a, b) for a, b in zip(tree.leaves(bare), tree.leaves(seen)))
    assert all(torch.equal(bare_m[k], seen_m[k]) for k in bare_m)
