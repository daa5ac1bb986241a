"""The hand-written kernels K3 (flash_attention, and its gradient), K4 (decode_attention),
K1 (paged_decode_attention), K2 (paged_chunk_attention), K5 (moe_gmm, and its
gradient) and K6 (ssd_scan, and its gradient) against their plain versions,
on the card.

Every test here is marked ``cuda`` and skips on a host without a CUDA
device. The file imports no JAX, so it runs where only PyTorch is
installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import decode_attention as tdec  # noqa: E402
from repro_torch.kernels import flash_attention as tflash  # noqa: E402
from repro_torch.kernels import moe_gmm as tgmm  # noqa: E402
from repro_torch.kernels import paged_attention as tpaged  # noqa: E402
from repro_torch.kernels import ssd_scan as tssd  # noqa: E402

RTOL = ATOL = 2e-2  # bf16, as tests/test_kernels.py


def inputs(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def as_np(x):
    return x.float().cpu().numpy()


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the hand-written kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("b,t,s,h,kv,hd,causal", [
    (1, 37, 37, 32, 8, 64, True),
    (1, 300, 300, 32, 8, 64, True),
    (2, 256, 256, 4, 1, 64, False),   # MQA
    (1, 200, 200, 8, 2, 128, True),
    (2, 65, 130, 4, 2, 64, False),    # ragged T != S
    (1, 300, 300, 32, 32, 112, True),  # zamba2-7b's shared block: MHA, head dim 112
    (2, 65, 130, 4, 4, 112, False),
    # the ragged edges: one row, one tile, one row past a tile, many tiles
    (1, 1, 1, 32, 8, 64, True),
    (1, 64, 64, 32, 8, 64, True),
    (1, 65, 65, 32, 8, 64, True),
    (1, 1000, 1000, 32, 8, 64, True),
    (1, 65, 65, 8, 8, 112, True),
    (1, 1000, 1000, 8, 2, 128, True),
    (1, 200, 70, 8, 2, 128, False),   # non-causal T > S, S not a multiple of 64
    (1, 1, 300, 4, 1, 112, False),    # non-causal: one query row over S = 300
])
def test_flash_kernel_matches_plain(cuda, b, t, s, h, kv, hd, causal):
    qn, kn, vn = inputs(13, (b, t, h, hd), (b, s, kv, hd), (b, s, kv, hd))
    q, k, v = (torch.from_numpy(x).to(cuda, torch.bfloat16) for x in (qn, kn, vn))
    before = build.launches("flash_attention")
    got = tflash.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert build.launches("flash_attention") == before + 1
    want = tflash.plain(q, k, v, causal=causal)
    np.testing.assert_allclose(as_np(got), as_np(want), rtol=RTOL, atol=ATOL)
    assert torch.equal(got, tflash.flash_attention(q, k, v, causal=causal))  # one fixed order


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,h,kv,hd", [(1, 512, 32, 8, 64), (4, 512, 32, 8, 64), (3, 300, 8, 2, 128),
                                          (1, 512, 32, 32, 112), (2, 300, 32, 32, 112),  # zamba2-7b
                                          # starcoder2-3b's and granite-34b's groups (G * hd 1536,
                                          # 6144): wider than one head slice of the kernel
                                          (2, 512, 24, 2, 128), (2, 300, 48, 1, 128)])
def test_decode_kernel_matches_plain(cuda, b, s, h, kv, hd):
    qn, kn, vn = inputs(17, (b, h, hd), (b, s, kv, hd), (b, s, kv, hd))
    q, k, v = (torch.from_numpy(x).to(cuda, torch.bfloat16) for x in (qn, kn, vn))
    cur = torch.from_numpy(np.random.default_rng(4).integers(1, s + 1, size=(b,)).astype(np.int32)).to(cuda)
    cur[0] = 1
    before = build.launches("decode_attention")
    got = tdec.decode_attention(q, k, v, cur)
    torch.cuda.synchronize()
    assert build.launches("decode_attention") == before + 1
    np.testing.assert_allclose(as_np(got), as_np(tdec.plain(q, k, v, cur)), rtol=RTOL, atol=ATOL)
    assert torch.equal(got, tdec.decode_attention(q, k, v, cur))  # one fixed order, no atomics
    zeros = tdec.decode_attention(q, k, v, torch.zeros_like(cur))
    assert torch.equal(zeros, torch.zeros_like(zeros))


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [64, 112, 128])
@pytest.mark.parametrize("s", [300, 4100])
def test_decode_kernel_lse_matches_plain(cuda, s, hd):
    """K4 with ``return_lse``: one launch, the same output bits as without,
    the heads' logsumexp within 1e-3 of the plain version's and -inf at
    cur_len 0."""
    kv, g = 2, 4
    lens = [0, 1, 65, s]
    b = len(lens)
    qn, kn, vn = inputs(29, (b, g * kv, hd), (b, s, kv, hd), (b, s, kv, hd))
    q, k, v = (torch.from_numpy(x).to(cuda, torch.bfloat16) for x in (qn, kn, vn))
    cur = torch.tensor(lens, dtype=torch.int32, device=cuda)
    before = build.launches("decode_attention")
    got, lse = tdec.decode_attention(q, k, v, cur, return_lse=True)
    torch.cuda.synchronize()
    assert build.launches("decode_attention") == before + 1
    assert torch.equal(got, tdec.decode_attention(q, k, v, cur))
    want = tdec.plain_lse(q, k, v, cur)[1]
    assert torch.isneginf(lse[0]).all() and torch.isfinite(lse[1:]).all()
    np.testing.assert_allclose(lse[1:].cpu().numpy(), want[1:].cpu().numpy(), rtol=0, atol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [64, 112, 128])
@pytest.mark.parametrize("g", [1, 4, 8])
@pytest.mark.parametrize("s", [300, 512, 4096, 4100])
def test_decode_kernel_edges(cuda, s, g, hd):
    """K4's split-K over the cache's ragged edges: one sequence per cur_len
    of 1, 63, 64, 65 (a tile boundary on either side) and S; S not a multiple
    of 64 (300, 4100) and S > 8 * 64, where each of the 8 splits loops over
    several tiles; G = 1, 4, 8 query heads per kv head."""
    kv = 2
    lens = [1, 63, 64, 65, s]
    b = len(lens)
    qn, kn, vn = inputs(19, (b, g * kv, hd), (b, s, kv, hd), (b, s, kv, hd))
    q, k, v = (torch.from_numpy(x).to(cuda, torch.bfloat16) for x in (qn, kn, vn))
    cur = torch.tensor(lens, dtype=torch.int32, device=cuda)
    before = build.launches("decode_attention")
    got = tdec.decode_attention(q, k, v, cur)
    torch.cuda.synchronize()
    assert build.launches("decode_attention") == before + 1
    np.testing.assert_allclose(as_np(got), as_np(tdec.plain(q, k, v, cur)), rtol=RTOL, atol=ATOL)
    assert torch.equal(got, tdec.decode_attention(q, k, v, cur))  # one fixed order, no atomics
    zeros = tdec.decode_attention(q, k, v, torch.tensor([0, 5, 0, 64, 0], dtype=torch.int32, device=cuda))
    assert torch.equal(zeros[0::2], torch.zeros_like(zeros[0::2]))  # cur_len 0: exact zeros


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["flash_attention", "decode_attention", "paged_chunk_attention", "ssd_scan"])
def test_attention_kernels_give_equal_bits_on_two_launches(cuda, kernel):
    """The serve phases require identical greedy tokens fused, unfused and
    without the platform: the kernels must sum in one fixed order. At the
    serve shapes, 20 launches on the same inputs give the same bits (K6: y
    and the final state)."""
    if kernel == "flash_attention":
        qn, kn, vn = inputs(37, (1, 300, 32, 64), (1, 300, 8, 64), (1, 300, 8, 64))
        q, k, v = (torch.from_numpy(x).to(cuda, torch.bfloat16) for x in (qn, kn, vn))
        run = lambda: tflash.flash_attention(q, k, v, causal=True)  # noqa: E731
    elif kernel == "decode_attention":
        qn, kn, vn = inputs(37, (1, 32, 64), (1, 512, 8, 64), (1, 512, 8, 64))
        q, k, v = (torch.from_numpy(x).to(cuda, torch.bfloat16) for x in (qn, kn, vn))
        cur = torch.tensor([406], dtype=torch.int32, device=cuda)
        run = lambda: tdec.decode_attention(q, k, v, cur)  # noqa: E731
    elif kernel == "paged_chunk_attention":  # the paged serve path's 512-row chunk
        kp, vp, bt, rng = paged_inputs(37, 1, 32, 16, 321, 32, 8, 64, cuda)
        q = torch.from_numpy(rng.standard_normal((1, 512, 32, 64)).astype(np.float32)).to(cuda, torch.bfloat16)
        st = torch.zeros(1, dtype=torch.int32, device=cuda)
        run = lambda: tpaged.paged_chunk_attention(q, kp, vp, bt, st)  # noqa: E731
    else:  # mamba2-370m's prompt of 300
        args = ssd_inputs(37, 1, 300, 32, 1, 64, 128, cuda)
        run = lambda: torch.cat([t.flatten().float() for t in tssd.ssd_scan(*args, return_state=True)])  # noqa: E731
    first = run()
    assert all(torch.equal(first, run()) for _ in range(20))


@pytest.mark.cuda
def test_attention_c_entries_reject_an_unsupported_launch(cuda):
    """A launch the C entry refuses (head dim 96 has no instantiation) comes
    back as an error that the wrapper's check raises, never as a silent no-op.
    K3's forward entry takes its lse pointer after the output (null: not
    written)."""
    from repro_torch.kernels import build

    lib = build.load()
    x = torch.zeros(1, 64, 2, 96, device=cuda, dtype=torch.bfloat16)
    q = torch.zeros(1, 2, 96, device=cuda, dtype=torch.bfloat16)
    cur = torch.ones(1, dtype=torch.int32, device=cuda)
    stream = torch.cuda.current_stream().cuda_stream
    with pytest.raises(RuntimeError, match="CUDA error"):
        build.check(lib.repro_flash_attention_fwd(x.data_ptr(), x.data_ptr(), x.data_ptr(), x.data_ptr(), None,
                                                  1, 64, 64, 2, 2, 96, 1, stream), "flash_attention launch")
    lse = torch.zeros(1, 2, 64, device=cuda)
    sem = torch.zeros(2, dtype=torch.int32, device=cuda)
    with pytest.raises(RuntimeError, match="CUDA error"):  # K3's backward kernels refuse it too
        build.check(lib.repro_flash_attention_bwd_prep(x.data_ptr(), x.data_ptr(), lse.data_ptr(), lse.data_ptr(),
                                                       lse.data_ptr(), sem.data_ptr(), 1, 64, 2, 96, stream),
                    "flash_attention bwd launch")
    with pytest.raises(RuntimeError, match="CUDA error"):
        build.check(lib.repro_flash_attention_bwd(x.data_ptr(), x.data_ptr(), x.data_ptr(), x.data_ptr(),
                                                  lse.data_ptr(), lse.data_ptr(), lse.data_ptr(), sem.data_ptr(),
                                                  x.data_ptr(), x.data_ptr(), None, 1, 64, 64, 2, 2, 96, 1, 1, stream),
                    "flash_attention bwd launch")
    with pytest.raises(RuntimeError, match="CUDA error"):
        build.check(lib.repro_flash_attention_bwd_post(lse.data_ptr(), x.data_ptr(), None, x.data_ptr(),
                                                       x.data_ptr(), 1, 64, 64, 2, 2, 96, 1, stream),
                    "flash_attention bwd launch")
    with pytest.raises(RuntimeError, match="CUDA error"):  # a head split wider than the group
        build.check(lib.repro_flash_attention_bwd(x.data_ptr(), x.data_ptr(), x.data_ptr(), x.data_ptr(),
                                                  lse.data_ptr(), lse.data_ptr(), lse.data_ptr(), sem.data_ptr(),
                                                  x.data_ptr(), x.data_ptr(), None, 1, 64, 64, 2, 2, 64, 1, 2, stream),
                    "flash_attention bwd launch")
    with pytest.raises(RuntimeError, match="CUDA error"):
        build.check(lib.repro_decode_attention_fwd(q.data_ptr(), x.data_ptr(), x.data_ptr(), cur.data_ptr(),
                                                   q.data_ptr(), 1, 64, 64, 2, 2, 96, stream), "decode_attention launch")
    # a group whose q, scores and accumulators outgrow one block's shared
    # memory (G = 256 at hd 128); every narrower group is taken
    q256 = torch.zeros(1, 512, 128, device=cuda, dtype=torch.bfloat16)
    kv = torch.zeros(1, 64, 2, 128, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(RuntimeError, match="CUDA error"):
        build.check(lib.repro_decode_attention_fwd(q256.data_ptr(), kv.data_ptr(), kv.data_ptr(), cur.data_ptr(),
                                                   q256.data_ptr(), 1, 64, 64, 512, 2, 128, stream),
                    "decode_attention launch")


@pytest.mark.cuda
def test_kernel_rejects_float32_on_the_card(cuda):
    q = torch.zeros(1, 16, 4, 64, device=cuda)
    with pytest.raises(TypeError):
        tflash.flash_attention(q, q, q)


@pytest.mark.cuda
def test_serving_chain_on_the_card_goes_through_the_kernels(cuda):
    """A small llama3.2-1b (head dim 64, so the kernels take it) served by
    the fusing chain on the card: only the kernels run, never their plain
    versions, and the logits match the same model on the CPU."""
    import dataclasses

    from repro_torch import tree
    from repro_torch.configs import get_arch, reduced_config
    from repro_torch.core import FusionPolicy, TinyTorchBackend
    from repro_torch.kernels import ops
    from repro_torch.models.model import build_model
    from repro_torch.serving.engine import ServingEngine

    cfg = dataclasses.replace(reduced_config(get_arch("llama3.2-1b")), d_model=256, d_head=64)
    model = build_model(cfg)
    params = model.init(0, device=cuda)
    toks = torch.from_numpy(np.random.default_rng(2).integers(0, cfg.vocab_size, (1, 9)).astype(np.int32))
    platform = TinyTorchBackend(FusionPolicy(min_observations=2, merge_cost_s=0.0))
    try:
        engine = ServingEngine(model, platform, max_len=32, params=params, device=cuda)
        ops.reset_counts()
        engine.generate({"tokens": toks.to(cuda)}, steps=6)
        counts = ops.counts()
        logits, _, _ = engine.prefill({"tokens": toks.to(cuda)})
        assert len(platform.registry.live_instances()) == 1
    finally:
        platform.shutdown()
    assert counts["flash_attention"] > 0 and counts["decode_attention"] > 0
    assert counts["mha_ref"] == 0 and counts["decode_attn_ref"] == 0
    cpu_params = tree.map(lambda x: x.cpu(), params)
    with torch.no_grad():
        want, _ = model.prefill_fn(cpu_params, {"tokens": toks})
    got = logits.cpu()
    assert torch.isfinite(got).all()
    assert (got - want).abs().max() <= 2e-2 * want.abs().max()


def paged_inputs(seed, b, n, page, p, h, kv, hd, device):
    """Random bf16 pages and a block table of distinct live pages per
    sequence (page 0 is the arena's scratch page: table padding)."""
    rng = np.random.default_rng(seed)
    kp, vp = (torch.from_numpy(rng.standard_normal((p, page, kv, hd)).astype(np.float32))
              .to(device, torch.bfloat16) for _ in range(2))
    perm = rng.permutation(np.arange(1, p))[: b * n].reshape(b, n)
    bt = torch.from_numpy(perm.astype(np.int32)).to(device)
    return kp, vp, bt, rng


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,page,p,h,kv,hd,lens", [
    (8, 32, 16, 321, 32, 8, 64, [0, 37, 129, 300, 406, 511, 1, 64]),  # the serve shape
    (1, 32, 16, 321, 32, 8, 64, [406]),
    (3, 8, 16, 40, 8, 1, 128, [5, 128, 77]),  # MQA, head dim 128
    (2, 4, 128, 9, 4, 2, 64, [300, 512]),     # page 128
    (8, 32, 16, 321, 32, 4, 128, [0, 37, 129, 300, 406, 511, 1, 64]),  # qwen3-moe-30b-a3b's paged shape
    (4, 32, 16, 321, 24, 2, 128, [0, 37, 300, 512]),  # starcoder2-3b's group: G * hd = 1536
    (4, 32, 16, 321, 48, 1, 128, [1, 64, 300, 511]),  # granite-34b's group: 6144
])
def test_paged_decode_kernel_matches_plain(cuda, b, n, page, p, h, kv, hd, lens):
    kp, vp, bt, rng = paged_inputs(21, b, n, page, p, h, kv, hd, cuda)
    q = torch.from_numpy(rng.standard_normal((b, h, hd)).astype(np.float32)).to(cuda, torch.bfloat16)
    cur = torch.tensor(lens, dtype=torch.int32, device=cuda)
    before = build.launches("paged_decode_attention")
    got = tpaged.paged_decode_attention(q, kp, vp, bt, cur)
    torch.cuda.synchronize()
    assert build.launches("paged_decode_attention") == before + 1
    np.testing.assert_allclose(as_np(got), as_np(tpaged.plain_decode(q, kp, vp, bt, cur)),
                               rtol=RTOL, atol=ATOL)
    assert torch.equal(got, tpaged.paged_decode_attention(q, kp, vp, bt, cur))  # one fixed order
    for i, n_valid in enumerate(lens):
        if n_valid == 0:  # a masked slot: exact zeros
            assert torch.equal(got[i], torch.zeros_like(got[i]))


@pytest.mark.cuda
@pytest.mark.parametrize("c,start,valid,n,h,kv,hd", [
    (64, 0, 64, 32, 32, 8, 64), (64, 192, 64, 32, 32, 8, 64), (512, 0, 300, 32, 32, 8, 64), (5, 37, 5, 32, 32, 8, 64),
    # qwen3-moe-30b-a3b's paged shape: 32/4 heads of 128
    (512, 0, 300, 32, 32, 4, 128), (64, 192, 64, 32, 32, 4, 128),
    # a table of 13 pages (208 rows) ends inside its fourth 64-row tile; the
    # chunk's later rows reach past it
    (64, 160, 64, 13, 32, 8, 64), (100, 130, 100, 13, 8, 2, 128),
])
def test_paged_chunk_kernel_matches_plain(cuda, c, start, valid, n, h, kv, hd):
    page, p = 16, 321
    kp, vp, bt, rng = paged_inputs(23, 1, n, page, p, h, kv, hd, cuda)
    q = torch.from_numpy(rng.standard_normal((1, c, h, hd)).astype(np.float32)).to(cuda, torch.bfloat16)
    st = torch.tensor([start], dtype=torch.int32, device=cuda)
    before = build.launches("paged_chunk_attention")
    got = tpaged.paged_chunk_attention(q, kp, vp, bt, st)
    torch.cuda.synchronize()
    assert build.launches("paged_chunk_attention") == before + 1
    want = tpaged.plain_chunk(q, kp, vp, bt, st)
    # rows past `valid` are padding the head discards, but computed all the same
    np.testing.assert_allclose(as_np(got), as_np(want), rtol=RTOL, atol=ATOL)


@pytest.mark.cuda
def test_paged_kernels_reject_what_they_do_not_take(cuda):
    kp = torch.zeros(4, 16, 2, 64, device=cuda, dtype=torch.bfloat16)
    bt = torch.zeros(1, 2, dtype=torch.int32, device=cuda)
    cur = torch.ones(1, dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):
        tpaged.paged_decode_attention(torch.zeros(1, 4, 64, device=cuda), kp.float(), kp.float(), bt, cur)
    with pytest.raises(ValueError):
        tpaged.paged_decode_attention(torch.zeros(1, 4, 64, device=cuda, dtype=torch.bfloat16), kp, kp,
                                      bt.long(), cur)


@pytest.mark.cuda
def test_batcher_on_the_card_goes_through_the_paged_kernels(cuda):
    """A small llama3.2-1b served by the continuous batcher on the card:
    chunked prefill runs K2, batched decode K1, never a plain version, and
    every request completes with the arena consistent and empty."""
    import dataclasses

    from repro_torch.configs import get_arch, reduced_config
    from repro_torch.core import FusionPolicy, TinyTorchBackend
    from repro_torch.kernels import ops
    from repro_torch.models.model import build_model
    from repro_torch.serving.continuous import ContinuousBatcher
    from repro_torch.serving.engine import ServingEngine

    cfg = dataclasses.replace(reduced_config(get_arch("llama3.2-1b")), d_model=256, d_head=64)
    model = build_model(cfg)
    platform = TinyTorchBackend(FusionPolicy(min_observations=2, merge_cost_s=0.0))
    rng = np.random.default_rng(8)
    prompts = [rng.integers(0, cfg.vocab_size, (1, t)).astype(np.int32) for t in (9, 23, 40)]
    try:
        engine = ServingEngine(model, platform, max_len=64, device=cuda, kv_pages=24, kv_page_size=16)
        engine.generate({"tokens": torch.from_numpy(prompts[0]).to(cuda)}, steps=4)  # fuse on dense traffic
        assert len(platform.registry.live_instances()) == 1
        ops.reset_counts()
        cb = ContinuousBatcher(engine, capacity=4, prefill_chunk=16)
        try:
            results = [f.result(timeout=300) for f in [cb.submit({"tokens": p}, 6) for p in prompts]]
        finally:
            cb.shutdown()
        counts = ops.counts()
        engine.arena.check_consistency()
        assert engine.arena.used_pages() == 0
    finally:
        platform.shutdown()
    assert all(r["tokens"].shape == (1, 6) for r in results)
    assert counts["paged_decode_attention"] > 0 and counts["paged_chunk_attention"] > 0
    assert all(counts[k] == 0 for k in ("mha_ref", "decode_attn_ref", "paged_decode_attn_ref",
                                        "paged_chunk_attn_ref"))


@pytest.mark.cuda
@pytest.mark.parametrize("e,c,d,f", [
    (128, 8, 2048, 768),   # gate/up at a decode step (qwen3-moe-30b-a3b)
    (128, 8, 768, 2048),   # down at a decode step
    (128, 24, 2048, 768),  # gate/up at a 300-token dense prefill
    (128, 40, 2048, 768),  # gate/up at a 512-row paged chunk
    (4, 5, 64, 40),        # ragged: C and f past the tile edges
    (3, 70, 136, 48),      # ragged: C over two tiles, d past a stage
])
def test_moe_gmm_kernel_matches_plain(cuda, e, c, d, f):
    xn, wn = inputs(29, (e, c, d), (e, d, f))
    xe = torch.from_numpy(xn).to(cuda, torch.bfloat16)
    w = (torch.from_numpy(wn) * d ** -0.5).to(cuda, torch.bfloat16)
    before = build.launches("moe_gmm")
    got = tgmm.moe_gmm(xe, w)
    torch.cuda.synchronize()
    assert build.launches("moe_gmm") == before + 1
    assert got.shape == (e, c, f) and got.dtype == torch.bfloat16
    np.testing.assert_allclose(as_np(got), as_np(tgmm.plain(xe, w)), rtol=RTOL, atol=ATOL)
    assert torch.equal(got, tgmm.moe_gmm(xe, w))  # deterministic: no split-K, no atomics


def routed_rows(seed, e, tokens, cap, k=8):
    """Each expert's kept rows from a top-k routing of ``tokens`` tokens
    (random router scores), min(count, cap), as the MoE layer computes it."""
    scores = np.random.default_rng(seed).standard_normal((tokens, e))
    choices = np.argsort(-scores, axis=1)[:, :k]
    return np.minimum(np.bincount(choices.ravel(), minlength=e), cap).astype(np.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("tokens,c,d,f", [
    (1, 8, 2048, 768),    # a decode step's gate/up (qwen3-moe-30b-a3b: 8 of 128 experts)
    (1, 8, 768, 2048),    # its down projection
    (8, 8, 2048, 768),    # a paged decode step of 8 sequences
    (300, 24, 2048, 768),  # a 300-token prefill: nearly every expert, 8-24 rows
    (40, 70, 136, 48),    # two C tiles: the second past most experts' rows
])
def test_moe_gmm_kernel_routed_rows(cuda, tokens, c, d, f):
    """K5 with ``rows``: within tolerance of the plain version, skipped rows
    exact zeros, equal bits on two launches, and the same bits as the kernel
    without ``rows`` on the same (masked) input."""
    e = 128
    rows = torch.from_numpy(routed_rows(tokens, e, tokens, c)).to(cuda)
    keep = torch.arange(c, device=cuda)[None, :] < rows[:, None]
    xn, wn = inputs(31, (e, c, d), (e, d, f))
    xe = torch.from_numpy(xn).to(cuda, torch.bfloat16).masked_fill(~keep[..., None], 0)
    w = (torch.from_numpy(wn) * d ** -0.5).to(cuda, torch.bfloat16)
    before = build.launches("moe_gmm")
    got = tgmm.moe_gmm(xe, w, rows, min(e, 8 * tokens))
    torch.cuda.synchronize()
    assert build.launches("moe_gmm") == before + 1
    np.testing.assert_allclose(as_np(got), as_np(tgmm.plain(xe, w, rows)), rtol=RTOL, atol=ATOL)
    assert not got[~keep].any()
    assert torch.equal(got, tgmm.moe_gmm(xe, w, rows, min(e, 8 * tokens)))
    assert torch.equal(got, tgmm.moe_gmm(xe, w))
    assert torch.equal(got, tgmm.moe_gmm(xe, w, rows, 1))  # any bound on the active experts is correct


@pytest.mark.cuda
def test_moe_gmm_kernel_rejects_what_it_does_not_take(cuda):
    xe = torch.zeros(2, 8, 64, device=cuda, dtype=torch.bfloat16)
    w = torch.zeros(2, 64, 32, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(TypeError):
        tgmm.moe_gmm(xe.float(), w.float())
    with pytest.raises(ValueError):
        tgmm.moe_gmm(xe[:, :, :60].contiguous(), w[:, :60].contiguous())  # d not a multiple of 8
    with pytest.raises(ValueError):
        tgmm.moe_gmm(xe, w[:1])  # expert count mismatch


@pytest.mark.cuda
def test_moe_chain_on_the_card_goes_through_k5(cuda):
    """A small qwen3-moe-30b-a3b (head dim 64, so the attention kernels take
    it) served by the chain on the card: K5 launches three times per MoE
    layer and no plain version runs; its first MoE layer, on the same bf16
    input, matches the CPU's (fp32 routing on both sides: the same experts)."""
    import dataclasses

    from repro_torch import tree
    from repro_torch.configs import get_arch, reduced_config
    from repro_torch.core import FusionPolicy, TinyTorchBackend
    from repro_torch.kernels import ops
    from repro_torch.models import moe
    from repro_torch.models.model import build_model
    from repro_torch.serving.engine import ServingEngine

    cfg = dataclasses.replace(reduced_config(get_arch("qwen3-moe-30b-a3b")), d_model=256, d_head=64)
    model = build_model(cfg)
    params = model.init(0, device=cuda)
    toks = torch.from_numpy(np.random.default_rng(3).integers(0, cfg.vocab_size, (1, 9)).astype(np.int32))
    platform = TinyTorchBackend(FusionPolicy(enabled=False))
    try:
        engine = ServingEngine(model, platform, max_len=32, params=params, device=cuda)
        ops.reset_counts()
        logits, _, _ = engine.prefill({"tokens": toks.to(cuda)})
        counts = ops.counts()
    finally:
        platform.shutdown()
    assert counts["moe_gmm"] == 3 * cfg.num_layers
    assert all(v == 0 for k, v in counts.items() if k.endswith("_ref"))
    assert logits.shape == (1, cfg.vocab_size) and torch.isfinite(logits).all()
    layer = tree.map(lambda x: x[0], params["blocks"]["moe"])
    x = torch.from_numpy(np.random.default_rng(4).standard_normal((2, 9, 256)).astype(np.float32))
    x = x.to(cuda, torch.bfloat16)
    with torch.no_grad():
        got, _ = moe.apply_moe(layer, x, cfg)
        want, _ = moe.apply_moe(tree.map(lambda a: a.cpu(), layer), x.cpu(), cfg)
        assert torch.equal(moe.route(layer, x, cfg)[1].cpu(),
                           moe.route(tree.map(lambda a: a.cpu(), layer), x.cpu(), cfg)[1])
    assert (got.cpu().float() - want.float()).abs().max() <= 2e-2 * want.float().abs().max()


def ssd_inputs(seed, b, t, h, g, p, n, device):
    """tests/test_kernels.py's SSD recipe: B, C of std 0.5, dt = softplus of
    a normal, A_log of std 0.3, D = 1; x, B, C in bf16 (the model dtype)."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((b, t, h, p)).astype(np.float32)).to(device, torch.bfloat16)
    bm, cm = (torch.from_numpy((rng.standard_normal((b, t, g, n)) * 0.5).astype(np.float32))
              .to(device, torch.bfloat16) for _ in range(2))
    dt = torch.nn.functional.softplus(torch.from_numpy(rng.standard_normal((b, t, h)).astype(np.float32))).to(device)
    a_log = torch.from_numpy((rng.standard_normal(h) * 0.3).astype(np.float32)).to(device)
    return x, bm, cm, dt, a_log, torch.ones(h, device=device)


@pytest.mark.cuda
@pytest.mark.parametrize("b,t,h,g,p,n", [
    (1, 300, 32, 1, 64, 128),  # mamba2-370m's prompt of 300
    (1, 300, 112, 1, 64, 64),  # zamba2-7b's
    (1, 37, 32, 1, 64, 128),   # one partial chunk
    (1, 512, 112, 1, 64, 64),  # two full chunks of the configured 256
    (2, 300, 8, 2, 64, 64),    # groups: heads 0-3 read group 0, 4-7 group 1
    (1, 1, 4, 1, 32, 64),      # one token
    (1, 65, 6, 3, 96, 128),    # three head-dim slices; a chunk of one row
])
def test_ssd_kernel_matches_plain(cuda, b, t, h, g, p, n):
    args = ssd_inputs(31, b, t, h, g, p, n, cuda)
    before = build.launches("ssd_scan")
    got, state = tssd.ssd_scan(*args, return_state=True)
    torch.cuda.synchronize()
    assert build.launches("ssd_scan") == before + 1
    assert got.shape == (b, t, h, p) and got.dtype == torch.bfloat16
    assert state.shape == (b, h, p, n) and state.dtype == torch.float32
    want, want_state = tssd.plain(*args)
    np.testing.assert_allclose(as_np(got), as_np(want), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(as_np(state), as_np(want_state), rtol=RTOL, atol=ATOL)
    assert torch.equal(got, tssd.ssd_scan(*args))  # deterministic: one fixed summation order


@pytest.mark.cuda
def test_ssd_kernel_is_finite_where_the_decay_overflows(cuda):
    """dt = 1 and a = -1 over 512 steps: cum_i - cum_j above the diagonal
    reaches +511, where exp overflows; the kernel never evaluates it."""
    x, bm, cm, dt, a_log, d = ssd_inputs(33, 1, 512, 4, 1, 64, 64, cuda)
    dt, a_log = torch.ones_like(dt), torch.zeros_like(a_log)
    got = tssd.ssd_scan(x, bm, cm, dt, a_log, d)
    assert torch.isfinite(got.float()).all()
    np.testing.assert_allclose(as_np(got), as_np(tssd.plain(x, bm, cm, dt, a_log, d)[0]), rtol=RTOL, atol=ATOL)


@pytest.mark.cuda
def test_ssd_kernel_rejects_what_it_does_not_take(cuda):
    x, bm, cm, dt, a_log, d = ssd_inputs(35, 1, 16, 4, 1, 64, 64, cuda)
    with pytest.raises(TypeError):
        tssd.ssd_scan(x.float(), bm, cm, dt, a_log, d)
    with pytest.raises(ValueError):
        tssd.ssd_scan(x, bm[..., :32].contiguous(), cm[..., :32].contiguous(), dt, a_log, d)  # N = 32
    with pytest.raises(ValueError):
        tssd.ssd_scan(x[..., :48].contiguous(), bm, cm, dt, a_log, d)  # P = 48


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["mamba2-370m", "zamba2-7b"])
def test_ssm_and_hybrid_chains_on_the_card_go_through_the_kernels(cuda, arch):
    """A small mamba2-370m and zamba2-7b (SSM heads of 64 over a state of 64,
    attention heads of 64) served by the chain on the card: a prefill
    launches K6 once per Mamba layer and K3 once per shared-block
    application, a decode step K4 once per application and no K6 (the
    recurrent form), no plain version runs, and the prefill's logits match
    the same model on the CPU. The model is chip_smoke.py's small one, its
    shared attention drawn with fan-in d (``attention_fan_in_d``): under the
    JAX init rule the small hybrid's prefill logits move by tens of percent
    when K6's output is rounded once instead of twice."""
    import importlib.util
    from pathlib import Path

    from repro_torch import tree
    from repro_torch.configs import get_arch
    from repro_torch.core import FusionPolicy, TinyTorchBackend
    from repro_torch.kernels import ops
    from repro_torch.models.model import build_model
    from repro_torch.serving.engine import ServingEngine

    root = Path(__file__).resolve().parents[1]
    spec = importlib.util.spec_from_file_location("chip_smoke", root / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    cfg = smoke.small_config(get_arch(arch))
    model = build_model(cfg)
    params = model.init(0, device=cuda)
    smoke.attention_fan_in_d(params, cfg)
    apps = cfg.num_layers // cfg.shared_attn_every if cfg.shared_attn_every else 0
    toks = torch.from_numpy(np.random.default_rng(3).integers(0, cfg.vocab_size, (1, 41)).astype(np.int32))
    platform = TinyTorchBackend(FusionPolicy(enabled=False))
    try:
        engine = ServingEngine(model, platform, max_len=64, params=params, device=cuda)
        ops.reset_counts()
        logits, caches, cur = engine.prefill({"tokens": toks.to(cuda)})
        prefill = ops.counts()
        ops.reset_counts()
        step, _ = engine.decode_step(torch.argmax(logits, -1)[:, None].to(torch.int32), cur, caches)
        decode = ops.counts()
    finally:
        platform.shutdown()
    assert prefill["ssd_scan"] == cfg.num_layers and decode["ssd_scan"] == 0
    assert prefill["flash_attention"] == apps and decode["decode_attention"] == apps
    assert all(v == 0 for k, v in {**prefill, **decode}.items() if k.endswith("_ref"))
    assert torch.isfinite(logits).all() and torch.isfinite(step).all()
    with torch.no_grad():
        want, _ = model.prefill_fn(tree.map(lambda x: x.cpu(), params), {"tokens": toks})
    assert (logits.cpu() - want).abs().max() <= 2e-2 * want.abs().max()


# K3's gradient at chip_smoke.py's shapes: (a) the train shape, (b) T = 300,
# (c) the two wide groups at heads of 128 (granite's 48/1 at B = 1 and 2),
# (d) MHA at 112, (e) (b) non-causal; then ragged edges (one row, a tile and
# one row, T != S, T = 300 against S = 1000 both ways), a group of 16/2 at
# 128 (its heads split over blocks) and 112 with a split and T != S
FLASH_GRAD_CASES = [
    (2, 4096, 4096, 32, 8, 64, True),
    (1, 300, 300, 32, 8, 64, True),
    (1, 512, 512, 48, 1, 128, True),
    (2, 512, 512, 48, 1, 128, True),
    (1, 512, 512, 64, 8, 128, True),
    (1, 512, 512, 32, 32, 112, True),
    (1, 300, 300, 32, 8, 64, False),
    (1, 1, 1, 4, 1, 64, True),
    (2, 65, 65, 8, 2, 64, True),
    (1, 200, 70, 8, 2, 128, False),
    (1, 65, 130, 4, 4, 112, False),
    (1, 300, 1000, 16, 2, 128, True),
    (1, 1000, 300, 16, 2, 128, True),
    (1, 300, 1000, 8, 2, 64, False),
    (1, 512, 512, 16, 2, 128, True),
    (1, 700, 400, 24, 3, 112, False),
]
GRAD_KERNELS = ("flash_attention_bwd_prep", "flash_attention_bwd", "flash_attention_bwd_post")


@pytest.mark.cuda
@pytest.mark.parametrize("b,t,s,h,kv,hd,causal", FLASH_GRAD_CASES)
def test_flash_gradient_matches_plain(cuda, b, t, s, h, kv, hd, causal):
    """K3 under autograd on the card: its three backward kernels (counted
    once each) against mha_ref_bwd within 2e-2 of each gradient's max |g|
    (bf16 inputs, sums in another order); equal bits on two backward passes;
    the forward's output with lse equal in bits to the serve path's without
    it. A gradient that is exactly zero (one visible column: the softmax is
    constant) is held to 1e-5 absolute."""
    from repro_torch.kernels import ref

    qn, kn, vn, dn = inputs(29, (b, t, h, hd), (b, s, kv, hd), (b, s, kv, hd), (b, t, h, hd))
    q, k, v, do = (torch.from_numpy(x).to(cuda, torch.bfloat16) for x in (qn, kn, vn, dn))
    before = {n: build.launches(n) for n in ("flash_attention", *GRAD_KERNELS)}
    plain_before = ref.CALLS["mha_ref"] + ref.CALLS["mha_ref_bwd"]

    def grads():
        x = [a.clone().requires_grad_() for a in (q, k, v)]
        out = tflash.flash_attention(*x, causal=causal)
        return (out, *torch.autograd.grad(out, x, do))

    out, *got = grads()
    torch.cuda.synchronize()
    assert {n: build.launches(n) - c for n, c in before.items()} == {n: 1 for n in before}
    assert ref.CALLS["mha_ref"] + ref.CALLS["mha_ref_bwd"] == plain_before
    with torch.no_grad():
        assert torch.equal(out, tflash.flash_attention(q, k, v, causal=causal))
    want = tflash.plain_bwd(q, k, v, do, causal=causal)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == torch.bfloat16 and g.shape == w.shape
        assert torch.isfinite(g.float()).all(), name
        err = float((g.float() - w).abs().max())
        assert err <= RTOL * float(w.abs().max()) + 1e-5, (name, err, float(w.abs().max()))
    again = grads()[1:]
    assert all(torch.equal(a, c) for a, c in zip(got, again))  # no atomics: one fixed order


@pytest.mark.cuda
@pytest.mark.parametrize("b,t,h,kv,hd", [(1, 512, 48, 1, 128), (2, 512, 48, 1, 128), (1, 512, 16, 2, 128),
                                          (1, 300, 32, 8, 64)])
def test_flash_gradient_head_split_matches_one_block_per_group(cuda, monkeypatch, b, t, h, kv, hd):
    """Shapes whose grid cannot fill the card split the group's query heads
    over blocks: the split gradient stays within 2e-2 of mha_ref_bwd, gives
    equal bits on two launches, and differs from the unsplit sweep (one
    block per group, forced) only by the summation order of dk and dv (dq
    is summed in the same order either way: equal bits)."""
    q, k, v, do = (torch.from_numpy(x).to(cuda, torch.bfloat16)
                   for x in inputs(31, (b, t, h, hd), (b, t, kv, hd), (b, t, kv, hd), (b, t, h, hd)))
    lse = torch.empty(b, h, t, dtype=torch.float32, device=cuda)
    out32 = torch.empty(q.shape, dtype=torch.float32, device=cuda)
    tflash._forward(q, k, v, True, lse, out32)
    splits = tflash.grad_splits(b, t, kv, h // kv, tflash._sms(q.device))
    assert splits > 1
    split = tflash.backward(q, k, v, out32, lse, do, True)
    assert all(torch.equal(a, c) for a, c in zip(split, tflash.backward(q, k, v, out32, lse, do, True)))
    monkeypatch.setattr(tflash, "grad_splits", lambda *a: 1)
    whole = tflash.backward(q, k, v, out32, lse, do, True)
    assert torch.equal(split[0], whole[0])
    want = tflash.plain_bwd(q, k, v, do, causal=True)
    for g, w in zip(split[1:], want[1:]):
        assert float((g.float() - w).abs().max()) <= RTOL * float(w.abs().max())
    for g, c in zip(split[1:], whole[1:]):
        assert float((g.float() - c.float()).abs().max()) <= RTOL * float(c.float().abs().max())


@pytest.mark.cuda
def test_flash_gradient_through_a_model_layer_on_the_card(cuda):
    """A small dense model's loss backward on the card launches K3's forward
    and its three backward kernels once per layer, and never a plain version."""
    from repro_torch.configs import get_arch, reduced_config
    from repro_torch.kernels import ops
    from repro_torch.models.model import build_model
    import dataclasses

    cfg = dataclasses.replace(reduced_config(get_arch("llama3.2-1b")), d_model=256, d_head=64)
    model = build_model(cfg)
    params = model.init(0, device=cuda)
    leaves = [p.requires_grad_() for p in __import__("repro_torch").tree.leaves(params)]
    toks = torch.randint(0, cfg.vocab_size, (2, 130), device=cuda, dtype=torch.int32)
    batch = {"tokens": toks, "targets": toks.roll(-1, 1)}
    ops.reset_counts()
    loss, _ = model.loss_fn(params, batch)
    grads = torch.autograd.grad(loss, leaves)
    torch.cuda.synchronize()
    counts = ops.counts()
    assert [counts[n] for n in ("flash_attention", *GRAD_KERNELS)] == [2] * 4
    assert all(v == 0 for n, v in counts.items() if n.endswith("_ref") or n.endswith("_ref_bwd"))
    assert all(torch.isfinite(g.float()).all() for g in grads)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["decode_attention", "paged_decode_attention", "paged_chunk_attention"])
def test_kernel_refuses_an_input_that_requires_grad(cuda, kernel):
    """The three kernels without a backward: under grad mode, a CUDA input
    that requires grad raises before the launch (an output filled by the
    kernel would carry no gradient); under no_grad the kernel runs. K3, K5
    and K6 have their gradients (test_flash_gradient_matches_plain,
    test_moe_gmm_gradient_matches_plain, test_ssd_gradient_matches_plain)."""
    bf = dict(device=cuda, dtype=torch.bfloat16)
    one = torch.ones(1, dtype=torch.int32, device=cuda)
    pages = torch.zeros(3, 16, 2, 64, **bf)
    table = torch.ones(1, 2, dtype=torch.int32, device=cuda)
    x = torch.zeros(1, 8, 4, 64, **bf)
    call = {
        "decode_attention": lambda x: tdec.decode_attention(x[:, 0].contiguous(), torch.zeros(1, 16, 2, 64, **bf),
                                                            torch.zeros(1, 16, 2, 64, **bf), one),
        "paged_decode_attention": lambda x: tpaged.paged_decode_attention(x[:, 0].contiguous(), pages, pages, table,
                                                                          one),
        "paged_chunk_attention": lambda x: tpaged.paged_chunk_attention(x, pages, pages, table, one),
    }[kernel]
    with torch.enable_grad():
        with pytest.raises(RuntimeError, match="no backward on the card"):
            call(x.clone().requires_grad_())
    with torch.no_grad():
        out = call(x.clone().requires_grad_())
    torch.cuda.synchronize()
    assert torch.isfinite(out.float()).all()


def kernel_case(kernel, cuda, seed=0):
    """(call, args, mapped): one small call of ``kernel`` on the card; under
    vmap the ``mapped`` args take a leading lane axis and the others are
    shared by the lanes (the paged arena, the expert weights, the per-head
    SSM parameters)."""
    gen = torch.Generator(device=cuda).manual_seed(seed)

    def bf(*shape):
        return torch.randn(*shape, generator=gen, device=cuda).to(torch.bfloat16)

    def ints(lo, hi, *shape):
        return torch.randint(lo, hi, shape, generator=gen, device=cuda, dtype=torch.int32)

    if kernel == "flash_attention":
        return (lambda q, k, v: tflash.flash_attention(q, k, v, causal=True),
                (bf(2, 37, 8, 64), bf(2, 37, 2, 64), bf(2, 37, 2, 64)), (True, True, True))
    if kernel == "decode_attention":
        return tdec.decode_attention, (bf(2, 8, 64), bf(2, 300, 2, 64), bf(2, 300, 2, 64), ints(1, 301, 2)), \
            (True, True, True, True)
    if kernel == "paged_decode_attention":
        return tpaged.paged_decode_attention, (bf(2, 8, 64), bf(6, 16, 2, 64), bf(6, 16, 2, 64),
                                               ints(1, 6, 2, 3), ints(1, 49, 2)), (True, False, False, True, True)
    if kernel == "paged_chunk_attention":
        return tpaged.paged_chunk_attention, (bf(1, 16, 8, 64), bf(6, 16, 2, 64), bf(6, 16, 2, 64),
                                              ints(1, 6, 1, 3), ints(0, 33, 1)), (True, False, False, True, True)
    if kernel == "moe_gmm":
        return (lambda xe, w, rows: tgmm.moe_gmm(xe, w, rows, 4),
                (bf(4, 8, 64), bf(4, 64, 32), ints(0, 9, 4)), (True, False, True))
    assert kernel == "ssd_scan"
    dt = (torch.rand(1, 70, 2, generator=gen, device=cuda) * 0.1).contiguous()
    return (lambda x, bm, cm, dt, a, d: tssd.ssd_scan(x, bm, cm, dt, a, d, return_state=True),
            (bf(1, 70, 2, 64), bf(1, 70, 1, 64), bf(1, 70, 1, 64), dt,
             torch.randn(2, generator=gen, device=cuda), torch.randn(2, generator=gen, device=cuda)),
            (True, True, True, True, False, False))


def as_tuple(out):
    return out if isinstance(out, tuple) else (out,)


KERNELS = ["flash_attention", "decode_attention", "paged_decode_attention", "paged_chunk_attention",
           "moe_gmm", "ssd_scan"]


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", KERNELS)
def test_captured_kernel_replays_the_eager_bits_and_counts_each_replay(cuda, kernel):
    """A kernel captured in a CUDA graph (as a fused unit's second run
    captures it) gives an eager launch's bits at every replay, also on new
    values copied into its static inputs; the launch it made while captured
    is recorded, not counted, and each replay counts it once."""
    call, args, _ = kernel_case(kernel, cuda)
    with torch.no_grad():
        eager = as_tuple(call(*args))
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            call(*args)  # the warm-up a capture needs
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with build.LAUNCHES.recording() as rec:
            with torch.cuda.graph(graph, capture_error_mode="thread_local"):
                static_out = as_tuple(call(*args))
        assert rec == {kernel: 1}
        before = build.launches(kernel)
        for _ in range(3):
            graph.replay()
            build.LAUNCHES.add_replayed(rec)
        torch.cuda.synchronize()
        assert build.launches(kernel) == before + 3
        assert all(torch.equal(a, b) for a, b in zip(static_out, eager))
        _, fresh, _ = kernel_case(kernel, cuda, seed=1)
        for a, b in zip(args, fresh):
            a.copy_(b)
        graph.replay()
        want = as_tuple(call(*fresh))
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(static_out, want))


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", KERNELS)
def test_vmap_rule_on_the_card_equals_the_loop_over_lanes(cuda, kernel):
    """Under torch.func.vmap each kernel gives every lane the bits of a call
    on that lane alone: K1-K4 and K6 fold the lanes into their batch axis
    (one launch), K5 launches once per lane."""
    lanes = 3
    call, args, mapped = kernel_case(kernel, cuda)
    cases = [kernel_case(kernel, cuda, seed=s)[1] for s in range(lanes)]
    stacked = [torch.stack([c[i] for c in cases]) if m else a for i, (a, m) in enumerate(zip(args, mapped))]
    with torch.no_grad():
        before = build.launches(kernel)
        got = as_tuple(torch.func.vmap(call, in_dims=tuple(0 if m else None for m in mapped))(*stacked))
        torch.cuda.synchronize()
        assert build.launches(kernel) - before == (lanes if kernel == "moe_gmm" else 1)
        loop = [as_tuple(call(*[c[i] if m else a for i, (a, m) in enumerate(zip(args, mapped))])) for c in cases]
    for j, g in enumerate(got):
        assert torch.equal(g, torch.stack([out[j] for out in loop]))


@pytest.mark.cuda
@pytest.mark.parametrize("b", [1, 2])
def test_decode_kernel_reads_one_layer_of_stacked_caches_in_place(cuda, b):
    """A batched decode step stacks its lanes' layer-first caches, (lanes,
    L, B, S, KV, hd), and K4 reads one layer of them under vmap: the lanes
    fold into K4's batch axis as a view (sequences L * S rows apart when B
    is 1), with no copy of the cache, and give each lane the bits of K4 on
    a contiguous copy of its own layer. A layout whose sequences are not
    whole rows apart is refused."""
    lanes, layers, s, h, kv, hd = 3, 4, 300, 8, 2, 64
    gen = torch.Generator(device=cuda).manual_seed(2)
    k, v = (torch.randn(lanes, layers, b, s, kv, hd, generator=gen, device=cuda).to(torch.bfloat16)
            for _ in range(2))
    q = torch.randn(lanes, b, h, hd, generator=gen, device=cuda).to(torch.bfloat16)
    cur = torch.randint(1, s + 1, (lanes, b), generator=gen, device=cuda, dtype=torch.int32)
    layer = 2
    with torch.no_grad():
        before = build.launches("decode_attention")
        got = torch.func.vmap(lambda q, k, v, c: tdec.decode_attention(q, k[layer], v[layer], c))(q, k, v, cur)
        torch.cuda.synchronize()
        assert build.launches("decode_attention") - before == 1
        loop = torch.stack([tdec.decode_attention(q[i], k[i, layer].contiguous(), v[i, layer].contiguous(), cur[i])
                            for i in range(lanes)])
        assert torch.equal(got, loop)
        if b == 1:  # one launch on the stacked caches' own storage
            strided = k[:, layer].reshape(lanes, s, kv, hd)
            assert strided.data_ptr() == k[:, layer].data_ptr() and not strided.is_contiguous()
            direct = tdec.decode_attention(q[:, 0], strided, v[:, layer].reshape(lanes, s, kv, hd), cur[:, 0])
            assert torch.equal(direct, loop[:, 0])
        heads_first = k[0, layer].transpose(1, 2).contiguous().transpose(1, 2)  # (b, s, kv, hd), rows strided
        with pytest.raises(ValueError, match="contiguous"):
            tdec.decode_attention(q[0], heads_first, heads_first, cur[0])


GRAD_TOL = 2e-2  # of each gradient's max |g|: bf16 inputs, fp32 sums in another order


def rel_err(got, want) -> float:
    return float((got.float() - want.float()).abs().max() / want.float().abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("e,c,d,f,ragged", [
    (128, 640, 2048, 768, True),   # qwen3-moe-30b-a3b's gate/up at its train shape (2 x 4096 tokens)
    (128, 640, 768, 2048, True),   # its down-projection: w is (E, f, d)
    (8, 37, 64, 40, True),         # ragged edges of every tile
    (4, 64, 128, 64, False),       # every row kept (rows = None)
])
def test_moe_gmm_gradient_matches_plain(cuda, e, c, d, f, ragged):
    """K5's gradient against gmm_ref_bwd within 2e-2 of each output's max:
    one launch of each of its two kernels a call, equal bits on two calls
    and through autograd, exact zeros in dxe past rows[e] and in dw of an
    expert with no row."""
    gen = torch.Generator(device=cuda).manual_seed(e + c)
    rows = None
    keep = torch.ones(e, c, 1, dtype=torch.bool, device=cuda)
    if ragged:
        rows = torch.randint(0, c + 1, (e,), generator=gen, device=cuda, dtype=torch.int32)
        rows[0], rows[1] = 0, c
        keep = (torch.arange(c, device=cuda)[None] < rows[:, None])[..., None]
    xe = torch.randn(e, c, d, generator=gen, device=cuda).to(torch.bfloat16).masked_fill(~keep, 0)
    w = (torch.randn(e, d, f, generator=gen, device=cuda) * d ** -0.5).to(torch.bfloat16)
    dy = torch.randn(e, c, f, generator=gen, device=cuda).to(torch.bfloat16)
    before = {n: build.launches(n) for n in ("moe_gmm_bwd_dx", "moe_gmm_bwd_dw")}
    got = tgmm.backward(xe, w, rows, dy)
    torch.cuda.synchronize()
    assert {n: build.launches(n) - before[n] for n in before} == dict.fromkeys(before, 1)
    for g, want in zip(got, tgmm.plain_bwd(xe, w, rows, dy)):
        assert torch.isfinite(g.float()).all() and rel_err(g, want) <= GRAD_TOL
    assert all(torch.equal(a, b) for a, b in zip(got, tgmm.backward(xe, w, rows, dy)))
    x = [xe.clone().requires_grad_(), w.clone().requires_grad_()]
    auto = torch.autograd.grad(tgmm.moe_gmm(*x, rows), x, dy)
    assert all(torch.equal(a, b) for a, b in zip(got, auto))
    if ragged:
        assert (got[0].masked_select(~keep) == 0).all() and not got[1][0].any()


@pytest.mark.cuda
@pytest.mark.parametrize("b,t,h,g,n,with_state", [
    (1, 512, 32, 1, 128, False),   # mamba2-370m's heads over a state of 128
    (1, 300, 112, 1, 64, True),    # zamba2-7b's 112 heads over 64, a partial chunk
    (2, 130, 8, 2, 64, True),      # two groups, two sequences
    (1, 37, 4, 1, 128, True),      # one partial chunk
    (1, 64, 4, 1, 64, False),      # one whole chunk
])
def test_ssd_gradient_matches_plain(cuda, b, t, h, g, n, with_state):
    """K6's gradient against ssd_ref_bwd within 2e-2 of each output's max
    (dx, dB and dC summed over each group's heads, ddt, dA_log, dD), with and
    without the final state's cotangent: one launch of each of its two
    kernels a call, equal bits on two calls and through autograd."""
    gen = torch.Generator(device=cuda).manual_seed(t + h)
    x = torch.randn(b, t, h, 64, generator=gen, device=cuda).to(torch.bfloat16)
    bm, cm = ((torch.randn(b, t, g, n, generator=gen, device=cuda) * 0.5).to(torch.bfloat16) for _ in range(2))
    dt = torch.nn.functional.softplus(torch.randn(b, t, h, generator=gen, device=cuda))
    a_log = torch.randn(h, generator=gen, device=cuda) * 0.3
    d_skip = torch.randn(h, generator=gen, device=cuda)
    dy = torch.randn(b, t, h, 64, generator=gen, device=cuda).to(torch.bfloat16)
    ds = torch.randn(b, h, 64, n, generator=gen, device=cuda) if with_state else None
    ins = (x, bm, cm, dt, a_log, d_skip)
    before = {k: build.launches(k) for k in ("ssd_scan_bwd_walk", "ssd_scan_bwd_chunk")}
    got = tssd.backward(*ins, dy, ds)
    torch.cuda.synchronize()
    assert {k: build.launches(k) - before[k] for k in before} == dict.fromkeys(before, 1)
    for gr, want in zip(got, tssd.plain_bwd(*ins, dy, ds)):
        assert gr.dtype == want.dtype and torch.isfinite(gr.float()).all() and rel_err(gr, want) <= GRAD_TOL
    assert all(torch.equal(a, c) for a, c in zip(got, tssd.backward(*ins, dy, ds)))
    live = [v.clone().requires_grad_() for v in ins]
    y, state = tssd.ssd_scan(*live, return_state=True)
    outs, cot = ((y, state), (dy, ds)) if with_state else ((y,), (dy,))
    auto = torch.autograd.grad(outs, live, cot)
    assert all(torch.equal(a, c) for a, c in zip(got, auto))


@pytest.mark.cuda
@pytest.mark.parametrize("b,t,h,n", [(2, 512, 32, 128), (1, 300, 112, 64)])
def test_ssd_gradient_head_split_matches_one_block_per_group(cuda, monkeypatch, b, t, h, n):
    """The chunk kernel with a group's heads split over blocks (the
    wrapper's grad_splits, and two) against one block per group: dx, ddt,
    dA_log and dD equal bit for bit (each head is one block's), dB and dC
    (fp32 partials summed in split order, then rounded to bf16) within two
    bf16 roundings of their max."""
    gen = torch.Generator(device=cuda).manual_seed(h)
    x = torch.randn(b, t, h, 64, generator=gen, device=cuda).to(torch.bfloat16)
    bm, cm = ((torch.randn(b, t, 1, n, generator=gen, device=cuda) * 0.5).to(torch.bfloat16) for _ in range(2))
    dt = torch.nn.functional.softplus(torch.randn(b, t, h, generator=gen, device=cuda))
    a_log = torch.randn(h, generator=gen, device=cuda) * 0.3
    dy = torch.randn(b, t, h, 64, generator=gen, device=cuda).to(torch.bfloat16)
    ins = (x, bm, cm, dt, a_log, torch.ones(h, device=cuda), dy)
    split = [tssd.backward(*ins)]
    monkeypatch.setattr(tssd, "grad_splits", lambda *a: 2)
    split.append(tssd.backward(*ins))
    monkeypatch.setattr(tssd, "grad_splits", lambda *a: 1)
    whole = tssd.backward(*ins)
    for got in split:
        for i in (0, 3, 4, 5):
            assert torch.equal(got[i], whole[i])
        for i in (1, 2):
            assert rel_err(got[i], whole[i]) <= 2 ** -7


@pytest.mark.cuda
def test_ssd_gradient_kernel_rejects_what_it_does_not_take(cuda):
    """The backward takes a head dim of 64 only: another raises before any
    launch."""
    x = torch.zeros(1, 8, 2, 32, device=cuda, dtype=torch.bfloat16)
    bm = torch.zeros(1, 8, 1, 64, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head dim"):
        tssd.backward(x, bm, bm, torch.ones(1, 8, 2, device=cuda), torch.zeros(2, device=cuda),
                      torch.ones(2, device=cuda), x)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "mamba2-370m"])
def test_small_model_loss_backward_on_the_card_goes_through_the_gradients(cuda, arch):
    """A small MoE or SSM model's loss backward on the card: K5's (three
    products per MoE layer) or K6's (one per SSM layer) backward kernels
    launched, no plain backward called, every gradient finite."""
    import dataclasses

    from repro_torch import tree
    from repro_torch.configs import get_arch, reduced_config
    from repro_torch.kernels import ref
    from repro_torch.models.model import build_model
    from repro_torch.training.train_step import value_and_grad

    cfg = reduced_config(get_arch(arch))
    cfg = dataclasses.replace(cfg, d_model=256, **({"d_head": 64} if cfg.num_heads else {}),
                              **({"ssm_head_dim": 64, "ssm_state": 64} if cfg.ssm_state else {}))
    model = build_model(cfg)
    params = model.init(0, device=cuda)
    toks = torch.randint(0, cfg.vocab_size, (2, 129), device=cuda, dtype=torch.int32)
    names = ("moe_gmm_bwd_dx", "moe_gmm_bwd_dw") if cfg.family == "moe" else ("ssd_scan_bwd_walk", "ssd_scan_bwd_chunk")
    before = {k: build.launches(k) for k in names}
    plain = ref.CALLS["gmm_ref_bwd"] + ref.CALLS["ssd_ref_bwd"]
    loss, _, grads = value_and_grad(model, params, {"tokens": toks[:, :-1], "targets": toks[:, 1:]})
    torch.cuda.synchronize()
    per_layer = 3 if cfg.family == "moe" else 1
    assert {k: build.launches(k) - before[k] for k in names} == dict.fromkeys(names, per_layer * cfg.num_layers)
    assert ref.CALLS["gmm_ref_bwd"] + ref.CALLS["ssd_ref_bwd"] == plain
    assert torch.isfinite(loss) and all(torch.isfinite(g.float()).all() for g in tree.leaves(grads))
