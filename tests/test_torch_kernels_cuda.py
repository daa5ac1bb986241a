"""The hand-written kernels K3 (flash_attention) and K4 (decode_attention)
against their plain versions, on the card.

Every test here is marked ``cuda`` and skips on a host without a CUDA
device. The file imports no JAX, so it runs where only PyTorch is
installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import decode_attention as tdec  # noqa: E402
from repro_torch.kernels import flash_attention as tflash  # noqa: E402

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
])
def test_flash_kernel_matches_plain(cuda, b, t, s, h, kv, hd, causal):
    qn, kn, vn = inputs(13, (b, t, h, hd), (b, s, kv, hd), (b, s, kv, hd))
    q, k, v = (torch.from_numpy(x).to(cuda, torch.bfloat16) for x in (qn, kn, vn))
    before = tflash.launches
    got = tflash.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert tflash.launches == before + 1
    want = tflash.plain(q, k, v, causal=causal)
    np.testing.assert_allclose(as_np(got), as_np(want), rtol=RTOL, atol=ATOL)


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,h,kv,hd", [(1, 512, 32, 8, 64), (4, 512, 32, 8, 64), (3, 300, 8, 2, 128)])
def test_decode_kernel_matches_plain(cuda, b, s, h, kv, hd):
    qn, kn, vn = inputs(17, (b, h, hd), (b, s, kv, hd), (b, s, kv, hd))
    q, k, v = (torch.from_numpy(x).to(cuda, torch.bfloat16) for x in (qn, kn, vn))
    cur = torch.from_numpy(np.random.default_rng(4).integers(1, s + 1, size=(b,)).astype(np.int32)).to(cuda)
    cur[0] = 1
    before = tdec.launches
    got = tdec.decode_attention(q, k, v, cur)
    torch.cuda.synchronize()
    assert tdec.launches == before + 1
    np.testing.assert_allclose(as_np(got), as_np(tdec.plain(q, k, v, cur)), rtol=RTOL, atol=ATOL)
    zeros = tdec.decode_attention(q, k, v, torch.zeros_like(cur))
    assert torch.equal(zeros, torch.zeros_like(zeros))


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
