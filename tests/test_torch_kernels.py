"""The port's kernels K3 (flash_attention) and K4 (decode_attention).

On the CPU: the plain versions against the JAX Pallas kernels (interpret
mode) and the JAX oracles, over the sweep of test_kernels.py, on the same
inputs made with numpy; the wrappers' dispatch, shape inference and input
checks. The kernels themselves are held against their plain versions on the
card by test_torch_kernels_cuda.py.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)  # the suite runs several workers at once: leave them cores

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.decode_attention import decode_attention as jax_decode  # noqa: E402
from repro.kernels.flash_attention import flash_attention as jax_flash  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import decode_attention as tdec  # noqa: E402
from repro_torch.kernels import flash_attention as tflash  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def tol(name):
    return dict(rtol=2e-2, atol=2e-2) if name == "bfloat16" else dict(rtol=2e-5, atol=2e-5)


def inputs(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def both(x, name):
    jdt, tdt = DTYPES[name]
    return jnp.asarray(x).astype(jdt), torch.from_numpy(x).to(tdt)


def as_np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x.astype(jnp.float32))


# ------------------------------------------------------------ CPU: plain versions vs JAX


@pytest.mark.parametrize("b,t,h,kv,hd", [
    (2, 256, 4, 2, 64),
    (1, 128, 8, 8, 32),
    (2, 256, 4, 1, 64),   # MQA
    (1, 512, 2, 2, 128),
])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_plain_matches_jax(b, t, h, kv, hd, causal, dtype):
    qn, kn, vn = inputs(7, (b, t, h, hd), (b, t, kv, hd), (b, t, kv, hd))
    (jq, q), (jk, k), (jv, v) = both(qn, dtype), both(kn, dtype), both(vn, dtype)
    got = as_np(tflash.flash_attention(q, k, v, causal=causal))  # CPU -> plain version
    np.testing.assert_allclose(got, as_np(jref.mha_ref(jq, jk, jv, causal=causal)), **tol(dtype))
    pallas = jax_flash(jq, jk, jv, causal=causal, block_q=t, block_k=t, interpret=True)
    np.testing.assert_allclose(got, as_np(pallas), **tol(dtype))


@pytest.mark.parametrize("b,s,h,kv,hd", [(2, 512, 4, 2, 64), (3, 1024, 8, 1, 32)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_plain_matches_jax(b, s, h, kv, hd, dtype):
    qn, kn, vn = inputs(11, (b, h, hd), (b, s, kv, hd), (b, s, kv, hd))
    cur = np.random.default_rng(3).integers(1, s, size=(b,)).astype(np.int32)
    (jq, q), (jk, k), (jv, v) = both(qn, dtype), both(kn, dtype), both(vn, dtype)
    got = as_np(tdec.decode_attention(q, k, v, torch.from_numpy(cur)))
    np.testing.assert_allclose(got, as_np(jref.decode_attn_ref(jq, jk, jv, jnp.asarray(cur))), **tol(dtype))
    pallas = jax_decode(jq, jk, jv, jnp.asarray(cur), block_k=s, interpret=True)
    np.testing.assert_allclose(got, as_np(pallas), **tol(dtype))


def test_decode_plain_exact_zeros_at_empty_cache():
    qn, kn, vn = inputs(5, (3, 4, 16), (3, 32, 2, 16), (3, 32, 2, 16))
    cur = torch.tensor([0, 5, 0], dtype=torch.int32)
    out = ref.decode_attn_ref(torch.from_numpy(qn), torch.from_numpy(kn), torch.from_numpy(vn), cur)
    assert torch.equal(out[0], torch.zeros_like(out[0]))
    assert torch.equal(out[2], torch.zeros_like(out[2]))
    assert torch.isfinite(out).all() and out[1].abs().sum() > 0


def test_decode_plain_lse_weighs_a_split_cache():
    """K4's plain version with ``return_lse``: the heads' logsumexp of their
    scaled scores over the valid rows (a numpy logsumexp; -inf at an empty
    cache), and the output unchanged beside it. Two halves of the cache,
    each attended alone and weighed by exp(lse), give the whole cache's
    output: the combine of a cache split over a mesh."""
    b, s, h, kv, hd = 3, 40, 8, 2, 16
    qn, kn, vn = inputs(7, (b, h, hd), (b, s, kv, hd), (b, s, kv, hd))
    q, k, v = (torch.from_numpy(x) for x in (qn, kn, vn))
    cur = torch.tensor([0, 17, 33], dtype=torch.int32)
    out, lse = ops.decode_attention(q, k, v, cur, return_lse=True)
    assert torch.equal(out, ops.decode_attention(q, k, v, cur))
    scores = np.einsum("bkgh,bskh->bkgs", qn.reshape(b, kv, h // kv, hd), kn) / np.sqrt(hd)
    for i, n in enumerate(cur.tolist()):
        if n == 0:
            assert torch.isneginf(lse[i]).all()
            continue
        sc = scores[i, ..., :n].astype(np.float64)
        want = sc.max(-1) + np.log(np.exp(sc - sc.max(-1, keepdims=True)).sum(-1))
        np.testing.assert_allclose(lse[i].numpy(), want.reshape(h), rtol=1e-5, atol=1e-5)
    half = s // 2
    parts = [ops.decode_attention(q, k[:, lo:lo + half].contiguous(), v[:, lo:lo + half].contiguous(),
                                  torch.clamp(cur - lo, 0, half).to(torch.int32), return_lse=True)
             for lo in (0, half)]
    lses = torch.stack([p[1] for p in parts])
    gmax = lses.amax(0)
    w = torch.where(torch.isneginf(gmax), 0.0, torch.exp(lses - gmax))
    combined = sum(wi[..., None] * p[0] for wi, p in zip(w, parts)) / torch.clamp(w.sum(0), min=1e-30)[..., None]
    np.testing.assert_allclose(combined[1:].numpy(), out[1:].numpy(), rtol=1e-5, atol=1e-6)


def test_ops_shape_inference_on_meta():
    ops.reset_counts()
    q = torch.empty(2, 37, 8, 64, dtype=torch.bfloat16, device="meta")
    k = torch.empty(2, 37, 2, 64, dtype=torch.bfloat16, device="meta")
    out = ops.attention(q, k, k, causal=True)
    assert out.device.type == "meta" and out.shape == q.shape and out.dtype == q.dtype
    qd = torch.empty(2, 8, 64, dtype=torch.bfloat16, device="meta")
    kd = torch.empty(2, 512, 2, 64, dtype=torch.bfloat16, device="meta")
    cur = torch.empty(2, dtype=torch.int32, device="meta")
    out = ops.decode_attention(qd, kd, kd, cur)
    assert out.device.type == "meta" and out.shape == qd.shape
    out, lse = ops.decode_attention(qd, kd, kd, cur, return_lse=True)
    assert out.shape == qd.shape and lse.shape == (2, 8) and lse.dtype == torch.float32 and lse.is_meta
    assert set(ops.counts().values()) == {0}


def test_cpu_tensors_take_the_plain_version_and_are_counted():
    ops.reset_counts()
    qn, kn = inputs(2, (1, 8, 4, 16), (1, 8, 2, 16))
    q, k = torch.from_numpy(qn), torch.from_numpy(kn)
    ops.attention(q, k, k)
    ops.decode_attention(q[:, 0], k, k, torch.tensor([8], dtype=torch.int32))
    assert ops.counts() == {**dict.fromkeys(ops.counts(), 0), "mha_ref": 1, "decode_attn_ref": 1}


@pytest.mark.parametrize("case,exc", [
    ("float32", TypeError),
    ("head_dim_32", ValueError),
    ("non_contiguous", ValueError),
    ("gqa_mismatch", ValueError),
])
def test_kernel_input_checks_raise(case, exc):
    """What the kernels do not take raises before any launch."""
    q = torch.zeros(1, 16, 8, 64, dtype=torch.bfloat16)
    k = torch.zeros(1, 16, 2, 64, dtype=torch.bfloat16)
    if case == "float32":
        q, k = q.float(), k.float()
    elif case == "head_dim_32":
        q, k = q[..., :32].contiguous(), k[..., :32].contiguous()
    elif case == "non_contiguous":
        q = torch.zeros(1, 8, 16, 64, dtype=torch.bfloat16).transpose(1, 2)
    elif case == "gqa_mismatch":
        k = torch.zeros(1, 16, 3, 64, dtype=torch.bfloat16)
    with pytest.raises(exc):
        tflash._check(q, k, k)
    with pytest.raises(exc):
        tdec._check(q[:, 0], k, k, torch.zeros(1, dtype=torch.int32))


FAKE_NVCC = """#!/bin/sh
echo "$@" >> "$FAKE_NVCC_LOG"
prev=""
for a in "$@"; do
  if [ "$prev" = "-o" ]; then touch "$a"; fi
  prev="$a"
done
"""


def test_build_compiles_each_source_for_sm90a_links_once_and_reuses(tmp_path, monkeypatch):
    """The build around the kernels, with a stand-in for nvcc that records
    its arguments and writes its outputs."""
    nvcc = tmp_path / "cuda" / "bin" / "nvcc"
    nvcc.parent.mkdir(parents=True)
    nvcc.write_text(FAKE_NVCC)
    nvcc.chmod(0o755)
    log = tmp_path / "calls.txt"
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "cuda"))
    monkeypatch.setenv("FAKE_NVCC_LOG", str(log))
    monkeypatch.setattr(build, "BUILD_ROOT", tmp_path / "build")
    lib = build.build()
    assert lib.exists() and lib.parent == tmp_path / "build" / build.source_hash()
    calls = log.read_text().splitlines()
    compiles = [c for c in calls if " -c " in c]
    assert len(compiles) == len(build.SOURCES) and len(calls) == len(build.SOURCES) + 1
    assert all("-gencode arch=compute_90a,code=sm_90a" in c for c in calls)
    assert sorted(c.split(" -c ")[1].split()[0].rsplit("/", 1)[1] for c in compiles) == sorted(build.SOURCES)
    assert not list(lib.parent.glob("*.o"))
    assert build.build() == lib and len(log.read_text().splitlines()) == len(calls)  # built once


def test_build_hash_covers_every_included_header(tmp_path, monkeypatch):
    """Every header a source includes by a relative path is listed in
    HEADERS, and changing one rebuilds: the library's hash moves with it."""
    import re
    import shutil

    included = {m for name in build.SOURCES
                for m in re.findall(r'#include "([^"]+)"', (build.CSRC / name).read_text())}
    assert included and included <= set(build.HEADERS)
    csrc = tmp_path / "csrc"
    shutil.copytree(build.CSRC, csrc)
    monkeypatch.setattr(build, "CSRC", csrc)
    before = build.source_hash()
    header = csrc / build.HEADERS[0]
    header.write_text(header.read_text() + "\n// changed\n")
    assert build.source_hash() != before
