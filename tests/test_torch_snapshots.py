"""The port's snapshot store and executable index (``repro_torch.checkpointing``,
``repro_torch.launch.compile_cache``): the cases of the JAX package's
``tests/test_checkpoint.py`` snapshot section and ``tests/test_coldstart.py``
digest and index section, on state made by the JAX package and bridged, plus
the port's own cases (bf16 stored as an int16 view, a 0-d leaf, tensors and
modules in closures, the device a leaf is restored to)."""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.checkpointing import SnapshotStore as RefStore  # noqa: E402

from repro_torch import tree  # noqa: E402
from repro_torch.checkpointing import SnapshotIntegrityError, SnapshotStore, snapshot_digest  # noqa: E402
from repro_torch.core import FunctionSpec  # noqa: E402
from repro_torch.core.function import _structs_of  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.launch.compile_cache import (  # noqa: E402
    ExecutableIndex,
    environment_key,
    members_digest,
    spec_digest,
)


def jax_state(seed=0):
    """tests/test_checkpoint.py's state: a bf16 matrix, an fp32 vector, a
    0-d int32 step and an fp32 matrix."""
    k = jax.random.PRNGKey(seed)
    return {
        "params": {
            "w": jax.random.normal(k, (8, 16)).astype(jnp.bfloat16),
            "b": jnp.arange(16, dtype=jnp.float32),
        },
        "opt": {"step": jnp.int32(7), "m": jnp.ones((8, 16), jnp.float32)},
    }


def bridge(state):
    """The JAX state as torch tensors of the same dtypes and bits (bf16 goes
    through float32, which holds every bf16 value exactly)."""
    def one(x):
        dt = {jnp.bfloat16: torch.bfloat16, jnp.float32: torch.float32, jnp.int32: torch.int32}[x.dtype.type]
        wide = np.asarray(x.astype(jnp.float32)) if x.dtype == jnp.bfloat16 else np.array(x)
        return torch.from_numpy(np.array(wide)).to(dt)

    return jax.tree.map(one, state)


def make_state(seed=0):
    return bridge(jax_state(seed))


def assert_tree_bits_equal(a, b):
    la, lb = tree.leaves(a), tree.leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape and x.device == y.device
        if x.dtype == torch.bfloat16:
            x, y = x.view(torch.int16), y.view(torch.int16)
        assert torch.equal(x, y)


# ------------------------------------------------------------ snapshot store


def test_snapshot_roundtrip_bit_exact_including_bf16(tmp_path):
    store = SnapshotStore(str(tmp_path))
    state = make_state()
    digest = store.put(state)
    assert store.contains(digest)
    restored = store.restore(digest, state)
    assert_tree_bits_equal(state, restored)
    assert restored["opt"]["step"].shape == ()  # the 0-d leaf stays 0-d
    # content address is a function of the bytes: restored re-hashes to it
    assert snapshot_digest(restored) == digest
    # bf16 is stored as its int16 view, its dtype recorded by name
    stored = np.load(os.path.join(store.path_of(digest), "leaf_00003.npy"))
    assert stored.dtype == np.int16 and stored.shape == (8, 16)


def test_snapshot_restores_the_bits_the_jax_store_restores(tmp_path):
    """The same state through both packages' stores: every leaf restores to
    the same values."""
    ref = RefStore(str(tmp_path / "ref"))
    want = ref.restore(ref.put(jax_state(2)), jax_state(2))
    store = SnapshotStore(str(tmp_path / "port"))
    got = store.restore(store.put(make_state(2)), make_state(2))
    assert_tree_bits_equal(got, bridge(want))


def test_snapshot_restore_into_structs(tmp_path):
    """Resurrect path: the parked spec keeps meta tensors and each leaf's
    device beside them."""
    store = SnapshotStore(str(tmp_path))
    state = make_state()
    digest = store.put(state)
    like = _structs_of(state)
    devices = tree.map(lambda x: str(x.device), state)
    assert_tree_bits_equal(state, store.restore(digest, like, devices=devices))
    with pytest.raises(ValueError, match="meta"):
        store.restore(digest, like)  # a meta tensor has no device of its own


def test_snapshot_of_a_cuda_leaf_is_never_restored_to_the_host(tmp_path):
    """A leaf recorded on the card is restored to the card, or the restore
    raises: it is never quietly put on the CPU."""
    store = SnapshotStore(str(tmp_path))
    state = make_state()
    digest = store.put(state)
    on_card = tree.map(lambda x: "cuda", state)
    if torch.cuda.is_available():
        got = store.restore(digest, _structs_of(state), devices=on_card)
        assert all(x.is_cuda for x in tree.leaves(got))
        assert_tree_bits_equal(state, tree.map(lambda x: x.cpu(), got))
    else:
        with pytest.raises((RuntimeError, AssertionError)):
            store.restore(digest, _structs_of(state), devices=on_card)


def test_snapshot_restore_splits_its_seconds(tmp_path):
    store = SnapshotStore(str(tmp_path))
    state = make_state()
    parts = {}
    store.restore(store.put(state), state, parts=parts)
    assert set(parts) == {"read_s", "verify_s", "copy_s"} and all(v >= 0 for v in parts.values())


def test_snapshot_put_dedups_identical_content(tmp_path):
    store = SnapshotStore(str(tmp_path))
    d1 = store.put(make_state(seed=3))
    d2 = store.put(make_state(seed=3))  # same bytes, fresh tree
    assert d1 == d2
    assert store.stats()["puts"] == 1
    assert store.stats()["dedup_hits"] == 1
    assert store.stats()["entries"] == 1


def test_snapshot_distinct_content_distinct_digests(tmp_path):
    store = SnapshotStore(str(tmp_path))
    assert store.put(make_state(seed=0)) != store.put(make_state(seed=1))
    assert store.stats()["entries"] == 2
    # the same bytes under another dtype are other content
    a = {"x": torch.zeros(4, dtype=torch.int16)}
    b = {"x": torch.zeros(4, dtype=torch.bfloat16)}
    assert snapshot_digest(a) != snapshot_digest(b)


def test_snapshot_retention_evicts_lru(tmp_path):
    store = SnapshotStore(str(tmp_path), retain=2)
    digests = [store.put(make_state(seed=s)) for s in range(4)]
    assert store.stats()["entries"] == 2
    assert store.stats()["evicted"] == 2
    assert store.contains(digests[-1])


def test_snapshot_corruption_detected(tmp_path):
    store = SnapshotStore(str(tmp_path))
    state = make_state()
    digest = store.put(state)
    leaf = os.path.join(store.path_of(digest), "leaf_00000.npy")
    raw = bytearray(open(leaf, "rb").read())
    raw[-4] ^= 0xFF
    open(leaf, "wb").write(bytes(raw))
    with pytest.raises(SnapshotIntegrityError):
        store.restore(digest, state)
    # verify=False is the caller's explicit opt-out
    store.restore(digest, state, verify=False)


def test_snapshot_missing_digest_raises(tmp_path):
    store = SnapshotStore(str(tmp_path))
    with pytest.raises(FileNotFoundError):
        store.restore("0" * 32, make_state())


# ------------------------------------------------------------ digest + index


def _leaf(ctx, params, x):
    return torch.tanh(x @ params["w"])


def _weights(seed, n=32):
    return {"w": torch.from_numpy(np.random.RandomState(seed).randn(n, n).astype(np.float32) * 0.1)}


def test_spec_digest_stable_and_distinguishes_params_shape():
    spec = FunctionSpec("f", _leaf, _weights(0))
    assert spec_digest(spec) == spec_digest(spec)  # memoized, deterministic
    # params are call arguments, not digest inputs: same fn = same digest
    assert spec_digest(spec) == spec_digest(FunctionSpec("f", _leaf, _weights(1)))
    assert spec_digest(spec) != spec_digest(FunctionSpec("g", _leaf, _weights(0)))


def test_spec_digest_sees_closure_values():
    """Two stages built from ONE factory share code objects and differ only
    in their closure cells."""

    def make_stage(scale):
        def fn(ctx, params, x):
            return x * scale

        return fn

    s0 = FunctionSpec("s", make_stage(2.0), {})
    s1 = FunctionSpec("s", make_stage(3.0), {})
    assert spec_digest(s0) != spec_digest(s1)


@pytest.mark.parametrize("numel", [16, 1 << 20])  # all bytes; 1024 samples of a 4 MiB tensor
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_spec_digest_sees_a_closure_tensor_by_value(numel, dtype):
    """Closures over two different tensors give two digests (the reference
    falls back to ``<opaque-array>`` for a tensor numpy cannot read, a bf16
    one here); over equal tensors, one."""

    def make(t):
        def fn(ctx, params, x):
            return x + t

        return fn

    a = torch.zeros(numel, dtype=dtype)
    b = a.clone()
    b[-1] = 1.0  # the last element is one of the samples
    assert spec_digest(FunctionSpec("s", make(a), {})) != spec_digest(FunctionSpec("s", make(b), {}))
    assert spec_digest(FunctionSpec("s", make(a), {})) == spec_digest(FunctionSpec("s", make(a.clone()), {}))


def test_spec_digest_never_confuses_two_modules():
    """An ``nn.Module``'s repr names its layers, not its weights: two modules
    with different weights must not share a digest; the same module must."""

    def make(m):
        def fn(ctx, params, x):
            return m(x)

        return fn

    m1, m2 = torch.nn.Linear(4, 4), torch.nn.Linear(4, 4)
    assert repr(m1) == repr(m2)
    with torch.no_grad():
        m2.weight.add_(1.0)
    assert spec_digest(FunctionSpec("s", make(m1), {})) != spec_digest(FunctionSpec("s", make(m2), {}))
    assert spec_digest(FunctionSpec("s", make(m1), {})) == spec_digest(FunctionSpec("s", make(m1), {}))


def test_members_digest_order_independent():
    a = FunctionSpec("a", _leaf, _weights(0))
    b = FunctionSpec("b", _leaf, _weights(1))
    assert members_digest({"a": a, "b": b}) == members_digest({"b": b, "a": a})


def test_environment_key_names_torch_the_device_and_the_kernel_sources():
    key = environment_key()
    assert len(key) == 3 and key == environment_key()
    assert key[0] == torch.__version__ and key[2] == build.source_hash()
    assert key[1] == "cpu" or key[1].startswith("cuda:sm_")


def test_executable_index_lru_and_counters():
    idx = ExecutableIndex(max_entries=2)
    e = dataclasses.make_dataclass("E", [("compile_s", float)])(0.5)
    idx.insert(("k1",), e)
    idx.insert(("k2",), e)
    assert idx.lookup(("k1",)) is e  # refreshes k1's recency
    idx.insert(("k3",), e)  # evicts k2, the least recently used
    assert idx.lookup(("k2",)) is None
    assert idx.lookup(("k1",)) is e
    assert idx.lookup(None) is None  # undigestable specs never hit
    s = idx.stats()
    assert s["entries"] == 2 and s["evictions"] == 1
    assert s["hits"] == 2 and s["misses"] == 1
    assert s["saved_s"] == pytest.approx(1.0)
