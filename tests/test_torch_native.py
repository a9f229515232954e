"""The port's native host library against its pure-Python paths and the
JAX package's module.

Each FNV hash (``fnv32``, ``fnv32a``, ``fnv32_batch``, ``fnv32_extend``
in both forms, ``stable_json_hash``) gives the same value through the
port's native library, its pure-Python path and the JAX package's
``utils/hashing.py``, over seeded and hypothesis inputs (exact).
``copy_json`` through the port's C extension equals its pure-Python
copy and the JAX package's, a non-JSON node included (the C path then
deep-copies the whole object, as JAX's does).  Two processes building
the library into one empty directory at once both load it.
"""

import copy
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from kubeadmiral_tpu.utils import hashing as jax_hashing
from kubeadmiral_tpu.utils import unstructured as jax_unstructured
from kubeadmiral_tpu_torch import native
from kubeadmiral_tpu_torch.utils import hashing, unstructured

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def lib():
    lib = native.load()
    assert lib is not None, native.status()
    assert native.status()["fnvhash"]["path"] == "native"
    return lib


def _seeded_bytes(seed: int, n: int) -> list[bytes]:
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, int(rng.integers(0, 300)), dtype=np.uint8).tobytes()
            for _ in range(n)]


def test_scalar_hashes_three_ways(lib):
    for data in [b"", b"a", b"cluster-1/default/web"] + _seeded_bytes(1, 200):
        assert hashing.fnv32(data) == hashing.fnv32_py(data) == jax_hashing.fnv32(data)
        assert hashing.fnv32a(data) == hashing.fnv32a_py(data) == jax_hashing.fnv32a(data)
    assert hashing.fnv32(b"a") == 0x050C5D7E and hashing.fnv32a(b"a") == 0xE40C292C


def test_batch_and_extend_three_ways(lib):
    rng = np.random.default_rng(2)
    prefixes = [f"member-{int(i):05d}" for i in rng.integers(0, 99999, 300)]
    for suffix in ("", "default/web", "ns-3/workload-000017"):
        got = hashing.fnv32_batch(prefixes, suffix)
        want = np.array([hashing.fnv32_py((p + suffix).encode()) for p in prefixes], np.uint32)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, jax_hashing.fnv32_batch(prefixes, suffix))
        states = np.array([hashing.fnv32_py(p.encode()) for p in prefixes], np.uint32)
        ext = hashing.fnv32_extend(states, suffix.encode())
        np.testing.assert_array_equal(ext, want)
        np.testing.assert_array_equal(ext, jax_hashing.fnv32_extend(states, suffix.encode()))
        for s, w in zip(states[:20], want[:20]):
            got_scalar = hashing.fnv32_extend(int(s), suffix.encode())
            assert isinstance(got_scalar, int)
            assert got_scalar == hashing.fnv32_extend_py(int(s), suffix.encode()) == int(w)
            assert got_scalar == jax_hashing.fnv32_extend(int(s), suffix.encode())
    assert hashing.fnv32_batch([], "x").shape == (0,)


@settings(max_examples=200, deadline=None)
@given(st.binary(max_size=200), st.binary(max_size=40), st.lists(st.text(max_size=12), max_size=8))
def test_hashes_hypothesis(lib, data, tail, prefixes):
    assert hashing.fnv32(data) == hashing.fnv32_py(data) == jax_hashing.fnv32(data)
    assert hashing.fnv32a(data) == hashing.fnv32a_py(data) == jax_hashing.fnv32a(data)
    state = hashing.fnv32(data)
    assert hashing.fnv32_extend(state, tail) == hashing.fnv32(data + tail)
    assert hashing.fnv32_extend(state, tail) == jax_hashing.fnv32_extend(state, tail)
    np.testing.assert_array_equal(
        hashing.fnv32_batch(prefixes, tail.hex()), jax_hashing.fnv32_batch(prefixes, tail.hex())
    )


JSON = st.recursive(
    st.none() | st.booleans() | st.integers() | st.floats(allow_nan=False) | st.text(max_size=8),
    lambda inner: st.lists(inner, max_size=4)
    | st.dictionaries(st.text(max_size=6), inner, max_size=4)
    | st.tuples(inner, inner),
    max_leaves=20,
)


@settings(max_examples=200, deadline=None)
@given(JSON)
def test_stable_json_hash_and_copy_hypothesis(lib, value):
    h = hashing.stable_json_hash(value)
    assert h == hashing.stable_json_hash_py(value) == jax_hashing.stable_json_hash(value)
    got = unstructured.copy_json(value)
    assert got == unstructured._copy_json_py(value) == jax_unstructured.copy_json(value)


def test_copy_json_native_semantics(lib):
    assert native.load_fastcopy() is not None, native.status()
    obj = {"spec": {"replicas": 3, "tags": ["a", "b"], "pair": (1, [2])}, "k": "v"}
    got = unstructured.copy_json(obj)
    assert got == obj == jax_unstructured.copy_json(obj)
    assert got["spec"] is not obj["spec"] and got["spec"]["tags"] is not obj["spec"]["tags"]
    assert got["spec"]["pair"][1] is not obj["spec"]["pair"][1]
    assert got["k"] is obj["k"]  # immutable leaves shared


class _Node:
    def __init__(self, v):
        self.v = v

    def __eq__(self, other):
        return isinstance(other, _Node) and other.v == self.v


def test_copy_json_non_json_node_copies_whole(lib):
    """A non-JSON node makes the C path deep-copy the whole object, as
    the JAX package's does: a leaf string list is then a copy too, and
    the value equals the pure-Python copy's and JAX's."""
    shared = ["x"]
    obj = {"a": {"node": _Node([1, 2])}, "b": shared, "c": {1, 2}}
    got = unstructured.copy_json(obj)
    theirs = jax_unstructured.copy_json(obj)
    assert got == theirs == unstructured._copy_json_py(obj) == copy.deepcopy(obj)
    assert got["a"]["node"] is not obj["a"]["node"]
    assert got["a"]["node"].v is not obj["a"]["node"].v
    assert got["b"] is not shared and theirs["b"] is not shared
    cyclic = {"k": []}
    cyclic["k"].append(cyclic)
    again = unstructured.copy_json(cyclic)
    assert again["k"][0] is again


def test_two_processes_build_at_once(tmp_path):
    """Two processes building both libraries into one empty directory at
    the same time each load a whole library (the temporary-file rename)
    and hash alike."""
    code = textwrap.dedent(f"""
        import sys
        from pathlib import Path
        sys.path.insert(0, {str(ROOT)!r})
        from kubeadmiral_tpu_torch import native
        native.BUILD_DIR = Path({str(tmp_path)!r})
        lib = native.load()
        copy = native.load_fastcopy()
        assert lib is not None and copy is not None, native.status()
        print(lib.kadm_fnv32a(b"cluster-1/default/web", 21), copy({{"a": [1]}}))
    """)
    procs = [
        subprocess.Popen([sys.executable, "-c", code], stdout=subprocess.PIPE,
                         stderr=subprocess.PIPE, text=True)
        for _ in range(2)
    ]
    outs = [p.communicate(timeout=300) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err[-2000:]
    want = f"{hashing.fnv32a_py(b'cluster-1/default/web')} {{'a': [1]}}"
    assert [o.strip() for o, _e in outs] == [want, want]
    built = sorted(q.name for q in tmp_path.iterdir())
    assert len(built) == 2 and all(name.endswith(".so") for name in built), built
