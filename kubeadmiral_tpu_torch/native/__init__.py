"""The port's native (C++) host library.

A copy of ``kubeadmiral_tpu/native/__init__.py`` without the sequential
baseline (``seqsched.cpp``, which the port is held against): ``load()``
returns the ctypes handle to the FNV hashing library built from
``fnvhash.cpp``, and ``load_fastcopy()`` the ``copy`` callable of the
CPython extension built from ``fastcopy.cpp``.  Both are built with g++
at first use into the package's ``_build/`` directory (beside the
phase-1 kernel), named by the hash of their source and flags (and of the
interpreter's ABI for the extension), so an edited source rebuilds.  A
build goes to a temporary file renamed into place, so concurrent
builds (test workers, several processes) never load a half-written
library.  Without g++ or Python's headers the loaders return None and
the callers take their pure-Python paths, which give the same values.

``status()`` says which parts loaded and how long each build took.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import sysconfig
import threading
import time
from pathlib import Path
from typing import Optional

_DIR = Path(__file__).resolve().parent
BUILD_DIR = _DIR.parent / "_build"
HASH_SOURCE = _DIR / "fnvhash.cpp"
FASTCOPY_SOURCE = _DIR / "fastcopy.cpp"
CXX_FLAGS = ("-O3", "-shared", "-fPIC")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_load_failed = False
_fastcopy_mod = None
_fastcopy_failed = False
# Per part: "native" or "python", the build's seconds (0.0 when the
# library was already built) and the failure, if any.
_status: dict[str, dict] = {}


def _configure(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.kadm_fnv32.restype = ctypes.c_uint32
    lib.kadm_fnv32.argtypes = [ctypes.c_char_p, ctypes.c_size_t]
    lib.kadm_fnv32a.restype = ctypes.c_uint32
    lib.kadm_fnv32a.argtypes = [ctypes.c_char_p, ctypes.c_size_t]
    lib.kadm_fnv32_batch.restype = None
    lib.kadm_fnv32_batch.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_uint64),
        ctypes.c_size_t,
        ctypes.c_char_p,
        ctypes.c_size_t,
        ctypes.POINTER(ctypes.c_uint32),
    ]
    lib.kadm_fnv32_extend_batch.restype = None
    lib.kadm_fnv32_extend_batch.argtypes = [
        ctypes.POINTER(ctypes.c_uint32),
        ctypes.c_size_t,
        ctypes.c_char_p,
        ctypes.c_size_t,
    ]
    return lib


def _compile(source: Path, stem: str, extra_flags: tuple = (), key: str = "") -> Path:
    """``source`` built into ``_build/<stem>_<digest>.so`` (the digest of
    the source, the flags and ``key``) unless that file exists; the
    library's path.  Raises when g++ fails."""
    flags = CXX_FLAGS + tuple(extra_flags)
    digest = hashlib.sha256(
        source.read_bytes() + " ".join(flags).encode() + key.encode()
    ).hexdigest()[:16]
    library = BUILD_DIR / f"{stem}_{digest}.so"
    if library.exists():
        return library
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = library.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    try:
        subprocess.run(
            ["g++", *flags, "-o", str(tmp), str(source)],
            check=True, capture_output=True, timeout=120,
        )
        os.replace(tmp, library)
    finally:
        if tmp.exists():
            tmp.unlink()
    return library


def _timed_build(part: str, build):
    t0 = time.perf_counter()
    try:
        out = build()
    except Exception as exc:  # no compiler, no headers, a failed build
        _status[part] = {"path": "python", "build_s": time.perf_counter() - t0,
                         "error": f"{type(exc).__name__}: {exc}"[:300]}
        return None
    _status[part] = {"path": "native", "build_s": time.perf_counter() - t0, "error": None}
    return out


def load() -> Optional[ctypes.CDLL]:
    """The FNV hashing library (built at first use), or None."""
    global _lib, _load_failed
    if _lib is not None or _load_failed:
        return _lib
    with _lock:
        if _lib is None and not _load_failed:
            _lib = _timed_build(
                "fnvhash",
                lambda: _configure(ctypes.CDLL(str(_compile(HASH_SOURCE, "libkadmhash")))),
            )
            _load_failed = _lib is None
    return _lib


def load_fastcopy():
    """The ``copy`` callable of the ``_kadmfastcopy`` extension (built at
    first use against this interpreter's headers), or None."""
    global _fastcopy_mod, _fastcopy_failed
    if _fastcopy_mod is not None or _fastcopy_failed:
        return getattr(_fastcopy_mod, "copy", None)
    with _lock:
        if _fastcopy_mod is None and not _fastcopy_failed:
            _fastcopy_mod = _timed_build("fastcopy", _build_fastcopy)
            _fastcopy_failed = _fastcopy_mod is None
    return getattr(_fastcopy_mod, "copy", None)


def _build_fastcopy():
    import importlib.util

    include = sysconfig.get_paths()["include"]
    if not (Path(include) / "Python.h").exists():
        raise FileNotFoundError(f"no Python.h under {include}")
    library = _compile(
        FASTCOPY_SOURCE, "_kadmfastcopy", (f"-I{include}",),
        key=sysconfig.get_config_var("EXT_SUFFIX") or "",
    )
    spec = importlib.util.spec_from_file_location("_kadmfastcopy", library)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def status() -> dict:
    """Per part ("fnvhash", "fastcopy"): the path it takes ("native" or
    "python"), its build seconds and the build's failure; a part not
    loaded yet is absent."""
    return {part: dict(v) for part, v in _status.items()}
