"""ctypes bindings for the native C++ trie (``csrc/trie.cpp``).

The port's own copy of ``painlessinferenceacceleration_tpu/lookahead/
native.py``. ``NativeDraftCache`` is a drop-in for the hot subset of
``DraftCache`` (put / stream_put / hier_get / par_get / one_get / bat_get,
save and load); ``make_draft_cache`` in ``lookahead/generate.py`` picks it
when the library builds. The library is compiled on first use with ``g++``
from the port's source into ``build/trie/`` beside the package (the JAX
package builds its own copy beside its source; the two never share a file),
its name carrying a hash of the source and the flags, so an edited source
is never served by a stale build.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional

import numpy as np

from painlessinferenceacceleration_tpu_torch.lookahead.trie import parallelize_draft

PKG_DIR = Path(__file__).resolve().parent.parent
SRC = PKG_DIR / "csrc" / "trie.cpp"
BUILD_DIR = PKG_DIR.parent / "build" / "trie"
GXX_FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC")

_MODE = {"mix": 0, "input": 1, "output": 2}


def lib_path() -> Path:
    tag = hashlib.sha1(SRC.read_bytes() + " ".join(GXX_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"libpia_trie_{tag}.so"


def build_native() -> Optional[Path]:
    """Compile the shared library if it is missing; its path, or None when
    there is no ``g++`` or the build fails."""
    lib = lib_path()
    if lib.exists():
        return lib
    gxx = shutil.which("g++")
    if gxx is None:
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([gxx, *GXX_FLAGS, "-o", str(tmp), str(SRC)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        return None
    os.replace(tmp, lib)
    return lib


_dll = None


def load_native():
    """The loaded library (built if necessary), or None."""
    global _dll
    if _dll is not None:
        return _dll
    lib = build_native()
    if lib is None:
        return None
    d = ctypes.CDLL(str(lib))
    d.pia_cache_new.restype = ctypes.c_void_p
    d.pia_cache_new.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int64,
    ]
    d.pia_cache_free.argtypes = [ctypes.c_void_p]
    d.pia_cache_add_stop_word.argtypes = [ctypes.c_void_p, ctypes.c_int32]
    d.pia_cache_put.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int32,
    ]
    d.pia_cache_stream_put.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int32,
    ]
    d.pia_cache_hier_get.restype = ctypes.c_int
    d.pia_cache_hier_get.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int32, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p,
    ]
    d.pia_cache_one_get.restype = ctypes.c_int
    d.pia_cache_one_get.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int32, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ]
    d.pia_cache_save.restype = ctypes.c_int
    d.pia_cache_save.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    d.pia_cache_load.restype = ctypes.c_int
    d.pia_cache_load.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    d.pia_cache_fresh.argtypes = [ctypes.c_void_p]
    _dll = d
    return d


def _i32(arr) -> np.ndarray:
    return np.ascontiguousarray(arr, dtype=np.int32)


class NativeDraftCache:
    """Native counterpart of ``lookahead.trie.DraftCache`` (hot subset)."""

    def __init__(self, eos_ids=(2,), stop_words=None, max_node: int = 65536,
                 max_output_node: int = 512, squeeze_every: int = 1024):
        d = load_native()
        if d is None:
            raise RuntimeError("native trie unavailable (no g++, or its build failed)")
        self._d = d
        eos = _i32(list(eos_ids) or [])
        self._h = d.pia_cache_new(
            eos.ctypes.data if len(eos) else None, len(eos),
            max_node, max_output_node, squeeze_every,
        )
        for w in stop_words or ():
            d.pia_cache_add_stop_word(self._h, int(w))
        # reusable output buffers
        self._cap = 512
        self._ids = np.zeros(self._cap, np.int32)
        self._mask = np.zeros(self._cap * self._cap, np.uint8)
        self._par = np.zeros(self._cap, np.int32)
        self._sizes = np.zeros(2, np.int32)

    def __del__(self):
        h = getattr(self, "_h", None)
        if h is not None:
            self._d.pia_cache_free(h)
            self._h = None

    def put(self, token_ids, branch_length=8, final=False, mode="output", idx=0):
        a = _i32(token_ids)
        self._d.pia_cache_put(
            self._h, a.ctypes.data, len(a), branch_length, int(final),
            0 if mode == "output" else 1, idx,
        )

    def stream_put(self, token_ids, branch_length=8, final=False, idx=0):
        a = _i32(token_ids)
        self._d.pia_cache_stream_put(
            self._h, a.ctypes.data, len(a), branch_length, int(final), idx
        )

    def _unpack(self, n):
        ids = self._ids[:n].tolist()
        mask = self._mask[: n * n].reshape(n, n).astype(np.int64)
        parents = self._par[:n].tolist()
        sizes = self._sizes.tolist()
        return ids, mask, parents, sizes

    def hier_get(self, token_ids, decoding_length=64, branch_length=8,
                 min_input_size=0, min_output_size=0, mode="mix", idx=0):
        q = _i32(token_ids)
        n = self._d.pia_cache_hier_get(
            self._h, q.ctypes.data, len(q), min(decoding_length, self._cap),
            branch_length, min_input_size, min_output_size, _MODE[mode], idx,
            self._ids.ctypes.data, self._mask.ctypes.data,
            self._par.ctypes.data, self._sizes.ctypes.data,
        )
        return self._unpack(n)

    def one_get(self, token_ids, decoding_length=64, branch_length=8,
                min_input_size=0, min_output_size=0, mode="mix", idx=0):
        q = _i32(token_ids)
        n = self._d.pia_cache_one_get(
            self._h, q.ctypes.data, len(q), min(decoding_length, self._cap),
            branch_length, _MODE[mode], idx,
            self._ids.ctypes.data, self._mask.ctypes.data,
            self._par.ctypes.data, self._sizes.ctypes.data,
        )
        return self._unpack(n)

    def par_get(self, token_ids, decoding_length=16, branch_length=8,
                min_input_size=0, min_output_size=0, mode="mix", idx=0):
        got = self.hier_get(
            token_ids, decoding_length=decoding_length,
            branch_length=branch_length, min_input_size=min_input_size,
            min_output_size=min_output_size, mode=mode, idx=idx,
        )
        return parallelize_draft(*got)

    def bat_get(self, token_id_list, decoding_length=64, branch_length=8,
                mode="output", indices=None, decoding_mode="hier"):
        """Batched retrieval with the reference's per-request sub-budget
        (lookahead_cache.py:519-561): the same contract as DraftCache.bat_get."""
        bs = len(token_id_list)
        indices = indices if indices is not None else list(range(bs))
        sub = max(decoding_length // max(bs, 1), 1)
        getter = self.hier_get if decoding_mode == "hier" else self.one_get
        return [
            getter(
                q, decoding_length=sub, branch_length=branch_length,
                min_input_size=0, min_output_size=max(sub // 2, 1),
                mode=mode, idx=idx,
            )
            for q, idx in zip(token_id_list, indices)
        ]

    def fresh(self) -> None:
        self._d.pia_cache_fresh(self._h)

    def save_mem(self, path: str) -> None:
        """Binary trie snapshot (the format differs from DraftCache's)."""
        rc = self._d.pia_cache_save(self._h, str(path).encode())
        if rc != 0:
            raise IOError(f"pia_cache_save failed ({rc}) for {path!r}")

    def load_mem(self, path: str) -> None:
        rc = self._d.pia_cache_load(self._h, str(path).encode())
        if rc != 0:
            raise IOError(f"pia_cache_load failed ({rc}) for {path!r}")
