"""Device selection and the build of the port's CUDA kernels.

The kernels live in ``csrc/*.cu`` with a plain C interface. On first use each
source is compiled by ``nvcc`` for Hopper (``sm_90a``) into a shared library
under ``build/torch_kernels/`` beside the package, all sources in parallel,
and loaded with ``ctypes``. A library's file name carries a hash of its
source, the shared headers (``csrc/*.cuh``) and the flags, so an edited
source is never served by a stale build.

The tensor-core GEMM sources (int4, int8, W8A8, block fp8, bf16, the e4m3 tied head), the paged, MLA
and linear attention sources, the norm and the KV compaction are compiled with
``-Xptxas -v``: the register,
shared-memory and spill report of each kernel is kept beside its library
(``ptxas_report``). ``BUILD_SECONDS`` holds each
source's compile time in the last ``build_all``.

Every C entry point returns ``cudaGetLastError()`` after its launches;
``check`` turns a non-zero code into an exception.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Optional

import torch

PKG_DIR = Path(__file__).resolve().parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR.parent / "build" / "torch_kernels"
SOURCES = ("int4_gemm", "int8_gemm", "w8a8_gemm", "block_fp8_gemm",
           "grouped_gemm", "grouped_int4_gemm", "grouped_int8_gemm",
           "paged_attention", "paged_attention_wide", "kv_permute", "kv_page_write",
           "mla_attention",
           "linear_attention", "rmsnorm", "kv_rows", "fp8_head_gemm")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)

# sources whose build keeps ptxas's resource report (registers, shared
# memory, spills): the tensor-core GEMMs, whose accumulators must stay in
# registers, the paged, MLA and linear attention kernels, and the norm and
# the KV compaction, which hold rows in registers and shared memory
VERBOSE_SOURCES = ("int4_gemm", "grouped_int4_gemm", "int8_gemm", "grouped_int8_gemm",
                   "w8a8_gemm", "block_fp8_gemm", "grouped_gemm", "paged_attention",
                   "paged_attention_wide", "mla_attention", "rmsnorm", "kv_permute", "linear_attention",
                   "fp8_head_gemm")

_LIBS: Dict[str, ctypes.CDLL] = {}
_FNS: Dict[tuple, tuple] = {}
BUILD_SECONDS: Dict[str, float] = {}


def resolve_device(device=None) -> torch.device:
    """``cuda`` unless the caller asks for another device; never falls back."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA was requested but torch.cuda is not available")
    return dev


def _nvcc() -> str:
    for home in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH")):
        if home and (Path(home) / "bin" / "nvcc").exists():
            return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")  # the toolkit's usual home
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")


def _lib_path(name: str) -> Path:
    src = (CSRC_DIR / f"{name}.cu").read_bytes()
    for header in sorted(CSRC_DIR.glob("*.cuh")):  # shared device code
        src += header.read_bytes()
    tag = hashlib.sha1(src + " ".join(_flags(name)).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}_{tag}.so"


def _flags(name: str) -> tuple:
    return NVCC_FLAGS + (("-Xptxas", "-v") if name in VERBOSE_SOURCES else ())


def ptxas_report(name: str) -> str:
    """ptxas's resource lines for ``name``'s kernels ("" if not kept)."""
    path = _lib_path(name).with_suffix(".ptxas.txt")
    return path.read_text() if path.exists() else ""


def build_all() -> None:
    """Compile every missing library, one ``nvcc`` per source, all at once."""
    todo = [n for n in SOURCES if not _lib_path(n).exists()]
    if not todo:
        return
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    t0 = time.perf_counter()
    for name in todo:
        out = _lib_path(name)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        log = out.with_suffix(f".{os.getpid()}.log")
        cmd = [nvcc, *_flags(name), "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
        with open(log, "w") as f:
            procs[name] = (subprocess.Popen(cmd, stdout=f, stderr=subprocess.STDOUT),
                           tmp, out, log)
    errors = []
    while procs:
        for name, (proc, tmp, out, log) in list(procs.items()):
            if proc.poll() is None:
                continue
            BUILD_SECONDS[name] = time.perf_counter() - t0
            text = log.read_text()
            log.unlink()
            del procs[name]
            if proc.returncode != 0:
                errors.append(f"nvcc failed for {name}.cu:\n{text}")
                continue
            if name in VERBOSE_SOURCES:
                out.with_suffix(".ptxas.txt").write_text(text)
            os.replace(tmp, out)
        time.sleep(0.05)
    if errors:
        raise RuntimeError("\n".join(errors))


def library(name: str) -> ctypes.CDLL:
    """The loaded kernel library ``name`` (built on first use)."""
    lib = _LIBS.get(name)
    if lib is None:
        path = _lib_path(name)
        if not path.exists():
            build_all()
        lib = ctypes.CDLL(str(path))
        lib.pia_error_string.restype = ctypes.c_char_p
        lib.pia_error_string.argtypes = [ctypes.c_int]
        _LIBS[name] = lib
    return lib


def function(name: str, symbol: str, argtypes: tuple):
    """(library, entry point) of ``symbol`` in library ``name`` with its
    ``argtypes`` set once: a wrapper called hundreds of times a step skips
    ctypes' per-call setup."""
    key = (name, symbol)
    hit = _FNS.get(key)
    if hit is None or hit[0] is not _LIBS.get(name):
        lib = library(name)
        fn = getattr(lib, symbol)
        fn.argtypes = list(argtypes)
        hit = _FNS[key] = (lib, fn)
    return hit


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    if err != 0:
        msg = lib.pia_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


def ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def stream_of(t: torch.Tensor) -> int:
    """The raw handle of the current stream on ``t``'s device (the call
    that builds a ``torch.cuda.Stream`` object costs a decode-size GEMM's
    worth of host time)."""
    return torch._C._cuda_getCurrentRawStream(t.device.index)


_SCRATCH: Dict[torch.device, torch.Tensor] = {}
_COUNTERS: Dict[torch.device, torch.Tensor] = {}


def _grow(table: dict, what: str, device: torch.device, n: int, make) -> torch.Tensor:
    buf = table.get(device)
    if buf is None or buf.numel() < n:
        if device.type == "cuda" and torch.cuda.is_current_stream_capturing():
            raise RuntimeError(f"{what}: {n} elements needed while a CUDA graph is "
                               "captured; make one call of this size before the capture")
        buf = table[device] = make(n)
    return buf


def scratch(device: torch.device, numel: int) -> torch.Tensor:
    """fp32 scratch of at least ``numel`` elements on ``device`` (a GEMM's K
    split planes), kept between calls and grown when a call needs more:
    each call would otherwise pay an allocation.

    One buffer a device, shared by every call: correct only while those
    calls run in order on one stream (a buffer it replaces is freed in that
    stream's order). A CUDA graph that captured a call keeps the buffer's
    address, so it may be replayed only while no later call has grown the
    buffer; growing it during a capture raises."""
    return _grow(_SCRATCH, "scratch", device, numel,
                 lambda n: torch.empty(n, dtype=torch.float32, device=device))


def tile_counters(device: torch.device, n: int) -> torch.Tensor:
    """``n`` int32 zeros on ``device``, kept between calls: the counters of
    a GEMM whose K splits run as blocks (the last block of a tile to finish
    adds the splits and sets its counter back to zero). Like ``scratch``,
    one buffer a device: calls that use it run in order on one stream, and
    a captured graph is replayed only while it has not grown."""
    return _grow(_COUNTERS, "tile_counters", device, n,
                 lambda n: torch.zeros(n, dtype=torch.int32, device=device))
