"""Weight-only int4 / int8 GEMMs: the CUDA kernels' wrappers, their plain
versions, and the dispatcher over every quantized linear leaf.

``int4_matmul`` replaces the Pallas ``_qmm4_kernel_v3`` and
``_qmm4_stacked_kernel_v3``, ``int8_matmul`` replaces ``_qmm_kernel`` and
``_qmm8_stacked_kernel`` (``painlessinferenceacceleration_tpu/ops/
quant_matmul.py``). A stacked weight's layer is a view ``q[li]``, so one
kernel serves the plain and the stacked form. The kernels
(``csrc/int4_gemm.cu``, ``csrc/int8_gemm.cu``) read the JAX layouts directly;
each source note says what bounds it and how its design answers that.
``quant_matmul`` sends activation-quantized and block-fp8 leaves on to
``ops/w8a8.py``.

A CPU tensor takes the plain version; a CUDA tensor launches the kernel or
raises. Each wrapper's ``launches`` counts its kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from painlessinferenceacceleration_tpu_torch import _build
from painlessinferenceacceleration_tpu_torch.layers.linear import (
    QuantSpec,
    dequantize,
)

_COLS_PER_BLOCK = 128  # kBlockN of every GEMM source under csrc/
CHUNK = 128  # K rows a warp takes at a time in the 8-bit GEMM sources
_TARGET_BLOCKS = 264  # two blocks for each of the H100's 132 SMs


def chunk_ksplit(n_chunks: int, N: int) -> int:
    """K splits of a GEMM kernel whose warps walk K in ``n_chunks`` chunks:
    enough blocks to fill the card, at least 8 chunks (one per warp) in each
    split. A function of (K, N) only, so a row's sum is taken in the same
    order at every M."""
    col_blocks = -(-N // _COLS_PER_BLOCK)
    want = -(-_TARGET_BLOCKS // col_blocks)
    return max(1, min(want, n_chunks // 8))


def ksplit_for(K: int, N: int, group: int) -> int:
    """K splits of the int4 kernel, whose chunks are the scale groups."""
    return chunk_ksplit(K // group, N)


def check_gemm_out(what: str, x: torch.Tensor, N: int, out_dtype, *others) -> None:
    """What every 8-bit GEMM kernel asks of its call: N % 4 == 0 (a thread
    loads four adjacent weight bytes as one word), bf16 or fp32 out, the
    other operands on x's CUDA device and starting on a 4-byte boundary."""
    if N % 4:
        raise ValueError(f"{what} needs N % 4 == 0 (N={N})")
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"{what} writes bf16 or fp32, not {out_dtype}")
    if not all(t.is_cuda and t.device == x.device for t in others):
        raise ValueError(f"{what} operands must be on one CUDA device")
    if any(t.data_ptr() % 4 for t in others):
        raise ValueError(f"{what} operands must start on a 4-byte boundary")


def int4_matmul_plain(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor,
                      out_dtype=None) -> torch.Tensor:
    """x [M, K] @ dequant(q, s) [K, N] in fp32, cast to ``out_dtype``."""
    w = dequantize({"q": q, "s": s}, QuantSpec(bits=4), torch.float32)
    return torch.matmul(x.to(torch.float32), w).to(out_dtype or x.dtype)


def _int4_matmul_cuda(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor,
                      out_dtype) -> torch.Tensor:
    M, K = x.shape
    N = q.shape[1]
    group = K // s.shape[0]
    if x.dtype != torch.bfloat16 or s.dtype != torch.bfloat16:
        raise TypeError("int4_gemm takes bf16 activations and bf16 scales")
    if q.dtype != torch.uint8 or q.shape[0] * 2 != K:
        raise ValueError(f"packed weight {tuple(q.shape)} does not match K={K}")
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"int4_gemm writes bf16 or fp32, not {out_dtype}")
    if group * s.shape[0] != K or group % 8 or group > 128 or N % 4:
        raise ValueError(f"int4_gemm needs group%8==0, group<=128, N%4==0 "
                         f"(K={K}, N={N}, group={group})")
    if not (q.is_cuda and s.is_cuda and q.device == x.device == s.device):
        raise ValueError("int4_gemm operands must be on one CUDA device")
    x, q, s = x.contiguous(), q.contiguous(), s.contiguous()
    out = torch.empty((M, N), dtype=out_dtype, device=x.device)
    ks = ksplit_for(K, N, group)
    work = (torch.empty((ks, M, N), dtype=torch.float32, device=x.device)
            if ks > 1 else None)
    lib = _build.library("int4_gemm")
    fn = lib.int4_gemm
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    err = fn(x.data_ptr(), q.data_ptr(), s.data_ptr(), out.data_ptr(),
             _build.ptr(work), M, K, N, group,
             int(out_dtype == torch.float32), ks, _build.stream_of(x))
    _build.check(lib, err, "int4_gemm")
    int4_matmul.launches += 1
    return out


def int4_matmul(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor,
                out_dtype=None) -> torch.Tensor:
    """x [..., K] @ dequant(q [K/2, N], s [K/g, N]) -> [..., N] in
    ``out_dtype`` (default x.dtype), fp32 accumulation."""
    out_dtype = out_dtype or x.dtype
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    if x.is_cuda:
        out = _int4_matmul_cuda(x2, q, s, out_dtype)
    elif x.device.type == "cpu":
        out = int4_matmul_plain(x2, q, s, out_dtype)
    else:
        raise NotImplementedError(f"int4_matmul on {x.device}")
    return out.reshape(*lead, q.shape[-1])


int4_matmul.launches = 0


def int8_matmul_plain(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor,
                      out_dtype=None) -> torch.Tensor:
    """x [M, K] @ dequant(q int8 [K, N], s [K/g, N]) in fp32, cast to
    ``out_dtype``."""
    w = dequantize({"q": q, "s": s}, QuantSpec(bits=8), torch.float32)
    return torch.matmul(x.to(torch.float32), w).to(out_dtype or x.dtype)


def _int8_matmul_cuda(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor,
                      out_dtype) -> torch.Tensor:
    M, K = x.shape
    N = q.shape[1]
    if x.dtype != torch.bfloat16 or s.dtype != torch.bfloat16:
        raise TypeError("int8_gemm takes bf16 activations and bf16 scales")
    if q.dtype != torch.int8 or q.shape[0] != K:
        raise ValueError(f"int8 weight {tuple(q.shape)} does not match K={K}")
    if s.shape[0] == 0 or K % s.shape[0] or s.shape[1] != N:
        raise ValueError(f"scales {tuple(s.shape)} do not group K={K}, N={N}")
    group = K // s.shape[0]
    x, q, s = x.contiguous(), q.contiguous(), s.contiguous()
    check_gemm_out("int8_gemm", x, N, out_dtype, q, s)
    out = torch.empty((M, N), dtype=out_dtype, device=x.device)
    # a chunk is at most CHUNK rows of one group
    ks = chunk_ksplit(s.shape[0] * -(-group // CHUNK), N)
    work = (torch.empty((ks, M, N), dtype=torch.float32, device=x.device)
            if ks > 1 else None)
    lib = _build.library("int8_gemm")
    fn = lib.int8_gemm
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    err = fn(x.data_ptr(), q.data_ptr(), s.data_ptr(), out.data_ptr(),
             _build.ptr(work), M, K, N, group,
             int(out_dtype == torch.float32), ks, _build.stream_of(x))
    _build.check(lib, err, "int8_gemm")
    int8_matmul.launches += 1
    return out


def int8_matmul(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor,
                out_dtype=None) -> torch.Tensor:
    """x [..., K] @ dequant(q int8 [K, N], s bf16 [K/g, N]) -> [..., N] in
    ``out_dtype`` (default x.dtype), fp32 accumulation."""
    out_dtype = out_dtype or x.dtype
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    if x.is_cuda:
        out = _int8_matmul_cuda(x2, q, s, out_dtype)
    elif x.device.type == "cpu":
        out = int8_matmul_plain(x2, q, s, out_dtype)
    else:
        raise NotImplementedError(f"int8_matmul on {x.device}")
    return out.reshape(*lead, q.shape[-1])


int8_matmul.launches = 0


def quant_matmul(x: torch.Tensor, p: dict, spec: QuantSpec,
                 out_dtype=None) -> torch.Tensor:
    """x [..., K] @ dequant(p) [K, N] -> [..., N] in ``out_dtype`` (default
    x.dtype): W8A8 and block-fp8 leaves go to ``ops.w8a8``, weight-only
    leaves by ``spec.bits``."""
    if spec.act is not None or spec.block:
        from painlessinferenceacceleration_tpu_torch.ops import w8a8

        return w8a8.w8a8_matmul(x, p, spec, out_dtype=out_dtype)
    if spec.bits == 8:
        return int8_matmul(x, p["q"], p["s"], out_dtype=out_dtype)
    if spec.bits == 4:
        return int4_matmul(x, p["q"], p["s"], out_dtype=out_dtype)
    raise ValueError(spec)
