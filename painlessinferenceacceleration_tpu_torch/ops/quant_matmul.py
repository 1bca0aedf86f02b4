"""int4 weight-only GEMM: the CUDA kernel's wrapper and its plain version.

Replaces the Pallas ``_qmm4_kernel_v3`` and ``_qmm4_stacked_kernel_v3``
(``painlessinferenceacceleration_tpu/ops/quant_matmul.py``). A stacked
weight's layer is a view ``q[li]``, so one kernel serves both. The kernel
(``csrc/int4_gemm.cu``) reads the JAX packed layout directly; its source
note says what bounds it and how its design answers that.

A CPU tensor takes the plain version; a CUDA tensor launches the kernel or
raises. ``int4_matmul.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from painlessinferenceacceleration_tpu_torch import _build
from painlessinferenceacceleration_tpu_torch.layers.linear import dequantize

_COLS_PER_BLOCK = 128  # csrc/int4_gemm.cu kBlockN
_TARGET_BLOCKS = 264  # two blocks for each of the H100's 132 SMs


def ksplit_for(K: int, N: int, group: int) -> int:
    """K splits of the kernel: enough blocks to fill the card, at least 8
    groups (one per warp) in each split. A function of (K, N) only, so a
    row's sum is taken in the same order at every M."""
    col_blocks = -(-N // _COLS_PER_BLOCK)
    want = -(-_TARGET_BLOCKS // col_blocks)
    return max(1, min(want, (K // group) // 8))


def int4_matmul_plain(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor,
                      out_dtype=None) -> torch.Tensor:
    """x [M, K] @ dequant(q, s) [K, N] in fp32, cast to ``out_dtype``."""
    w = dequantize({"q": q, "s": s}, dtype=torch.float32)
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
