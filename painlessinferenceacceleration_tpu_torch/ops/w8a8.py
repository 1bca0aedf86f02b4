"""W8A8 activation-quantized GEMMs: int8 and e4m3 with per-channel weight
scales, and the 128x128-block e4m3 format.

Port of ``painlessinferenceacceleration_tpu/ops/w8a8.py``. ``quant_act``
quantizes the activations in plain torch on every device, as the JAX
package does it outside its kernels. ``w8a8_gemm`` replaces the Pallas
``_w8a8_kernel`` and ``_w8a8_stacked_kernel`` (``csrc/w8a8_gemm.cu``),
``block_fp8_gemm`` replaces ``_block_fp8_kernel`` and
``_block_fp8_stacked_kernel`` (``csrc/block_fp8_gemm.cu``); a stacked
weight's layer is a view, so one kernel serves both forms. Both run on the
8-bit tensor cores through one body (``csrc/w8a8_wgmma.cuh``) and take K %
16 == 0 and N % 16 == 0 only (``w8a8_check``, ``block_fp8_check``;
``check_w8a8_params`` refuses a model with another shape before its first
launch); ``w8a8_plan`` and ``block_fp8_plan`` are their launch plans. Both take the operands already quantized and apply every
scale in the kernel, in fp32 and in the order of the plain version, with
one rounding at the end. (The Pallas per-channel kernel rounds to bf16
before its wrapper multiplies by the activation scale; the port follows the
oracle ``w8a8_matmul_ref``, not that double rounding.)

A CPU tensor takes the plain version; a CUDA tensor launches the kernel or
raises. ``w8a8_gemm.launches`` / ``block_fp8_gemm.launches`` count kernel
launches, ``w8a8_gemm.modes`` by operand format.
"""

from __future__ import annotations

import collections
import ctypes
import functools
from typing import Optional

import torch
import torch.nn.functional as F

from painlessinferenceacceleration_tpu_torch import _build
from painlessinferenceacceleration_tpu_torch.layers.linear import FP8_MAX, QuantSpec
from painlessinferenceacceleration_tpu_torch.ops.quant_matmul import (
    GemmPlan,
    aligned16,
    check_gemm_out,
    quant_leaves,
    stage_split,
    tile_grid,
)

INT8_MAX = 127.0
FP8 = torch.float8_e4m3fn
# the block-fp8 format's edge: in the kernel one ring stage (a K block) and
# one block's columns (a column block)
BLOCK = 128


def _qmax(spec: QuantSpec) -> float:
    return FP8_MAX if spec.wfmt == "fp8" else INT8_MAX


def pow2_snap(s: torch.Tensor) -> torch.Tensor:
    """``exp2(floor(log2 s + .5))`` for positive fp32 scales, with the power
    of two built from its exponent bits so that it is exact on every
    device."""
    e = torch.floor(torch.log2(s) + 0.5).to(torch.int32)
    return ((e + 127) << 23).view(torch.float32)


def quant_act(x2: torch.Tensor, spec: QuantSpec,
              xs_static: Optional[torch.Tensor] = None,
              amax: Optional[torch.Tensor] = None):
    """Quantize activations x2 [M, K] per spec: (xq, xs) with xs [M] per
    token, or [M, ceil(K/block)] for the block format (the last K block is
    zero-padded for its amax). Static specs use the calibrated scalar
    ``xs_static``. ``amax`` [M] fp32 replaces the per-token amax of a
    dynamic spec: x2 is a K-shard of rows whose whole amax it is (a
    row-parallel rank's slice), so the shard is quantized as the whole rows
    are. e4m3 values are clipped to +-448 before the cast: torch's cast does
    not saturate, and a static or pow2-snapped scale can put values past
    it. int8 rounds half to even and clips to +-127."""
    qmax = _qmax(spec)
    xf = x2.to(torch.float32)
    M, K = x2.shape
    if spec.block:
        B = spec.block
        kb = -(-K // B)
        xg = F.pad(xf, (0, kb * B - K)).reshape(M, kb, B)
        xs = torch.clamp(xg.abs().amax(dim=-1) / qmax, min=1e-8)
        if spec.act_pow2:
            xs = pow2_snap(xs)
        xq = xg / xs[:, :, None]
    elif spec.act == "static":
        if xs_static is None:
            raise ValueError("a static-act leaf needs its 'xs' scale")
        xs = xs_static.to(torch.float32).reshape(()).expand(M).contiguous()
        xq = xf / xs[:, None]
    else:
        xs = torch.clamp((xf.abs().amax(dim=-1) if amax is None else amax) / qmax, min=1e-8)
        xq = xf / xs[:, None]
    if spec.wfmt == "fp8":
        xq = torch.clamp(xq, -FP8_MAX, FP8_MAX).to(FP8)
    else:
        xq = torch.clamp(torch.round(xq), -127, 127).to(torch.int8)
    if spec.block:
        xq = xq.reshape(M, -1)[:, :K].contiguous()
    return xq, xs


def calibrate_act_scale(samples: torch.Tensor, spec: QuantSpec) -> torch.Tensor:
    """Static activation scale from calibration activations [.., K]."""
    amax = samples.to(torch.float32).abs().max()
    return torch.clamp(amax / _qmax(spec), min=1e-8)


# ---------------------------------------------------------------------------
# plain versions (the CPU path and the kernels' oracle)
# ---------------------------------------------------------------------------


def w8a8_gemm_plain(xq: torch.Tensor, xs: torch.Tensor, q: torch.Tensor,
                    s: torch.Tensor, out_dtype) -> torch.Tensor:
    """((xq @ q) * xs[m]) * s[n]: int8 operands through an exact integer
    product (fp64 holds every sum), e4m3 operands through fp32."""
    if q.dtype == torch.int8:
        acc = torch.matmul(xq.to(torch.float64), q.to(torch.float64)).to(torch.float32)
    else:
        acc = torch.matmul(xq.to(torch.float32), q.to(torch.float32))
    return (acc * xs[:, None] * s[None, :]).to(out_dtype)


def block_fp8_gemm_plain(xq: torch.Tensor, xs: torch.Tensor, q: torch.Tensor,
                         s: torch.Tensor, out_dtype) -> torch.Tensor:
    """sum_kb ((xq[:, kb] @ q[kb]) * xs[m, kb]) * s[kb, n/128], the partials
    added in ascending kb, all in fp32."""
    M, N = xq.shape[0], q.shape[1]
    acc = torch.zeros((M, N), dtype=torch.float32, device=xq.device)
    for kb in range(s.shape[0]):
        rows = slice(kb * BLOCK, (kb + 1) * BLOCK)
        part = torch.matmul(xq[:, rows].to(torch.float32), q[rows].to(torch.float32))
        sn = s[kb].repeat_interleave(BLOCK)[:N]
        acc = acc + part * xs[:, kb:kb + 1] * sn[None, :]
    return acc.to(out_dtype)


def w8a8_matmul_ref(x2: torch.Tensor, p: dict, spec: QuantSpec,
                    out_dtype=None) -> torch.Tensor:
    """x2 [M, K] @ W8A8 weights -> [M, N]: ``quant_act`` and the plain GEMM."""
    od = out_dtype or x2.dtype
    xq, xs = quant_act(x2, spec, p.get("xs"))
    if spec.block:
        return block_fp8_gemm_plain(xq, xs, p["q"], p["s"], od)
    return w8a8_gemm_plain(xq, xs, p["q"], p["s"], od)


# ---------------------------------------------------------------------------
# the W8A8 kernel's launch plan (csrc/w8a8_wgmma.cuh)
# ---------------------------------------------------------------------------

W8A8_STAGE = 128  # k rows of one ring stage: a 128-byte swizzle row of 8-bit values


def w8a8_check(K: int, N: int) -> None:
    """Raise on a shape the W8A8 kernel does not take: TMA copies rows
    whose strides are whole multiples of 16 bytes, so K % 16 == 0 (the
    activations' rows) and N % 16 == 0 (the weight's)."""
    if K <= 0 or K % 16 or N <= 0 or N % 16:
        raise ValueError(f"the W8A8 kernel needs K % 16 == 0 and N % 16 == 0 "
                         f"(K={K}, N={N})")


@functools.lru_cache(maxsize=None)
def w8a8_plan(M: int, K: int, N: int) -> GemmPlan:
    """The W8A8 kernel's launch: a K split of 128-k stages from (K, N)
    alone (``stage_split``), so that a row's sum is taken in the same order
    at every M, on the grid of ``tile_grid``."""
    w8a8_check(K, N)
    ks, sps = stage_split(K, N, W8A8_STAGE)
    return GemmPlan(ks, sps, *tile_grid(M, N, ks))


def block_fp8_check(K: int, N: int) -> None:
    """Raise on a shape the block-fp8 kernel does not take: the W8A8
    kernel's rule (its body), K % 16 == 0 and N % 16 == 0."""
    if K <= 0 or K % 16 or N <= 0 or N % 16:
        raise ValueError(f"the block-fp8 kernel needs K % 16 == 0 and N % 16 == 0 "
                         f"(K={K}, N={N})")


@functools.lru_cache(maxsize=None)
def block_fp8_plan(M: int, K: int, N: int) -> GemmPlan:
    """The block-fp8 kernel's launch: a K split of 128-k stages (one scale
    block each) from (K, N) alone (``stage_split``), so that a row's sum is
    taken in the same order at every M, on the grid of ``tile_grid``."""
    block_fp8_check(K, N)
    ks, sps = stage_split(K, N, BLOCK)
    return GemmPlan(ks, sps, *tile_grid(M, N, ks))


def check_w8a8_params(params) -> None:
    """Raise, before the first launch, on an activation-quantized weight of
    ``params`` whose shape its kernel does not take: a per-channel W8A8
    leaf (int8 or e4m3 ``q`` [.., K, N] with fp32 scales ``s`` [.., N],
    ``w8a8_check``) or a block-fp8 leaf (e4m3 ``q`` with fp32 block scales
    ``s`` of ``q``'s rank, ``block_fp8_check``): such a model does not run
    on the card."""
    for p in quant_leaves(params):
        q, s = p["q"], p["s"]
        if (q.dtype not in (torch.int8, FP8) or not isinstance(s, torch.Tensor)
                or s.dtype != torch.float32):
            continue
        if s.dim() == q.dim() - 1 and s.shape[-1] == q.shape[-1]:
            w8a8_check(q.shape[-2], q.shape[-1])
        elif q.dtype == FP8 and s.dim() == q.dim():
            block_fp8_check(q.shape[-2], q.shape[-1])


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

_W8A8_ARGS = (ctypes.c_void_p,) * 6 + (ctypes.c_int,) * 8 + (ctypes.c_void_p,)


def _w8a8_gemm_cuda(xq, xs, q, s, out_dtype) -> torch.Tensor:
    M, K = xq.shape
    N = q.shape[1]
    if q.dtype not in (torch.int8, FP8) or xq.dtype != q.dtype:
        raise TypeError(f"w8a8_gemm takes int8 or e4m3 operands of one type, "
                        f"not {xq.dtype}/{q.dtype}")
    if q.shape[0] != K or tuple(s.shape) != (N,) or tuple(xs.shape) != (M,):
        raise ValueError(f"w8a8_gemm shapes: xq {tuple(xq.shape)}, xs {tuple(xs.shape)}, "
                         f"q {tuple(q.shape)}, s {tuple(s.shape)}")
    if s.dtype != torch.float32 or xs.dtype != torch.float32:
        raise TypeError("w8a8_gemm takes fp32 scales")
    plan = w8a8_plan(M, K, N)
    xq, xs, q, s = aligned16(xq), xs.contiguous(), q.contiguous(), s.contiguous()
    check_gemm_out("w8a8_gemm", xq, N, out_dtype, xs, q, s)
    if q.data_ptr() % 16:
        raise ValueError("w8a8_gemm needs the weight on a 16-byte boundary")
    out = torch.empty((M, N), dtype=out_dtype, device=xq.device)
    # s32 partial sums for int8 operands, fp32 for e4m3: 4 bytes either way
    work = (torch.empty((plan.grid[2], M, N), dtype=torch.float32, device=xq.device)
            if plan.grid[2] > 1 else None)
    fp8 = q.dtype == FP8
    lib, fn = _build.function("w8a8_gemm", "w8a8_gemm", _W8A8_ARGS)
    err = fn(xq.data_ptr(), xs.data_ptr(), q.data_ptr(), s.data_ptr(),
             out.data_ptr(), _build.ptr(work), M, K, N, int(fp8),
             int(out_dtype == torch.float32), plan.grid[2], plan.stages_per_split,
             plan.warpgroups, _build.stream_of(xq))
    _build.check(lib, err, "w8a8_gemm")
    w8a8_gemm.launches += 1
    w8a8_gemm.modes["fp8" if fp8 else "int8"] += 1
    return out


def w8a8_gemm(xq: torch.Tensor, xs: torch.Tensor, q: torch.Tensor,
              s: torch.Tensor, out_dtype=torch.bfloat16) -> torch.Tensor:
    """((xq [M, K] @ q [K, N]) * xs [M]) * s [N] -> [M, N]; xq and q both
    int8 (exact int32 accumulation) or both e4m3 (fp32 accumulation). On the
    card K % 16 == 0 and N % 16 == 0 (``w8a8_check``)."""
    if xq.is_cuda:
        return _w8a8_gemm_cuda(xq, xs, q, s, out_dtype)
    if xq.device.type != "cpu":
        raise NotImplementedError(f"w8a8_gemm on {xq.device}")
    return w8a8_gemm_plain(xq, xs, q, s, out_dtype)


w8a8_gemm.launches = 0
w8a8_gemm.modes = collections.Counter()


_BLOCK_FP8_ARGS = (ctypes.c_void_p,) * 6 + (ctypes.c_int,) * 7 + (ctypes.c_void_p,)


def _block_fp8_gemm_cuda(xq, xs, q, s, out_dtype) -> torch.Tensor:
    M, K = xq.shape
    N = q.shape[1]
    nkb, nnb = -(-K // BLOCK), -(-N // BLOCK)
    if q.dtype != FP8 or xq.dtype != FP8:
        raise TypeError(f"block_fp8_gemm takes e4m3 operands, not {xq.dtype}/{q.dtype}")
    if q.shape[0] != K or tuple(s.shape) != (nkb, nnb) or tuple(xs.shape) != (M, nkb):
        raise ValueError(f"block_fp8_gemm shapes: xq {tuple(xq.shape)}, xs {tuple(xs.shape)}, "
                         f"q {tuple(q.shape)}, s {tuple(s.shape)} (block {BLOCK})")
    if s.dtype != torch.float32 or xs.dtype != torch.float32:
        raise TypeError("block_fp8_gemm takes fp32 scales")
    plan = block_fp8_plan(M, K, N)
    xq, xs, q, s = aligned16(xq), xs.contiguous(), q.contiguous(), s.contiguous()
    check_gemm_out("block_fp8_gemm", xq, N, out_dtype, xs, q, s)
    if q.data_ptr() % 16:
        raise ValueError("block_fp8_gemm needs the weight on a 16-byte boundary")
    out = torch.empty((M, N), dtype=out_dtype, device=xq.device)
    blocks = plan.grid[2]
    work = (torch.empty((blocks, M, N), dtype=torch.float32, device=xq.device)
            if blocks > 1 else None)  # the splits' planes
    lib, fn = _build.function("block_fp8_gemm", "block_fp8_gemm", _BLOCK_FP8_ARGS)
    err = fn(xq.data_ptr(), xs.data_ptr(), q.data_ptr(), s.data_ptr(), out.data_ptr(),
             _build.ptr(work), M, K, N, int(out_dtype == torch.float32), blocks,
             plan.stages_per_split, plan.warpgroups, _build.stream_of(xq))
    _build.check(lib, err, "block_fp8_gemm")
    block_fp8_gemm.launches += 1
    return out


def block_fp8_gemm(xq: torch.Tensor, xs: torch.Tensor, q: torch.Tensor,
                   s: torch.Tensor, out_dtype=torch.bfloat16) -> torch.Tensor:
    """sum_kb ((xq[:, kb] @ q[kb]) * xs[m, kb]) * s[kb, n/128] -> [M, N] for
    e4m3 operands, xs [M, ceil(K/128)], s [ceil(K/128), ceil(N/128)]; edge
    blocks may be partial. On the card K % 16 == 0 and N % 16 == 0
    (``block_fp8_check``)."""
    if xq.is_cuda:
        return _block_fp8_gemm_cuda(xq, xs, q, s, out_dtype)
    if xq.device.type != "cpu":
        raise NotImplementedError(f"block_fp8_gemm on {xq.device}")
    return block_fp8_gemm_plain(xq, xs, q, s, out_dtype)


block_fp8_gemm.launches = 0


def w8a8_matmul(x: torch.Tensor, p: dict, spec: QuantSpec,
                out_dtype=None, amax: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x [..., K] @ W8A8 leaf -> [..., N] in ``out_dtype`` (default x.dtype):
    activation quantization, then the GEMM of the leaf's format. A stacked
    leaf is served through its layer's views (``layers.linear.linear_at``).
    ``amax`` [M] (rows flattened): the whole rows' amax of a dynamic spec
    where x is their K-shard (``quant_act``)."""
    if spec.block not in (0, BLOCK):
        raise ValueError(f"block fp8 weights come in {BLOCK}x{BLOCK} blocks, not {spec.block}")
    od = out_dtype or x.dtype
    lead = x.shape[:-1]
    xq, xs = quant_act(x.reshape(-1, x.shape[-1]), spec, p.get("xs"), amax)
    if spec.block:
        out = block_fp8_gemm(xq, xs, p["q"], p["s"], od)
    else:
        out = w8a8_gemm(xq, xs, p["q"], p["s"], od)
    return out.reshape(*lead, p["q"].shape[-1])
