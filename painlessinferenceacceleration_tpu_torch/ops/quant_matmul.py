"""Weight-only int4 / int8 GEMMs: the CUDA kernels' wrappers, their plain
versions, the tensor-core GEMMs' launch plan, and the dispatcher over every
quantized linear leaf.

``int4_matmul`` replaces the Pallas ``_qmm4_kernel_v3`` and
``_qmm4_stacked_kernel_v3``, ``int8_matmul`` replaces ``_qmm_kernel`` and
``_qmm8_stacked_kernel`` (``painlessinferenceacceleration_tpu/ops/
quant_matmul.py``). A stacked weight's layer is a view ``q[li]``, so one
kernel serves the plain and the stacked form. The kernels
(``csrc/int4_gemm.cu`` and ``csrc/int8_gemm.cu``, one tensor-core body in
``csrc/weight_only_wgmma.cuh``) read the JAX layouts directly; each source
note says what bounds it and how its design answers that. ``int4_plan`` and
``int8_plan`` are their launch plans (split count, warpgroups, grid), the
grouped kernels' too (``ops/moe_matmul.py``); ``stage_split`` and
``tile_grid`` serve the W8A8 and block-fp8 kernels as well (``ops/w8a8.py``).
``quant_matmul`` sends activation-quantized and block-fp8 leaves on to
``ops/w8a8.py``. ``fp8_head_matmul`` is the tied LM head over an e4m3
embedding table (``csrc/fp8_head_gemm.cu``, on the weight-only body's
wgmma; it replaces no Pallas body: XLA's product in the JAX package's
``layers/embedding.py`` ``embed_logits``).

A CPU tensor takes the plain version; a CUDA tensor launches the kernel or
raises. Each wrapper's ``launches`` counts its kernel launches.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from painlessinferenceacceleration_tpu_torch import _build
from painlessinferenceacceleration_tpu_torch.layers.linear import (
    QuantSpec,
    dequantize,
)

SMS = 132  # the H100's SMs; one tensor-core block fills an SM's shared memory

# ---------------------------------------------------------------------------
# the tensor-core GEMMs' launch plan: the weight-only kernels
# (csrc/weight_only_wgmma.cuh) here, the W8A8 kernel (csrc/w8a8_wgmma.cuh) in
# ops/w8a8.py
# ---------------------------------------------------------------------------

INT4_GROUPS = (32, 64, 128)  # scale groups the int4 kernels take: one ring stage each
INT8_STAGES = (128, 64, 32)  # k rows of an int8 ring stage, the largest dividing the group
TC_COLS = 128  # weight columns of a block: the wgmma's N
TC_WG_ROWS = 64  # token rows of one multiplying warpgroup: the wgmma's M
_MIN_FILL = 0.8  # the share of the last wave of blocks a split count must fill
_MIN_SPLIT_K = 512  # K rows of a split at the least


class GemmPlan(NamedTuple):
    ksplit: int
    stages_per_split: int  # every split gets at least one ring stage
    warpgroups: int  # multiplying warpgroups: the token tile is 64 x this
    grid: tuple  # (column blocks, row blocks, splits launched as blocks)


def _fill(units: int) -> float:
    """The share of its last wave that ``units`` blocks fill on 132 SMs."""
    return units / (-(-units // SMS) * SMS)


def split_blocks(ksplit: int, cols: int, row_tiles: int) -> int:
    """The K splits launched as blocks: ``ksplit``, where the tiles alone
    would leave the card idle (decode), or 1, where column blocks times row
    tiles fill at least ``_MIN_FILL`` of their last wave (prefill). Then a
    block runs its tile's splits in order and adds them as the reduction
    would: the same bits, and no partial planes, whose traffic (8 bytes a row
    and column a split, 2.4 ps at 3.35 TB/s) is 2.3 times the products of a
    512-row split (1024 at 989 TFLOP/s, 1.0 ps)."""
    return 1 if ksplit == 1 or _fill(cols * row_tiles) >= _MIN_FILL else ksplit


def int4_check(K: int, N: int, group: int) -> None:
    """Raise on a shape the int4 kernels do not take: a group of 32, 64 or
    128 (one ring stage), K a whole number of groups, N % 16 == 0 (the
    packed rows are copied 16 bytes at a time)."""
    if group not in INT4_GROUPS:
        raise ValueError(f"the int4 kernels take groups of {INT4_GROUPS}, not {group}")
    if K <= 0 or K % group:
        raise ValueError(f"the int4 kernels need K % group == 0 (K={K}, group={group})")
    if N <= 0 or N % 16:
        raise ValueError(f"the int4 kernels need N % 16 == 0 (N={N})")


def int8_stage(group: int) -> int:
    """k rows of one ring stage of the int8 kernels: the largest of
    ``INT8_STAGES`` that divides ``group`` (a group then folds group / stage
    times), 0 where none does."""
    return next((c for c in INT8_STAGES if group > 0 and group % c == 0), 0)


def int8_check(K: int, N: int, group: int) -> None:
    """Raise on a shape the int8 kernels do not take: a group that is a
    multiple of 32 (whole ring stages), K a whole number of groups, N % 16
    == 0 (the weight's rows are copied 16 bytes at a time)."""
    if group <= 0 or group % 32:
        raise ValueError(f"the int8 kernels take groups that are multiples of 32, "
                         f"not {group}")
    if K <= 0 or K % group:
        raise ValueError(f"the int8 kernels need K % group == 0 (K={K}, group={group})")
    if N <= 0 or N % 16:
        raise ValueError(f"the int8 kernels need N % 16 == 0 (N={N})")


def quant_leaves(params):
    """Every quantized linear leaf (a dict with a tensor ``q`` and its
    ``s``) in a parameter tree of dicts, lists and tuples."""
    if isinstance(params, dict):
        if isinstance(params.get("q"), torch.Tensor) and params.get("s") is not None:
            yield params
            return
        params = list(params.values())
    if isinstance(params, (list, tuple)):
        for v in params:
            yield from quant_leaves(v)


def check_int4_params(params) -> None:
    """Raise, before the first launch, on a packed int4 weight (uint8 ``q``)
    of ``params`` whose shape the int4 kernels do not take: a model
    quantized with a group other than 32, 64 or 128 does not run on the
    card."""
    for p in quant_leaves(params):
        q, s = p["q"], p["s"]
        if q.dtype == torch.uint8:
            K = q.shape[-2] * 2
            int4_check(K, q.shape[-1], K // max(1, s.shape[-2]))


def check_int8_params(params) -> None:
    """Raise, before the first launch, on a weight-only int8 weight (int8
    ``q`` with bf16 group scales; a W8A8 leaf's scales are fp32) of
    ``params`` whose shape the int8 kernels do not take: such a model does
    not run on the card."""
    for p in quant_leaves(params):
        q, s = p["q"], p["s"]
        if q.dtype == torch.int8 and s.dtype == torch.bfloat16:
            K = q.shape[-2]
            int8_check(K, q.shape[-1], K // max(1, s.shape[-2]))


def stage_split(K: int, N: int, stage: int) -> tuple:
    """(K splits, stages per split) of a tensor-core GEMM whose blocks walk
    K in ring stages of ``stage`` rows (an int4 scale group, an int8
    ``int8_stage``, 128 for W8A8 and block fp8),
    from (K, N, stage) alone, so that a row's sum is taken in the same order
    at every M and in the grouped kernels. The fewest splits (none empty,
    each at least ``_MIN_SPLIT_K`` rows of K) whose column blocks times
    splits fill at least ``_MIN_FILL`` of their last wave on 132 SMs, where
    a lone row tile (decode) would leave the card idle; else the best fill
    found."""
    n_stages = -(-K // stage)
    cols = -(-N // TC_COLS)
    best = (0.0, 1, n_stages)
    for want in range(1, max(1, K // _MIN_SPLIT_K) + 1):
        per = -(-n_stages // want)
        ks = -(-n_stages // per)
        fill = _fill(cols * ks)
        if fill >= _MIN_FILL:
            return ks, per
        if fill > best[0] + 1e-9:
            best = (fill, ks, per)
    return best[1], best[2]


def tile_grid(M: int, N: int, ksplit: int) -> tuple:
    """(multiplying warpgroups, grid) of a dense tensor-core GEMM: one
    warpgroup (64 token rows a block) up to M = 64, two above; the grid
    (column blocks, row tiles, splits launched as ``split_blocks`` says)."""
    if M <= 0:
        raise ValueError(f"a GEMM needs M >= 1 (M={M})")
    wg = 1 if M <= TC_WG_ROWS else 2
    cols, tiles = -(-N // TC_COLS), -(-M // (TC_WG_ROWS * wg))
    return wg, (cols, tiles, split_blocks(ksplit, cols, tiles))


@functools.lru_cache(maxsize=None)
def int4_split(K: int, N: int, group: int) -> tuple:
    """(K splits, groups per split) of the int4 kernels: ``stage_split``
    with a stage of one scale group."""
    int4_check(K, N, group)
    return stage_split(K, N, group)


@functools.lru_cache(maxsize=None)
def int4_plan(M: int, K: int, N: int, group: int) -> GemmPlan:
    """The dense int4 kernel's launch: the split of ``int4_split`` on the
    grid of ``tile_grid``."""
    ks, gps = int4_split(K, N, group)
    return GemmPlan(ks, gps, *tile_grid(M, N, ks))


@functools.lru_cache(maxsize=None)
def int8_split(K: int, N: int, group: int) -> tuple:
    """(K splits, stages per split) of the int8 kernels: ``stage_split``
    with a stage of ``int8_stage(group)`` rows."""
    int8_check(K, N, group)
    return stage_split(K, N, int8_stage(group))


@functools.lru_cache(maxsize=None)
def int8_plan(M: int, K: int, N: int, group: int) -> GemmPlan:
    """The dense int8 kernel's launch: the split of ``int8_split`` on the
    grid of ``tile_grid``."""
    ks, sps = int8_split(K, N, group)
    return GemmPlan(ks, sps, *tile_grid(M, N, ks))


def check_gemm_out(what: str, x: torch.Tensor, N: int, out_dtype, *others) -> None:
    """What the W8A8 and block-fp8 kernels ask of their call beyond their
    shape rule: bf16 or fp32 out, the other operands on x's CUDA device and
    starting on a 4-byte boundary."""
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


def check_weight_only_operands(what: str, bits: int, x: torch.Tensor, q: torch.Tensor,
                               s: torch.Tensor, K: int, N: int, out_dtype) -> int:
    """What the int4 and int8 kernels ask of their operands: bf16 x and
    scales, q of K/2 packed uint8 rows (int4) or K int8 rows, one CUDA
    device, q and s on 16-byte boundaries, bf16 or fp32 out, and a shape
    ``int4_check`` / ``int8_check`` takes. Returns the group."""
    if x.dtype != torch.bfloat16 or s.dtype != torch.bfloat16:
        raise TypeError(f"{what} takes bf16 activations and bf16 scales, "
                        f"not {x.dtype} and {s.dtype}")
    dtype, per_row, check = ((torch.uint8, 2, int4_check) if bits == 4
                             else (torch.int8, 1, int8_check))
    if q.dtype != dtype or q.shape[-2] * per_row != K or q.shape[-1] != N:
        raise ValueError(f"{what}: weight {tuple(q.shape)} {q.dtype} does not match "
                         f"K={K}, N={N}")
    if s.shape[-2] == 0 or K % s.shape[-2] or s.shape[-1] != N:
        raise ValueError(f"{what}: scales {tuple(s.shape)} do not group K={K}, N={N}")
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"{what} writes bf16 or fp32, not {out_dtype}")
    group = K // s.shape[-2]
    check(K, N, group)
    if not (q.is_cuda and s.is_cuda and q.device == x.device == s.device):
        raise ValueError(f"{what} operands must be on one CUDA device")
    if q.data_ptr() % 16 or s.data_ptr() % 16:
        raise ValueError(f"{what} needs the weight and its scales on 16-byte boundaries")
    return group


def aligned16(x: torch.Tensor) -> torch.Tensor:
    """x contiguous and on a 16-byte boundary (the kernels copy 16-byte
    chunks of its rows); a misaligned view is copied."""
    x = x.contiguous()
    return x if x.data_ptr() % 16 == 0 else x.clone()


_WEIGHT_ONLY_ARGS = (ctypes.c_void_p,) * 5 + (ctypes.c_int,) * 8 + (ctypes.c_void_p,)


def _weight_only_cuda(bits: int, x: torch.Tensor, q: torch.Tensor, s: torch.Tensor,
                      out_dtype) -> torch.Tensor:
    """One launch of the int4 or int8 kernel (both take the same arguments)
    on its plan."""
    M, K = x.shape
    q, s = q.contiguous(), s.contiguous()
    N = q.shape[1]
    name = f"int{bits}_gemm"
    group = check_weight_only_operands(name, bits, x, q, s, K, N, out_dtype)
    x = aligned16(x)
    plan = (int4_plan if bits == 4 else int8_plan)(M, K, N, group)
    out = torch.empty((M, N), dtype=out_dtype, device=x.device)
    work = (torch.empty((plan.grid[2], M, N), dtype=torch.float32, device=x.device)
            if plan.grid[2] > 1 else None)
    lib, fn = _build.function(name, name, _WEIGHT_ONLY_ARGS)
    err = fn(x.data_ptr(), q.data_ptr(), s.data_ptr(), out.data_ptr(),
             _build.ptr(work), M, K, N, group, int(out_dtype == torch.float32),
             plan.grid[2], plan.stages_per_split, plan.warpgroups, _build.stream_of(x))
    _build.check(lib, err, name)
    return out


def _int4_matmul_cuda(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor,
                      out_dtype) -> torch.Tensor:
    out = _weight_only_cuda(4, x, q, s, out_dtype)
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
    out = _weight_only_cuda(8, x, q, s, out_dtype)
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


FP8_HEAD_STAGE = 64  # csrc/fp8_head_gemm.cu kC: E of a ring stage
_FP8_HEAD_ARGS = (ctypes.c_void_p,) * 4 + (ctypes.c_int,) * 4 + (ctypes.c_void_p,)


def fp8_head_check(V: int, E: int) -> None:
    """Raise on a table the e4m3 head kernel does not take: E a whole
    number of its 64-wide stages (one 128-byte row of the bf16 operand), at
    least one row. Any vocabulary size: rows past V read as zeros and are
    not stored."""
    if V < 1 or E < FP8_HEAD_STAGE or E % FP8_HEAD_STAGE:
        raise ValueError(f"the e4m3 tied head takes a hidden size that is a multiple of "
                         f"{FP8_HEAD_STAGE} (its ring stage), not {E} (vocab {V})")


def fp8_head_matmul_plain(h: torch.Tensor, q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """h [M, E] @ (e4m3 q [V, E]).T in fp32, then each column times s [V]."""
    out = torch.matmul(h.to(torch.float32), q.to(torch.float32).T)
    return out * s


def _fp8_head_cuda(h: torch.Tensor, q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    M, E = h.shape
    V = q.shape[0]
    if h.dtype != torch.bfloat16 or q.dtype != torch.float8_e4m3fn \
            or s.dtype != torch.float32:
        raise TypeError(f"the e4m3 tied head takes bf16 rows, an e4m3 table and f32 scales, "
                        f"not {h.dtype} / {q.dtype} / {s.dtype}")
    if q.dim() != 2 or q.shape[1] != E or tuple(s.shape) != (V,):
        raise ValueError(f"the e4m3 tied head: rows {tuple(h.shape)}, table "
                         f"{tuple(q.shape)}, scales {tuple(s.shape)}")
    fp8_head_check(V, E)
    if not (q.is_cuda and s.is_cuda and q.device == h.device == s.device):
        raise ValueError("the e4m3 tied head's operands must be on one CUDA device")
    q, s = q.contiguous(), s.contiguous()
    if q.data_ptr() % 16:
        raise ValueError("the e4m3 table must start on a 16-byte boundary")
    h = aligned16(h)
    out = torch.empty((M, V), dtype=torch.float32, device=h.device)
    lib, fn = _build.function("fp8_head_gemm", "fp8_head_gemm", _FP8_HEAD_ARGS)
    err = fn(h.data_ptr(), q.data_ptr(), s.data_ptr(), out.data_ptr(), M, E, V,
             1 if M <= TC_WG_ROWS else 2, _build.stream_of(h))
    _build.check(lib, err, "fp8_head_gemm")
    fp8_head_matmul.launches += 1
    return out


def fp8_head_matmul(h: torch.Tensor, q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """The tied LM head over an e4m3 table: h [..., E] @ (q [V, E]).T with
    fp32 sums, each vocab column times its scale s [V] once -> fp32 [...,
    V]. On the card ``csrc/fp8_head_gemm.cu`` (the table widened to bf16 in
    shared memory, exactly; bf16 rows); on the CPU the plain version."""
    lead = h.shape[:-1]
    h2 = h.reshape(-1, h.shape[-1])
    if h.is_cuda:
        out = _fp8_head_cuda(h2, q, s)
    elif h.device.type == "cpu":
        out = fp8_head_matmul_plain(h2, q, s)
    else:
        raise NotImplementedError(f"fp8_head_matmul on {h.device}")
    return out.reshape(*lead, q.shape[0])


fp8_head_matmul.launches = 0


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
