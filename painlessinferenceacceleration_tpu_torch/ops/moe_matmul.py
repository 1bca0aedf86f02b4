"""Grouped (per-expert) GEMMs for routed Mixture-of-Experts rows, the dense
bf16 GEMM, and the routed expert MLP built on them.

Port of ``painlessinferenceacceleration_tpu/ops/moe_matmul.py``.
``grouped_matmul`` replaces the Pallas ``_gmm_kernel``, and
``grouped_quant_matmul`` ``_gqmm4_kernel`` (int4 experts) and
``_gqmm8_kernel`` (int8 experts): (token, expert) pairs are sorted by expert,
each expert's run padded to ``BLOCK_M`` rows (``moe_align``), and row block
``b`` is multiplied by the weights of expert ``block_expert[b]``. The kernels
(``csrc/grouped_gemm.cu`` over the tensor-core body ``csrc/bf16_wgmma.cuh``,
``csrc/grouped_int4_gemm.cu``, ``csrc/grouped_int8_gemm.cu``) read the block
tables from device memory, so no call waits for the routing; their grids are
bounded by the row blocks the routing's pair count allows (``grouped_plan``).
Each source note says what bounds it.
``dense_matmul`` is the bf16 kernel's body with one weight; the native bf16
linears, the router product and the LM head use it, so every bf16 GEMM of a
model sums in one order and a token's expert output has the same bits on the
grouped path and on the scan path (``models/moe.py``). ``dense_matmul_batched``
runs that body over a batch of weights in one launch (MLA's per-head weight
absorption, ``models/mla.py``). ``bf16_plan`` and its kin are the three
entries' launch plans: one K split, a function of (K, N) alone.

A CPU tensor takes the plain version; a CUDA tensor launches the kernel or
raises. Each wrapper's ``launches`` counts its kernel launches.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch
import torch.nn.functional as F

from painlessinferenceacceleration_tpu_torch import _build
from painlessinferenceacceleration_tpu_torch.layers.linear import (
    QuantSpec,
    dequantize,
)
from painlessinferenceacceleration_tpu_torch.ops.quant_matmul import (
    SMS,
    TC_COLS,
    GemmPlan,
    aligned16,
    check_weight_only_operands,
    int4_split,
    int8_split,
    split_blocks,
    stage_split,
    tile_grid,
)

BLOCK_M = 128


def stable_topk(x: torch.Tensor, k: int):
    """The k largest of the last axis, the lowest index first among equals
    (``jax.lax.top_k``'s rule; ``torch.topk`` promises no order on a tie, and
    the experts chosen must not change with the row count)."""
    v, i = torch.sort(x, dim=-1, descending=True, stable=True)
    return v[..., :k], i[..., :k]


def _align(topi: torch.Tensor, topv: torch.Tensor, n_experts: int, n_tokens: int):
    """``moe_align`` and, with it, each token's k padded-row positions in
    ascending expert order ([T, k] int64)."""
    T, k = topi.shape
    M = T * k
    NB = -(-M // BLOCK_M) + n_experts + 1
    R = NB * BLOCK_M
    dev = topi.device

    ex = topi.reshape(M).to(torch.int64)
    wt = topv.reshape(M).to(torch.float32)
    tok = torch.arange(T, dtype=torch.int32, device=dev).repeat_interleave(k)

    ex_s, order = torch.sort(ex, stable=True)
    tok_s, wt_s = tok[order], wt[order]
    wt_s = torch.where(ex_s < n_experts, wt_s, torch.zeros_like(wt_s))

    # pairs per expert, [X+1] incl. dropped, from the sorted ids (a bincount
    # on the card would wait for the host)
    edges = torch.searchsorted(ex_s, torch.arange(n_experts + 2, device=dev))
    counts = edges[1:] - edges[:-1]
    nb_x = -(-counts // BLOCK_M)  # blocks per expert (+ overflow bin)
    boff = torch.cumsum(nb_x, 0) - nb_x  # exclusive block offsets
    ccum = torch.cumsum(counts, 0) - counts  # exclusive pair offsets
    pos = torch.arange(M, device=dev) - ccum[ex_s]
    dest = boff[ex_s] * BLOCK_M + pos  # unique rows: the scatters are exact

    dest_tok = torch.full((R,), n_tokens, dtype=torch.int32, device=dev)
    dest_tok[dest] = tok_s
    row_w = torch.zeros((R,), dtype=torch.float32, device=dev)
    row_w[dest] = wt_s
    real_cum = torch.cumsum(nb_x[:n_experts], 0)
    block_expert = torch.searchsorted(
        real_cum, torch.arange(NB, device=dev), right=True
    ).clamp(0, n_experts - 1).to(torch.int32)
    n_used = real_cum[-1].to(torch.int32).reshape(1)

    pair_row = torch.empty(M, dtype=torch.int64, device=dev)
    pair_row[order] = dest
    # rows ascend with the expert id (dropped pairs last)
    tok_rows = pair_row.reshape(T, k).sort(dim=1).values
    return dest_tok, row_w, block_expert, n_used, tok_rows


def moe_align(topi: torch.Tensor, topv: torch.Tensor, n_experts: int, n_tokens: int):
    """Sort (token, expert) pairs by expert and pad each expert's run to
    ``BLOCK_M`` rows.

    topi / topv: [T, k] expert ids / routing weights. Pairs with expert id
    == n_experts are DROPPED: they sort past every real expert into overflow
    blocks at indices >= n_used, which the grouped kernels fill with zeros
    (the expert-shard path marks the pairs of other shards so).

    Returns (dest_tok [R] int32: source token of each padded row, pad rows =
    T; row_w [R] f32; block_expert [NB] int32; n_used [1] int32) with
    R = NB * BLOCK_M and NB = ceil(T*k / BLOCK_M) + n_experts + 1, the static
    worst case including the overflow bin. Everything stays on ``topi``'s
    device; nothing is read back."""
    return _align(topi, topv, n_experts, n_tokens)[:4]


def _block_rows(dest_tok: torch.Tensor, n_tokens: int) -> torch.Tensor:
    """Routed rows at the head of each block ([NB] int32): an expert's run
    fills its blocks from the front, the rest of a block is padding."""
    return (dest_tok.reshape(-1, BLOCK_M) < n_tokens).sum(dim=1).to(torch.int32)


def grouped_row_bound(n_blocks: int, n_experts: int, n_pairs: int) -> int:
    """Row blocks a routing of ``n_pairs`` (token, expert) pairs over
    ``n_experts`` experts can use: each expert touched adds at most one
    partly filled block, so n_used <= min(X, n_pairs) + ceil(n_pairs / 128),
    and never more than the ``n_blocks`` of the padded layout. Known from
    shapes, so no launch waits for the routing."""
    return min(n_blocks, min(n_experts, n_pairs) + -(-n_pairs // BLOCK_M))


def grouped_plan(R: int, N: int, split: tuple, n_experts: int, n_pairs: int,
                 launch=split_blocks) -> GemmPlan:
    """A grouped tensor-core kernel's launch: the dense kernel's split
    ``split`` (K splits, stages per split; launched as ``launch(K splits,
    column blocks, row blocks)`` says), two multiplying warpgroups (an
    expert block of ``BLOCK_M`` rows), and a grid bounded to
    ``grouped_row_bound`` row blocks."""
    if R <= 0 or R % BLOCK_M:
        raise ValueError(f"grouped GEMM: {R} rows are not whole blocks of {BLOCK_M}")
    ks, sps = split
    cols, rows = -(-N // TC_COLS), grouped_row_bound(R // BLOCK_M, n_experts, n_pairs)
    return GemmPlan(ks, sps, 2, (cols, rows, launch(ks, cols, rows)))


def grouped_bf16_plan(R: int, K: int, N: int, n_experts: int, n_pairs: int) -> GemmPlan:
    """The grouped bf16 kernel's launch: ``grouped_plan`` over ``bf16_split``,
    the splits launched as ``bf16_split_blocks`` says for the routed rows
    (the planes hold no padding row)."""
    return grouped_plan(R, N, bf16_split(K, N), n_experts, n_pairs, lambda ks, cols, rows:
                        bf16_split_blocks(min(rows * BLOCK_M, n_pairs), K, N, 2, cols, rows))


def grouped_int4_plan(R: int, K: int, N: int, group: int, n_experts: int,
                      n_pairs: int) -> GemmPlan:
    """The grouped int4 kernel's launch: ``grouped_plan`` over ``int4_split``."""
    return grouped_plan(R, N, int4_split(K, N, group), n_experts, n_pairs)


def grouped_int8_plan(R: int, K: int, N: int, group: int, n_experts: int,
                      n_pairs: int) -> GemmPlan:
    """The grouped int8 kernel's launch: ``grouped_plan`` over ``int8_split``."""
    return grouped_plan(R, N, int8_split(K, N, group), n_experts, n_pairs)


# ---------------------------------------------------------------------------
# the bf16 GEMM's launch plan (csrc/grouped_gemm.cu, csrc/bf16_wgmma.cuh)
# ---------------------------------------------------------------------------

BF16_STAGE = 64  # k rows of a ring stage of the bf16 kernels (kStage)


def bf16_check(K: int, N: int) -> None:
    """Raise on a shape the bf16 kernels do not take: K and N multiples of
    8, as the tensor memory accelerator copies rows of x, of the weight and
    of a transposed table in whole 16-byte units (the rest of a stage past
    K or N lands as zeros)."""
    if K <= 0 or K % 8:
        raise ValueError(f"the bf16 GEMMs need K % 8 == 0 (K={K})")
    if N <= 0 or N % 8:
        raise ValueError(f"the bf16 GEMMs need N % 8 == 0 (N={N})")


@functools.lru_cache(maxsize=None)
def bf16_split(K: int, N: int) -> tuple:
    """(K splits, stages per split) of the bf16 kernels: ``stage_split``
    with a stage of ``BF16_STAGE`` rows. A function of (K, N) alone: the
    dense, head-batched and grouped entries sum a row in the same order."""
    bf16_check(K, N)
    return stage_split(K, N, BF16_STAGE)


# the costs of the estimate below on an H100: a 128-row tile's ring stage
# (fitted to tools/k10_variants.py's split-launch times), the planes
# written and read at HBM's peak rate (3.35 TB/s), the last block's sum of
# its tile's planes at 50 GB/s (assumed: one SM's share of L2) and that
# sum's fixed cost (fitted)
_STAGE_US = 0.52
_PLANE_US_PER_BYTE = 1e6 / 3.35e12
_SUM_US_PER_BYTE = 1e6 / 50e9
_SUM_US = 2.0


def bf16_split_blocks(rows: int, K: int, N: int, wg: int, cols: int, tiles: int) -> int:
    """The bf16 kernels' K splits launched as blocks (``bf16_split``'s
    count) or 1 (each block runs every split of its tile in order): the same
    bits either way. ``rows``: the rows whose fp32 planes the splits would
    write. At one warpgroup the shared rule (``split_blocks``). At two, the
    estimate of each on ``SMS`` SMs: waves of blocks times their ring
    stages; for the splits as blocks also their planes, written and read,
    and the sum of a tile's planes by its last block. For the dense entry
    it picks the faster launch at every shape of tools/k10_variants.py's
    split-launch table, where ``split_blocks`` often picks the slower; for
    the grouped entry's sparsely filled blocks neither rule does
    (PERF.md)."""
    ks, sps = bf16_split(K, N)
    if ks == 1 or wg == 1:
        return split_blocks(ks, cols, tiles)
    seq = -(-cols * tiles // SMS) * -(-K // BF16_STAGE) * _STAGE_US
    split = (-(-cols * tiles * ks // SMS) * sps * _STAGE_US
             + 8 * rows * N * ks * _PLANE_US_PER_BYTE
             + min(rows, 64 * wg) * 128 * ks * 8 * _SUM_US_PER_BYTE + _SUM_US)
    return ks if split < seq else 1


@functools.lru_cache(maxsize=None)
def bf16_plan(M: int, K: int, N: int) -> GemmPlan:
    """The dense bf16 kernel's launch: the split of ``bf16_split`` on the
    grid of ``tile_grid``, the splits launched as ``bf16_split_blocks``
    says."""
    ks, sps = bf16_split(K, N)
    wg, (cols, tiles, _) = tile_grid(M, N, ks)
    return GemmPlan(ks, sps, wg, (cols, tiles, bf16_split_blocks(M, K, N, wg, cols, tiles)))


@functools.lru_cache(maxsize=None)
def bf16_batched_plan(G: int, M: int, K: int, N: int) -> GemmPlan:
    """The head-batched bf16 kernel's launch: the dense plan's split and
    warpgroups for one head, every split of a head in one block (the heads
    fill the card), and the grid (column blocks, row tiles, heads)."""
    if G <= 0 or G > 65535:
        raise ValueError(f"bf16_gemm_batched takes 1 to 65535 heads, not {G}")
    ks, sps, wg, (cols, tiles, _) = bf16_plan(M, K, N)
    return GemmPlan(ks, sps, wg, (cols, tiles, G))


# ---------------------------------------------------------------------------
# the dense bf16 GEMM
# ---------------------------------------------------------------------------


def dense_matmul_plain(x: torch.Tensor, w: torch.Tensor, out_dtype=None,
                       transposed: bool = False) -> torch.Tensor:
    """x [M, K] @ w [K, N] (or w [N, K] transposed) in fp32, cast to
    ``out_dtype``."""
    wf = w.to(torch.float32)
    out = torch.matmul(x.to(torch.float32), wf.T if transposed else wf)
    return out.to(out_dtype or x.dtype)


def _check_bf16(what: str, x: torch.Tensor, w: torch.Tensor, out_dtype, *tables) -> None:
    """What the bf16 kernels ask of their call: bf16 x and weights, bf16 or
    fp32 out, every operand on x's CUDA device, the weight on a 16-byte
    boundary (TMA copies it; x is copied there by ``aligned16``)."""
    if x.dtype != torch.bfloat16 or w.dtype != torch.bfloat16:
        raise TypeError(f"{what} takes bf16 activations and bf16 weights, "
                        f"not {x.dtype} and {w.dtype}")
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"{what} writes bf16 or fp32, not {out_dtype}")
    if not all(t.is_cuda and t.device == x.device for t in (w, *tables)):
        raise ValueError(f"{what} operands must be on one CUDA device")
    if w.data_ptr() % 16:
        raise ValueError(f"{what} needs the weight on a 16-byte boundary")


_DENSE_BF16_ARGS = (ctypes.c_void_p,) * 5 + (ctypes.c_int,) * 8 + (ctypes.c_void_p,)


def _split_buffers(device, plan: GemmPlan, rows: int, N: int) -> tuple:
    """(planes, counters) of a launch whose K splits run as blocks; (None,
    None) otherwise."""
    cols, tiles, blocks = plan.grid
    if blocks == 1:
        return None, None
    return (_build.scratch(device, blocks * rows * N),
            _build.tile_counters(device, cols * tiles))


def _dense_matmul_cuda(x: torch.Tensor, w: torch.Tensor, out_dtype,
                       transposed: bool) -> torch.Tensor:
    M, K = x.shape
    N = w.shape[0] if transposed else w.shape[1]
    if w.dim() != 2 or (w.shape[1] if transposed else w.shape[0]) != K:
        raise ValueError(f"weight {tuple(w.shape)} does not match K={K}")
    plan = bf16_plan(M, K, N)
    x, w = aligned16(x), w.contiguous()
    _check_bf16("bf16_gemm", x, w, out_dtype)
    out = torch.empty((M, N), dtype=out_dtype, device=x.device)
    work, count = _split_buffers(x.device, plan, M, N)
    lib, fn = _build.function("grouped_gemm", "bf16_gemm", _DENSE_BF16_ARGS)
    err = fn(x.data_ptr(), w.data_ptr(), out.data_ptr(), _build.ptr(work), _build.ptr(count),
             M, K, N, int(transposed), int(out_dtype == torch.float32), plan.grid[2],
             plan.stages_per_split, plan.warpgroups, _build.stream_of(x))
    _build.check(lib, err, "bf16_gemm")
    dense_matmul.launches += 1
    return out


def dense_matmul(x: torch.Tensor, w: torch.Tensor, out_dtype=None,
                 transposed: bool = False) -> torch.Tensor:
    """x [..., K] @ w [K, N] -> [..., N] in ``out_dtype`` (default x.dtype),
    fp32 accumulation; ``transposed``: w is [N, K] (an embedding table as the
    tied LM head). On CUDA bf16 operands only."""
    out_dtype = out_dtype or x.dtype
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    if x.is_cuda:
        out = _dense_matmul_cuda(x2, w, out_dtype, transposed)
    elif x.device.type == "cpu":
        out = dense_matmul_plain(x2, w, out_dtype, transposed)
    else:
        raise NotImplementedError(f"dense_matmul on {x.device}")
    return out.reshape(*lead, out.shape[-1])


dense_matmul.launches = 0


def dense_matmul_batched_plain(x: torch.Tensor, w: torch.Tensor,
                               out_dtype=None) -> torch.Tensor:
    """x [G, M, K] @ w [G, K, N] per batch entry in fp32, cast to
    ``out_dtype``."""
    out = torch.matmul(x.to(torch.float32), w.to(torch.float32))
    return out.to(out_dtype or x.dtype)


_BATCHED_BF16_ARGS = (ctypes.c_void_p,) * 3 + (ctypes.c_int,) * 7 + (ctypes.c_void_p,)


def _dense_matmul_batched_cuda(x: torch.Tensor, w: torch.Tensor,
                               out_dtype) -> torch.Tensor:
    G, M, K = x.shape
    if w.dim() != 3 or w.shape[0] != G or w.shape[1] != K:
        raise ValueError(f"weights {tuple(w.shape)} do not match x {tuple(x.shape)}")
    N = w.shape[2]
    plan = bf16_batched_plan(G, M, K, N)
    x, w = aligned16(x), w.contiguous()
    _check_bf16("bf16_gemm_batched", x, w, out_dtype)
    out = torch.empty((G, M, N), dtype=out_dtype, device=x.device)
    lib, fn = _build.function("grouped_gemm", "bf16_gemm_batched", _BATCHED_BF16_ARGS)
    err = fn(x.data_ptr(), w.data_ptr(), out.data_ptr(), G, M, K, N,
             int(out_dtype == torch.float32), plan.stages_per_split, plan.warpgroups,
             _build.stream_of(x))
    _build.check(lib, err, "bf16_gemm_batched")
    dense_matmul_batched.launches += 1
    return out


def dense_matmul_batched(x: torch.Tensor, w: torch.Tensor,
                         out_dtype=None) -> torch.Tensor:
    """x [G, M, K] @ w [G, K, N] -> [G, M, N] (one weight per batch entry,
    as MLA's per-head absorption products), fp32 accumulation, in
    ``out_dtype`` (default x.dtype). On CUDA bf16 operands only, one launch
    of the dense GEMM's body per call: a row's bits do not depend on M."""
    out_dtype = out_dtype or x.dtype
    if x.is_cuda:
        return _dense_matmul_batched_cuda(x, w, out_dtype)
    if x.device.type == "cpu":
        return dense_matmul_batched_plain(x, w, out_dtype)
    raise NotImplementedError(f"dense_matmul_batched on {x.device}")


dense_matmul_batched.launches = 0


# ---------------------------------------------------------------------------
# the grouped GEMMs
# ---------------------------------------------------------------------------


def _grouped_plain(x: torch.Tensor, block_expert: torch.Tensor,
                   n_used: torch.Tensor, w_of, N: int, out_dtype) -> torch.Tensor:
    """Block b of x times ``w_of(e)`` (fp32 [K, N]) for e = block_expert[b],
    fp32 sums; zeros in blocks b >= n_used."""
    R, K = x.shape
    xb = x.to(torch.float32).reshape(R // BLOCK_M, BLOCK_M, K)
    out = torch.zeros((R // BLOCK_M, BLOCK_M, N), dtype=torch.float32, device=x.device)
    be = block_expert.tolist()
    weights = {}  # each expert's fp32 weight, made once
    for b in range(min(int(n_used[0]), len(be))):
        if be[b] not in weights:
            weights[be[b]] = w_of(be[b])
        out[b] = xb[b] @ weights[be[b]]
    return out.reshape(R, N).to(out_dtype)


def grouped_matmul_plain(x: torch.Tensor, block_expert: torch.Tensor,
                         n_used: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """out[b] = x[b] @ w[block_expert[b]] per row block in fp32, cast to
    x.dtype; zeros past n_used."""
    return _grouped_plain(x, block_expert, n_used,
                          lambda e: w[e].to(torch.float32), w.shape[2], x.dtype)


def _block_tables(name: str, x, block_expert, n_used, block_rows) -> list:
    """The grouped kernels' block tables, checked: int32 [NB], [1], [NB] on
    x's device for R = NB * BLOCK_M rows of x; no ``block_rows`` means every
    row of a used block counts."""
    R = x.shape[0]
    if R % BLOCK_M or block_expert.numel() != R // BLOCK_M:
        raise ValueError(f"{name}: {R} rows are not {block_expert.numel()} "
                         f"blocks of {BLOCK_M}")
    if block_rows is None:
        block_rows = torch.full_like(block_expert, BLOCK_M)
    tables = [t.contiguous() for t in (block_expert, n_used, block_rows)]
    if any(t.dtype != torch.int32 or t.device != x.device for t in tables) \
            or tables[2].numel() != R // BLOCK_M:
        raise TypeError(f"{name}: the block tables must be int32 [NB], [1], [NB] "
                        "on x's device")
    return tables


_GROUPED_BF16_ARGS = (ctypes.c_void_p,) * 8 + (ctypes.c_int,) * 8 + (ctypes.c_void_p,)


def _grouped_matmul_cuda(x, block_expert, n_used, w, block_rows, n_pairs):
    """One launch of the grouped bf16 kernel on its bounded plan."""
    X, K, N = w.shape
    R = x.shape[0]
    if x.shape[1] != K:
        raise ValueError(f"expert weights {tuple(w.shape)} do not match K={x.shape[1]}")
    tables = _block_tables("grouped_gemm", x, block_expert, n_used, block_rows)
    plan = grouped_bf16_plan(R, K, N, X, n_pairs)
    x, w = aligned16(x), w.contiguous()
    _check_bf16("grouped_gemm", x, w, x.dtype, *tables)
    out = torch.empty((R, N), dtype=x.dtype, device=x.device)
    work, count = _split_buffers(x.device, plan, plan.grid[1] * BLOCK_M, N)
    lib, fn = _build.function("grouped_gemm", "grouped_gemm", _GROUPED_BF16_ARGS)
    err = fn(x.data_ptr(), w.data_ptr(), *(t.data_ptr() for t in tables),
             out.data_ptr(), _build.ptr(work), _build.ptr(count), R, K, N, X, 0, plan.grid[2],
             plan.stages_per_split, plan.grid[1], _build.stream_of(x))
    _build.check(lib, err, "grouped_gemm")
    grouped_matmul.launches += 1
    return out


def grouped_matmul(x: torch.Tensor, block_expert: torch.Tensor,
                   n_used: torch.Tensor, w: torch.Tensor,
                   block_rows: Optional[torch.Tensor] = None, *,
                   n_pairs: int) -> torch.Tensor:
    """Per-block expert GEMM: block b of x [R, K] (R = NB * BLOCK_M, rows
    grouped by expert) times w[block_expert[b]] of w [X, K, N], in x's dtype
    with fp32 sums; blocks b >= n_used give zeros.

    ``block_rows`` [NB] int32 (optional) says how many rows at the head of
    each block are routed rows; the kernel then writes zeros for the rows
    past them instead of multiplying their zero inputs. ``n_pairs``: the
    (token, expert) pairs the rows were aligned from; the kernel launches
    only the row blocks such a routing can use (``grouped_row_bound``) and
    zeroes the rest."""
    if x.is_cuda:
        return _grouped_matmul_cuda(x, block_expert, n_used, w, block_rows, n_pairs)
    if x.device.type == "cpu":
        return grouped_matmul_plain(x, block_expert, n_used, w)
    raise NotImplementedError(f"grouped_matmul on {x.device}")


grouped_matmul.launches = 0


def grouped_quant_matmul_plain(x: torch.Tensor, block_expert: torch.Tensor,
                               n_used: torch.Tensor, p: dict, bits: int) -> torch.Tensor:
    """The grouped GEMM over dequantized weight-only experts, fp32 sums,
    cast to x.dtype."""
    spec = QuantSpec(bits=bits)
    return _grouped_plain(
        x, block_expert, n_used,
        lambda e: dequantize({"q": p["q"][e], "s": p["s"][e]}, spec, torch.float32),
        p["q"].shape[2], x.dtype)


_GROUPED_WEIGHT_ONLY_ARGS = (ctypes.c_void_p,) * 8 + (ctypes.c_int,) * 9 + (ctypes.c_void_p,)


def _grouped_quant_matmul_cuda(x, block_expert, n_used, p, bits, block_rows, n_pairs):
    """One launch of the grouped int4 or int8 kernel (both take the same
    arguments) on its bounded plan."""
    if bits not in (4, 8):
        raise ValueError(f"weight-only experts are int4 or int8, not {bits} bits")
    name = f"grouped_int{bits}_gemm"
    q, s = p["q"].contiguous(), p["s"].contiguous()
    R, K = x.shape
    X, N = q.shape[0], q.shape[-1]
    group = check_weight_only_operands(name, bits, x, q, s, K, N, x.dtype)
    if q.dim() != 3 or s.dim() != 3 or s.shape[0] != X:
        raise ValueError(f"{name}: experts {tuple(q.shape)} and scales "
                         f"{tuple(s.shape)} do not match")
    tables = _block_tables(name, x, block_expert, n_used, block_rows)
    plan = (grouped_int4_plan if bits == 4 else grouped_int8_plan)(
        R, K, N, group, X, n_pairs)
    x = aligned16(x)
    out = torch.empty((R, N), dtype=x.dtype, device=x.device)
    bounded = plan.grid[1] * BLOCK_M
    work = (torch.empty((plan.grid[2], bounded, N), dtype=torch.float32, device=x.device)
            if plan.grid[2] > 1 and bounded else None)
    lib, fn = _build.function(name, name, _GROUPED_WEIGHT_ONLY_ARGS)
    err = fn(x.data_ptr(), q.data_ptr(), s.data_ptr(),
             *(t.data_ptr() for t in tables), out.data_ptr(), _build.ptr(work),
             R, K, N, X, group, 0, plan.grid[2], plan.stages_per_split, plan.grid[1],
             _build.stream_of(x))
    _build.check(lib, err, name)
    grouped_quant_matmul.modes[f"int{bits}"] += 1
    grouped_quant_matmul.launches += 1
    return out


def grouped_quant_matmul(x: torch.Tensor, block_expert: torch.Tensor,
                         n_used: torch.Tensor, p: dict, bits: int,
                         block_rows: Optional[torch.Tensor] = None, *,
                         n_pairs: int) -> torch.Tensor:
    """``grouped_matmul`` over weight-only int8 / int4 experts
    ``{"q": [X, Kq, N], "s": [X, K/group, N]}``: the grouped twin of the
    stacked-layer quantized GEMMs, the scale on each group's fp32 partial
    sum, out in x's dtype. ``n_pairs``: the (token, expert) pairs the rows
    were aligned from; the kernels launch only the row blocks such a routing
    can use (``grouped_row_bound``) and zero the rest."""
    if x.is_cuda:
        return _grouped_quant_matmul_cuda(x, block_expert, n_used, p, bits, block_rows,
                                          n_pairs)
    if x.device.type == "cpu":
        return grouped_quant_matmul_plain(x, block_expert, n_used, p, bits)
    raise NotImplementedError(f"grouped_quant_matmul on {x.device}")


grouped_quant_matmul.launches = 0
grouped_quant_matmul.modes = {"int4": 0, "int8": 0}  # launches by expert format


# ---------------------------------------------------------------------------
# the routed expert MLP
# ---------------------------------------------------------------------------


def routed_expert_mlp(
    x: torch.Tensor,  # [T, E]
    topi: torch.Tensor,  # [T, k] expert ids; id == n_experts -> dropped
    topv: torch.Tensor,  # [T, k] routing weights
    wgu,  # [X, E, 2I] or weight-only quant dict (X = local experts)
    wdown,  # [X, I, E] likewise
    n_experts: int,
    inter_size: int,
    spec: Optional[QuantSpec] = None,
) -> torch.Tensor:
    """Exact routed two-GEMM expert MLP (align -> gather -> gate -> combine),
    the shared core of the grouped prefill path and of the expert-shard path.
    Returns the routed contribution [T, E] in fp32.

    The combine is a gather, not a scatter-add: each token's k rows are read
    back and summed from an fp32 zero in ascending expert order. That is the
    scan path's order (``acc + out * rw`` over the experts, zeros for those
    not chosen), and it is the same on every run, where an atomic scatter-add
    on the card is not."""
    T, E = x.shape
    I = inter_size
    dest_tok, row_w, block_expert, n_used, tok_rows = _align(topi, topv, n_experts, T)
    block_rows = _block_rows(dest_tok, T)
    x_pad = torch.cat([x, torch.zeros((1, E), dtype=x.dtype, device=x.device)], dim=0)
    xg = x_pad[dest_tok.long()]  # [R, E]; pad and dropped rows read the zero row

    def gmm(inp, w):
        if isinstance(w, dict):
            return grouped_quant_matmul(inp, block_expert, n_used, w, spec.bits,
                                        block_rows, n_pairs=T * topi.shape[1])
        return grouped_matmul(inp, block_expert, n_used, w.to(inp.dtype), block_rows,
                              n_pairs=T * topi.shape[1])

    gu = gmm(xg, wgu)  # [R, 2I]
    act = F.silu(gu[..., :I].to(torch.float32)).to(x.dtype) * gu[..., I:]
    outr = gmm(act, wdown)  # [R, E]
    out = torch.zeros((T, E), dtype=torch.float32, device=x.device)
    for j in range(tok_rows.shape[1]):
        rows = tok_rows[:, j]
        out = out + outr[rows].to(torch.float32) * row_w[rows][:, None]
    return out


def moe_block_grouped(lp: dict, cfg, h: torch.Tensor,
                      route_w: torch.Tensor) -> torch.Tensor:
    """Routed-experts contribution [B, Q, E] (fp32) via the grouped GEMMs,
    from the dense routing weights ``route_w`` [T, X] (zeros off the top-k).
    Shared experts are the caller's (``models/moe.py`` ``moe_block``)."""
    B, Q, E = h.shape
    I = cfg.moe_intermediate_size or cfg.intermediate_size
    topv, topi = stable_topk(route_w, cfg.num_experts_per_tok)  # the sparse routing
    out = routed_expert_mlp(h.reshape(B * Q, E), topi, topv, lp["moe_wgu"],
                            lp["moe_wdown"], cfg.num_experts, I)
    return out.reshape(B, Q, E)


def use_grouped_moe(cfg, spec, lp: dict, n_tokens: int) -> bool:
    """The grouped path serves prefill-size batches of native (unquantized)
    experts on the card; decode batches touch about every expert, so the
    scan over experts already moves the fewest bytes. The threshold (the
    average expert gets at least two row blocks) is the JAX package's,
    measured there on a TPU; PERF.md holds both paths' times on the H100."""
    wgu = lp["moe_wgu"]
    return (
        not isinstance(wgu, dict)
        and wgu.is_cuda
        and spec is None
        and n_tokens * cfg.num_experts_per_tok >= 2 * BLOCK_M * cfg.num_experts
    )
