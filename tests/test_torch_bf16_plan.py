"""The bf16 GEMM kernels' launch plan, their shape rule and their operand
layout, on the CPU.

The kernels (``csrc/grouped_gemm.cu``: the dense, head-batched and grouped
entries over the body ``csrc/bf16_wgmma.cuh``) run only on the card; what
they are given is decided here, in Python that the wrappers call: the K
split (a function of K and N alone, the same for the three entries, so
that a row's bits depend neither on the batch nor on the entry), the grid,
how the splits are launched, the grouped entry's bounded row extent, and
the shapes that raise. The operand layout is the hardware's: the tensor
memory accelerator lands each stage in the 128-byte swizzle and wgmma
reads it through a descriptor; both address maps are replayed in numpy and
held against the weight and x.
"""

import numpy as np
import pytest

from painlessinferenceacceleration_tpu_torch.config import ModelConfig
from painlessinferenceacceleration_tpu_torch.ops.moe_matmul import (
    BF16_STAGE,
    BLOCK_M,
    bf16_batched_plan,
    bf16_check,
    bf16_plan,
    bf16_split,
    bf16_split_blocks,
    grouped_bf16_plan,
    grouped_row_bound,
)
from painlessinferenceacceleration_tpu_torch.ops.quant_matmul import split_blocks, stage_split
from test_torch_w8a8_plan import CONFIGS, linear_shapes

ROWS = (1, 2, 17, 63, 64, 65, 128, 136, 300, 512, 4096)


def bf16_shapes(cfg: ModelConfig) -> set:
    """(K, N) of every product a bf16 model of ``cfg`` runs through the bf16
    kernels: its linears and experts (``linear_shapes``), the router, the LM
    head (a tied head reads the [vocab, E] table transposed: the same K and
    N) and MLA's per-head absorption products."""
    shapes = linear_shapes(cfg) | {(cfg.hidden_size, cfg.vocab_size)}
    if cfg.is_moe:
        shapes.add((cfg.hidden_size, cfg.num_experts))
    if cfg.is_mla:
        shapes |= {(cfg.qk_nope_head_dim, cfg.kv_lora_rank),
                   (cfg.kv_lora_rank, cfg.v_head_dim)}
    return shapes


# chip_smoke.py's kernel shapes beyond the configs: Qwen3-30B-A3B's experts
# and router, DeepSeek-V3's absorption (128 heads of the same widths)
EXTRA_SHAPES = {(2048, 1536), (768, 2048), (2048, 128), (128, 512), (512, 128)}
CARD_SHAPES = sorted(set().union(*(bf16_shapes(c) for c in CONFIGS.values()))
                     | EXTRA_SHAPES | {(328, 264), (4096, 8)})


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_every_model_config_takes_the_kernels(name):
    shapes = bf16_shapes(CONFIGS[name])
    assert len(shapes) >= 5
    for K, N in shapes:
        bf16_check(K, N)
    for K, N in EXTRA_SHAPES:
        bf16_check(K, N)


@pytest.mark.parametrize("K,N", [(4100, 4096), (4096, 4100), (333, 260), (4, 4096),
                                 (0, 8), (8, 0), (4096, 6148)])
def test_shapes_off_the_8_grid_raise(K, N):
    with pytest.raises(ValueError, match="% 8"):
        bf16_check(K, N)
    with pytest.raises(ValueError):
        bf16_plan(17, K, N)
    with pytest.raises(ValueError):
        bf16_batched_plan(16, 17, K, N)
    with pytest.raises(ValueError):
        grouped_bf16_plan(BLOCK_M * 10, K, N, 8, 2)


def test_other_refusals_raise():
    with pytest.raises(ValueError):
        bf16_plan(0, 4096, 4096)  # no rows
    with pytest.raises(ValueError):
        bf16_batched_plan(65536, 1, 128, 512)  # a grid's z extent
    with pytest.raises(ValueError):
        bf16_batched_plan(0, 1, 128, 512)
    with pytest.raises(ValueError):
        grouped_bf16_plan(BLOCK_M * 10 + 1, 4096, 4096, 8, 2)  # not whole blocks


@pytest.mark.parametrize("K,N", CARD_SHAPES)
def test_split_is_a_function_of_k_and_n_alone_and_shared_by_the_entries(K, N):
    ks, sps = bf16_split(K, N)
    assert (ks, sps) == stage_split(K, N, BF16_STAGE)
    n_stages = -(-K // BF16_STAGE)
    assert 1 <= ks and (ks - 1) * sps < n_stages <= ks * sps  # no split is empty
    assert ks == 1 or sps * BF16_STAGE >= 512  # a split keeps 512 rows of K at the least
    cols = -(-N // 128)
    for M in ROWS:
        plan = bf16_plan(M, K, N)
        assert (plan.ksplit, plan.stages_per_split) == (ks, sps)
        assert plan.warpgroups == (1 if M <= 64 else 2)
        tiles = -(-M // (64 * plan.warpgroups))
        assert plan.grid[:2] == (cols, tiles) and plan.grid[2] in (1, ks)
        batched = bf16_batched_plan(16, M, K, N)
        assert (batched.ksplit, batched.stages_per_split, batched.warpgroups) == \
            (ks, sps, plan.warpgroups)
        assert batched.grid == (cols, tiles, 16)  # every split of a head in its block
    for R, pairs in ((BLOCK_M * 10, 2), (BLOCK_M * 73, 8192)):
        gplan = grouped_bf16_plan(R, K, N, 8, pairs)
        assert (gplan.ksplit, gplan.stages_per_split, gplan.warpgroups) == (ks, sps, 2)


def test_splits_launch_as_blocks_at_decode_and_in_one_block_where_that_is_faster():
    # one warpgroup: the shared rule of the tensor-core GEMMs
    for K, N in CARD_SHAPES:
        ks, sps = bf16_split(K, N)
        cols = -(-N // 128)
        for M in (1, 17, 64):
            assert bf16_plan(M, K, N).grid[2] == split_blocks(ks, cols, 1)
    # decode fills the card with splits: a 4096 x 6144 wqkv in 5 splits of 13
    # stages (240 blocks), Mixtral's router in 8
    assert bf16_plan(1, 4096, 6144) == (5, 13, 1, (48, 1, 5))
    assert bf16_plan(1, 4096, 8).grid == (1, 1, 8)
    # two warpgroups: the estimate, held to what the card measured
    # (tools/k10_variants.py): from M = 512 every split runs in its tile's
    # block; at M = 128 and 256 a long K (Mixtral's down projection, 7B's)
    # still launches its splits, a wqkv or DeepSeek-V2-Lite's kv_a (N = 576)
    # does not; the LM head has one split
    assert bf16_plan(512, 4096, 6144).grid == (48, 4, 1)
    assert bf16_plan(512, 11008, 4096).grid == (32, 4, 1)
    assert bf16_plan(512, 2048, 576).grid == (5, 4, 1)
    assert bf16_plan(128, 2048, 576).grid == (5, 1, 1)
    assert bf16_plan(128, 4096, 6144).grid == (48, 1, 1)
    assert bf16_plan(256, 14336, 4096).grid == (32, 2, 4)
    assert bf16_plan(128, 11008, 4096).grid == (32, 1, 4)
    assert bf16_plan(512, 4096, 32000) == (1, 64, 2, (250, 4, 1))
    for M in (65, 512, 4096):
        for K, N in CARD_SHAPES:
            ks, sps = bf16_split(K, N)
            cols, tiles = -(-N // 128), -(-M // 128)
            got = bf16_split_blocks(M, K, N, 2, cols, tiles)
            assert got in (1, ks) and bf16_plan(M, K, N).grid[2] == got


def test_grouped_grid_is_bounded_by_the_routing():
    for X, k, T in ((8, 2, 1), (8, 2, 17), (128, 8, 1), (128, 8, 136), (8, 2, 4096),
                    (64, 6, 1), (256, 8, 17)):
        NB = -(-T * k // BLOCK_M) + X + 1
        for K, N in ((4096, 28672), (14336, 4096), (2048, 1536), (768, 2048)):
            plan = grouped_bf16_plan(NB * BLOCK_M, K, N, X, T * k)
            assert plan.grid[1] == grouped_row_bound(NB, X, T * k)
            assert plan.grid[1] == min(NB, min(X, T * k) + -(-T * k // BLOCK_M))
            assert plan.grid[0] == -(-N // 128)
    # decode on Mixtral: 3 of the 11 row blocks, not the static worst case
    assert grouped_bf16_plan(11 * BLOCK_M, 4096, 28672, 8, 2).grid[1] == 3
    # a pair count of every row: every block
    assert grouped_row_bound(11, 8, 11 * BLOCK_M) == 11


@pytest.mark.parametrize("X,k,K,N", [(8, 2, 14336, 4096), (64, 6, 2048, 2816),
                                     (64, 6, 1408, 2048), (256, 8, 7168, 4096)])
def test_grouped_entry_launches_its_splits_by_the_dense_entrys_estimate(X, k, K, N):
    # one rule for the body's three entries: the grouped entry's split
    # launch is the dense entry's estimate over the rows it writes, the
    # routed rows (a block's padding rows write no plane)
    ks, _ = bf16_split(K, N)
    for T in (1, 2, 8, 17, 136, 512, 4096):
        NB = -(-T * k // BLOCK_M) + X + 1
        plan = grouped_bf16_plan(NB * BLOCK_M, K, N, X, T * k)
        cols, rows = plan.grid[:2]
        assert plan.grid[2] == bf16_split_blocks(min(rows * BLOCK_M, T * k), K, N, 2,
                                                 cols, rows)
        assert plan.grid[2] in (1, ks)


# ---------------------------------------------------------------------------
# the operand layout: TMA's 128-byte swizzle and wgmma's descriptors
# ---------------------------------------------------------------------------


def _swizzle(offset: np.ndarray) -> np.ndarray:
    """The 128-byte swizzle on a byte offset from a 1024-byte boundary: the
    16-byte chunk (bits 4-6) XOR the 128-byte row in its atom (bits 7-9)."""
    return offset ^ (((offset >> 7) & 7) << 4)


def _tma_land(box: np.ndarray) -> np.ndarray:
    """A box [rows][64] of bf16 as TMA lands it in the 128-byte swizzle:
    shared memory as 2-byte elements."""
    rows = box.shape[0]
    smem = np.full(rows * 64, -1, dtype=np.int64)
    r, c = np.meshgrid(np.arange(rows), np.arange(64), indexing="ij")
    smem[_swizzle(r * 128 + c * 2) // 2] = box
    return smem


def _kmajor_read(smem: np.ndarray, start: int, rows: int) -> np.ndarray:
    """What a wgmma k16 step reads through a K-major 128-byte-swizzle
    descriptor (sw_desc<128>: 8-row groups 1024 bytes apart) from byte
    ``start``: [rows][16], row r at r % 8 rows of 128 bytes plus r / 8
    groups, k at 2 bytes each."""
    r, k = np.meshgrid(np.arange(rows), np.arange(16), indexing="ij")
    offset = start + (r % 8) * 128 + (r // 8) * 1024 + 2 * k
    return smem[_swizzle(offset) // 2]


def _mnmajor_read(smem: np.ndarray, start: int) -> np.ndarray:
    """What a wgmma k16 step reads through the MN-major descriptor
    (mn_desc: the PTX canonical layout ((8, 8, m), (8, k)) : ((1, 8, LBO),
    (64, SBO)) in elements, LBO = 8192 bytes (the second 64-column box),
    SBO = 1024 bytes (the next 8 k rows)) from byte ``start``: B [16][128]."""
    k, n = np.meshgrid(np.arange(16), np.arange(128), indexing="ij")
    element = (n % 8) + 8 * ((n // 8) % 8) + 64 * (k % 8)
    offset = start + 2 * element + 8192 * (n // 64) + 1024 * (k // 8)
    return smem[_swizzle(offset) // 2]


def test_mn_major_weight_stage_reads_as_the_weight():
    """A [K, N] weight: a stage lands as two boxes of 64 columns x 64 k rows;
    k16 step t of the stage reads w[16 t : 16 t + 16, 0 : 128] (the
    instruction's B, transposed bit set)."""
    rng = np.random.default_rng(0)
    w = rng.integers(0, 1 << 16, size=(BF16_STAGE, 128))  # [k][n] of one stage
    smem = np.concatenate([_tma_land(w[:, :64]), _tma_land(w[:, 64:])])
    assert (smem >= 0).all()
    for t in range(BF16_STAGE // 16):
        np.testing.assert_array_equal(_mnmajor_read(smem, 2048 * t), w[16 * t:16 * t + 16])


def test_k_major_weight_and_x_stages_read_as_the_operands():
    """A [N, K] table (the tied head) and x: a stage lands as one box of 64
    k x 128 (or 64 W) rows; k16 step t reads columns 16 t .. 16 t + 15 of
    every row (the instruction's A, and its B with the transposed bit
    clear)."""
    rng = np.random.default_rng(1)
    for rows in (64, 128):
        a = rng.integers(0, 1 << 16, size=(rows, BF16_STAGE))  # [row][k]
        smem = _tma_land(a)
        for t in range(BF16_STAGE // 16):
            np.testing.assert_array_equal(_kmajor_read(smem, 32 * t, rows),
                                          a[:, 16 * t:16 * t + 16])
    # warpgroup 1's A: its 64 rows from byte 64 * 128 of the x stage
    a = rng.integers(0, 1 << 16, size=(128, BF16_STAGE))
    smem = _tma_land(a)
    np.testing.assert_array_equal(_kmajor_read(smem, 64 * 128 + 32, 64), a[64:, 16:32])
