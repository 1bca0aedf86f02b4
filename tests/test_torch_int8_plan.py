"""The int8 weight-only GEMM kernels' launch plan, their shape rule and
their operand arithmetic, on the CPU.

The kernels (``csrc/int8_gemm.cu``, ``csrc/grouped_int8_gemm.cu``, the body
in ``csrc/weight_only_wgmma.cuh``) run only on the card; what they are
given is decided here, in Python that the wrappers call: the ring stage of
a scale group, the K split (a function of K, N and the group alone, so
that a row's bits do not depend on the batch), the grid, the grouped
kernel's bounded row extent, and the shapes that raise, before a launch and
when a model is built. The int8 -> bf16 widening and the stores that lay
each widened stage into the tensor cores' K-major operand are replayed in
numpy, thread by thread, and held against the weight.
"""

import numpy as np
import pytest
import torch

from painlessinferenceacceleration_tpu_torch.layers.linear import effective_group
from painlessinferenceacceleration_tpu_torch.ops.moe_matmul import (
    BLOCK_M,
    grouped_int4_plan,
    grouped_int8_plan,
    grouped_row_bound,
)
from painlessinferenceacceleration_tpu_torch.ops.quant_matmul import (
    INT8_STAGES,
    check_int8_params,
    int4_plan,
    int8_check,
    int8_plan,
    int8_split,
    int8_stage,
    split_blocks,
    stage_split,
)
from test_torch_w8a8_plan import CONFIGS, linear_shapes

ROWS = (1, 2, 17, 63, 64, 65, 128, 300, 512, 4096)
# (K, N, group) of the card paths and the card tests: Llama-2-7B's layers and
# LM head, Mixtral-8x7B's and Qwen3-30B-A3B's experts, DeepSeek-V2-Lite's
# whole-K dense down projection, group 64, and off-grid shapes
CARD_SHAPES = [(4096, 12288, 128), (4096, 4096, 128), (4096, 22016, 128),
               (11008, 4096, 128), (4096, 32000, 128), (4096, 28672, 128),
               (14336, 4096, 128), (2048, 1536, 128), (768, 2048, 128),
               (10944, 2048, 10944), (4096, 22016, 64), (256, 384, 64),
               (352, 272, 352), (192, 144, 192), (4096, 1024, 128)]


def test_stage_is_the_largest_of_128_64_32_that_divides_the_group():
    for group, stage in ((128, 128), (256, 128), (4096, 128), (64, 64), (192, 64),
                         (10944, 64), (32, 32), (96, 32), (352, 32), (48, 0), (16, 0),
                         (333, 0)):
        assert int8_stage(group) == stage, group
    assert INT8_STAGES == (128, 64, 32)


@pytest.mark.parametrize("K,N,group", CARD_SHAPES)
def test_split_is_a_function_of_k_n_and_the_group_alone(K, N, group):
    stage = int8_stage(group)
    ks, sps = int8_split(K, N, group)
    assert (ks, sps) == stage_split(K, N, stage)
    n_stages = K // stage
    assert 1 <= ks and (ks - 1) * sps < n_stages <= ks * sps  # no split is empty
    assert ks == 1 or sps * stage >= 512  # a split keeps 512 rows of K at the least
    cols = -(-N // 128)
    for M in ROWS:
        plan = int8_plan(M, K, N, group)
        assert (plan.ksplit, plan.stages_per_split) == (ks, sps)
        assert plan.warpgroups == (1 if M <= 64 else 2)
        tiles = -(-M // (64 * plan.warpgroups))
        assert plan.grid == (cols, tiles, split_blocks(ks, cols, tiles))
    for R, pairs in ((BLOCK_M * 10, 2), (BLOCK_M * 73, 8192)):
        gplan = grouped_int8_plan(R, K, N, group, 8, pairs)
        assert (gplan.ksplit, gplan.stages_per_split, gplan.warpgroups) == (ks, sps, 2)


def test_group_128_splits_as_int4_does():
    # a 128-row group is one stage for both formats: the same split and grid
    for K, N, _ in CARD_SHAPES[:9]:
        for M in (1, 17, 512):
            assert int8_plan(M, K, N, 128) == int4_plan(M, K, N, 128)


def test_splits_run_in_one_block_where_the_row_tiles_fill_the_card():
    # Llama-2-7B qkv (4 splits): launched as blocks at decode, in one block
    # from 4 row tiles of 128 rows (384 blocks, 97 % of their last wave)
    assert [int8_plan(M, 4096, 12288, 128).grid[2] for M in (1, 17, 64, 65, 512, 4096)] \
        == [4, 4, 4, 4, 1, 1]
    # DeepSeek-V2-Lite's down projection, one group of 10944 rows in 171
    # stages of 64: 7 splits of 25 stages over 16 column blocks at decode,
    # in one block from 8 row tiles (128 blocks)
    assert int8_split(10944, 2048, 10944) == (7, 25)
    assert [int8_plan(M, 10944, 2048, 10944).grid[2] for M in (1, 17, 512, 4096)] \
        == [7, 7, 7, 1]
    # the grouped kernel decides from its bounded grid: Mixtral's down
    # projection at decode (3 row blocks) and over 8192 routed rows
    assert grouped_int8_plan((1 + 8 + 1) * BLOCK_M, 14336, 4096, 128, 8, 2).grid \
        == (32, 3, 4)
    assert grouped_int8_plan((64 + 8 + 1) * BLOCK_M, 14336, 4096, 128, 8, 8192).grid \
        == (32, 72, 1)


def test_grouped_grid_is_bounded_by_the_routing():
    # Mixtral decode (T = 1, k = 2, X = 8): 3 row blocks of the 10 padded
    R = (1 + 8 + 1) * BLOCK_M
    assert grouped_int8_plan(R, 4096, 28672, 128, 8, 2).grid == (224, 3, 1)
    # Qwen3-30B-A3B decode (T = 1, k = 8, X = 128): 9 of 130; a prefill's
    # bound is every block of the padded layout
    R = (1 + 128 + 1) * BLOCK_M
    assert grouped_int8_plan(R, 2048, 1536, 128, 128, 8).grid[1] == 9
    assert grouped_int8_plan(R, 2048, 1536, 128, 128, 4096).grid[1] == R // BLOCK_M
    for NB, X, pairs in ((10, 8, 2), (130, 128, 8), (73, 8, 8192), (40, 8, 600)):
        plan = grouped_int8_plan(NB * BLOCK_M, 4096, 4096, 128, X, pairs)
        assert plan.grid[1] == grouped_row_bound(NB, X, pairs)
        # the int4 twin launches the same rows
        assert plan.grid == grouped_int4_plan(NB * BLOCK_M, 4096, 4096, 128, X, pairs).grid


@pytest.mark.parametrize("K,N,group", [(333, 256, 333), (4096, 260, 128), (4096, 4096, 48),
                                       (4096, 4096, 16), (4000, 4096, 128), (0, 4096, 128),
                                       (4096, 0, 64), (4096, 4104, 128)])
def test_plan_raises_on_shapes_the_kernels_do_not_take(K, N, group):
    with pytest.raises(ValueError):
        int8_check(K, N, group)
    with pytest.raises(ValueError):
        int8_plan(17, K, N, group)
    with pytest.raises(ValueError):
        grouped_int8_plan(BLOCK_M * 4, K, N, group, 8, 2)


def _int8_leaves(cfg, group: int = 128) -> dict:
    """A weight-only int8 leaf (shapes only, on the meta device) for every
    linear weight of ``cfg``, grouped as ``quantize`` groups it."""
    leaves = {}
    for K, N in linear_shapes(cfg):
        g = effective_group(K, group)
        leaves[f"{K}x{N}"] = {"q": torch.empty(2, K, N, dtype=torch.int8, device="meta"),
                              "s": torch.empty(2, K // g, N, dtype=torch.bfloat16,
                                               device="meta")}
    return leaves


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_every_model_config_takes_the_kernels(name):
    leaves = _int8_leaves(CONFIGS[name])
    assert len(leaves) >= 5
    check_int8_params({"layers": leaves})
    for p in leaves.values():
        K, N = p["q"].shape[-2:]
        group = K // p["s"].shape[-2]
        int8_check(K, N, group)
        assert int8_stage(group) in INT8_STAGES


def test_the_model_groups_are_128_but_for_two():
    # tiny's 64-wide input rows and DeepSeek-V2-Lite's dense down projection
    # (10944 rows, not a multiple of 128: one group)
    groups = {name: {p["q"].shape[-2] // p["s"].shape[-2] for p in _int8_leaves(c).values()}
              for name, c in CONFIGS.items()}
    assert groups["tiny"] == {64, 128}
    assert groups["deepseek_v2_lite"] == {128, 10944}
    for name in ("llama2_7b", "mixtral_8x7b", "ring_mini_linear_2", "mla_3b"):
        assert groups[name] == {128}, name


def test_int8_params_check_refuses_a_weight_the_kernels_do_not_take():
    ok = {"layers": {"wqkv": {"q": torch.zeros(2, 256, 384, dtype=torch.int8),
                              "s": torch.ones(2, 2, 384, dtype=torch.bfloat16)}},
          # W8A8 (fp32 per-channel scales) and int4 (uint8) leaves are not
          # the int8 kernels'
          "w8a8": {"q": torch.zeros(72, 200, dtype=torch.int8), "s": torch.ones(200)},
          "int4": {"q": torch.zeros(36, 200, dtype=torch.uint8),
                   "s": torch.ones(1, 200, dtype=torch.bfloat16)},
          "norm": torch.ones(256)}
    check_int8_params(ok)
    for bad in ({"lm_head": {"q": torch.zeros(256, 200, dtype=torch.int8),  # N % 16
                             "s": torch.ones(2, 200, dtype=torch.bfloat16)}},
                {"wo": [{"q": torch.zeros(96, 64, dtype=torch.int8),  # a group of 48
                         "s": torch.ones(2, 64, dtype=torch.bfloat16)}]},
                {"moe": {"moe_wgu": {"q": torch.zeros(4, 333, 64, dtype=torch.int8),
                                     "s": torch.ones(4, 1, 64, dtype=torch.bfloat16)}}}):
        with pytest.raises(ValueError):
            check_int8_params(bad)


def _bf16_bits_to_float(bits: np.ndarray) -> np.ndarray:
    return (bits.astype(np.uint32) << 16).view(np.float32)


def _s8x2_to_bf16x2(v: np.ndarray) -> np.ndarray:
    """``s8x2_to_bf16x2`` of csrc/weight_only_wgmma.cuh on uint32 words:
    fma.rn.bf16x2(low7, 1.0, bias), each half rounded to bf16 once (the
    product and sum are exact in fp64 here); returns the result's bits."""
    low7 = (v & 0x007F007F) | 0x43004300
    bias = (v & 0x00800080) | 0xC300C300
    out = np.zeros_like(v)
    for shift in (0, 16):
        a = _bf16_bits_to_float((low7 >> shift) & 0xFFFF).astype(np.float64)
        b = _bf16_bits_to_float((bias >> shift) & 0xFFFF).astype(np.float64)
        exact = (a * 1.0 + b).astype(np.float32)  # integers below 2^8: exact
        f32 = exact.view(np.uint32)
        assert not (f32 & 0xFFFF).any()  # a bf16 value: no rounding happened
        out |= (f32 >> 16) << shift
    return out


def test_widening_is_exact_for_every_byte():
    b = np.arange(256, dtype=np.uint32)
    signed = b.astype(np.uint8).view(np.int8).astype(np.float32)
    # both halves of a word, as the kernel's bf16x2 sees them (bits 8-15 and
    # 24-31 hold the other bytes of the byte_perm's result: ignored)
    words = b | (b[::-1] << 16) | (np.uint32(0xA5) << 8) | (np.uint32(0x5A) << 24)
    got = _s8x2_to_bf16x2(words)
    np.testing.assert_array_equal(_bf16_bits_to_float(got & 0xFFFF), signed)
    np.testing.assert_array_equal(_bf16_bits_to_float(got >> 16), signed[::-1])
    # and in torch's own bf16 arithmetic
    low7 = torch.from_numpy(((b & 0x7F) | 0x4300).astype(np.int16)).view(torch.bfloat16)
    bias = torch.from_numpy(((b & 0x80) | 0xC300).astype(np.int16)).view(torch.bfloat16)
    assert (low7 + bias).dtype == torch.bfloat16
    assert torch.equal((low7 + bias).float(), torch.from_numpy(signed))


def _byte_perm(x: int, y: int, sel: int) -> int:
    b = x.to_bytes(4, "little") + y.to_bytes(4, "little")
    return int.from_bytes(bytes(b[(sel >> (4 * i)) & 7] for i in range(4)), "little")


def _sw_offset(u: int, row: int, rb: int, rows: int = 128) -> int:
    """sw_offset<RB>(u, row, rows) of csrc/wgmma_common.cuh."""
    chunks = rb // 16
    slot = (row & 7) if rb == 128 else ((row >> 1) & 3)
    return (u // chunks) * (rows * rb) + row * rb + (((u % chunks) ^ slot) << 4)


def _widen_stage(qs: np.ndarray, stage: int) -> tuple:
    """csrc/weight_only_wgmma.cuh widen_stage, thread by thread: the bf16
    operand it writes (as uint16 bits) and, per (band, step), the 16-byte
    bank group of each lane's store."""
    rb = 128 if stage >= 64 else 64
    bs = np.full(128 * stage, -1, dtype=np.int64)  # bf16 elements
    groups = {}
    for i0 in range(0, 4 * stage, 256):
        for tid in range(256):
            i = i0 + tid
            if i >= 4 * stage:
                break
            u, lane = i >> 5, tid & 31
            w = [int.from_bytes(qs[8 * u + e, 4 * lane:4 * lane + 4].tobytes(), "little")
                 for e in range(8)]
            for step in range(4):
                c = (step + (lane >> 1)) & 3
                n = 4 * lane + c
                sel = c | ((c + 4) << 8)
                h = [int(_s8x2_to_bf16x2(np.array([_byte_perm(w[2 * j], w[2 * j + 1], sel)],
                                                  dtype=np.uint32))[0])
                     for j in range(4)]
                off = _sw_offset(u, n, rb)
                assert off % 16 == 0 and (bs[off // 2:off // 2 + 8] == -1).all()
                for j in range(4):
                    bs[off // 2 + 2 * j] = h[j] & 0xFFFF
                    bs[off // 2 + 2 * j + 1] = h[j] >> 16
                groups.setdefault((i0, u, step), []).append((off // 16) % 8)
    return bs, groups, rb


@pytest.mark.parametrize("stage", INT8_STAGES)
def test_widened_operand_holds_the_weight_k_major_in_the_swizzle(stage):
    rng = np.random.default_rng(stage)
    q = rng.integers(-128, 128, size=(stage, 128), dtype=np.int8)  # [k][n], as TMA lands it
    bs, groups, rb = _widen_stage(q.view(np.uint8), stage)
    assert (bs >= 0).all()  # every element written once
    # what the tensor cores read: operand row n, k at element k % 8 of chunk
    # k / 8 in its swizzled slot
    got = np.empty((128, stage), dtype=np.float32)
    for n in range(128):
        for k in range(stage):
            got[n, k] = _bf16_bits_to_float(np.array([bs[_sw_offset(k // 8, n, rb) // 2
                                                         + k % 8]]))[0]
    np.testing.assert_array_equal(got, q.T.astype(np.float32))
    # each 8-lane phase of a warp's 16-byte stores hits 8 different bank groups
    for lanes in groups.values():
        for p in range(0, len(lanes), 8):
            assert len(set(lanes[p:p + 8])) == len(lanes[p:p + 8])
