"""The W8A8 GEMM kernel's launch plan, its shape rule and its operand
transposition, and the block-fp8 kernel's, which runs on the same body, on
the CPU.

The kernel (``csrc/w8a8_wgmma.cuh``) runs only on the card; what it is
given is decided here, in Python that the wrapper calls: the K split (a
function of K and N alone, so that a row's bits do not depend on the
batch), the grid, and the shapes that raise, before a launch and when a
model is built. The byte transposition that turns each weight stage into
the tensor cores' K-major operand is replayed in numpy, index for index,
and held against the plain transpose.
"""

import numpy as np
import pytest
import torch

from painlessinferenceacceleration_tpu_torch.config import ModelConfig
from painlessinferenceacceleration_tpu_torch.layers.linear import QuantSpec
from painlessinferenceacceleration_tpu_torch.models.base import init_params
from painlessinferenceacceleration_tpu_torch.ops.quant_matmul import (
    quant_leaves,
    split_blocks,
    stage_split,
)
from painlessinferenceacceleration_tpu_torch.ops.w8a8 import (
    BLOCK,
    FP8,
    W8A8_STAGE,
    block_fp8_check,
    block_fp8_gemm_plain,
    block_fp8_plan,
    check_w8a8_params,
    quant_act,
    w8a8_check,
    w8a8_plan,
)

ROWS = (1, 2, 17, 63, 64, 65, 128, 300, 512, 4096)


def linear_shapes(cfg: ModelConfig) -> set:
    """(K, N) of every linear weight a model of ``cfg`` holds, as
    ``models/base.py`` (dense and MoE stacks), ``models/mla.py`` and
    ``models/linear_attn.py`` lay them out."""
    E, H, Hk, D = (cfg.hidden_size, cfg.num_attention_heads, cfg.num_key_value_heads,
                   cfg.head_dim)
    I = cfg.intermediate_size
    shapes = {(E, 2 * I), (I, E)}
    if not cfg.tie_word_embeddings:
        shapes.add((E, cfg.vocab_size))
    if cfg.is_mla:
        r, rope, nope, vd = (cfg.kv_lora_rank, cfg.qk_rope_head_dim, cfg.qk_nope_head_dim,
                             cfg.v_head_dim)
        shapes |= {(E, r + rope), (r, H * (nope + vd)), (H * vd, E)}
        if cfg.q_lora_rank:
            shapes |= {(E, cfg.q_lora_rank), (cfg.q_lora_rank, H * (nope + rope))}
        else:
            shapes.add((E, H * (nope + rope)))
    else:
        shapes |= {(E, (H + 2 * Hk) * D), (H * D, E)}
    if cfg.linear_attention:
        shapes |= {(E, 3 * H * D), (E, H * D)}
    if cfg.is_moe:
        Im = cfg.moe_intermediate_size or I
        shapes |= {(E, 2 * Im), (Im, E)}
        if cfg.num_shared_experts:
            Ish = Im * cfg.num_shared_experts
            shapes |= {(E, 2 * Ish), (Ish, E)}
    return shapes


CONFIGS = {"llama2_7b": ModelConfig.llama2_7b(), "mixtral_8x7b": ModelConfig.mixtral_8x7b(),
           "deepseek_v2_lite": ModelConfig.deepseek_v2_lite(),
           "ring_mini_linear_2": ModelConfig.ring_mini_linear_2(),
           "mla_3b": ModelConfig.mla_3b(), "tiny": ModelConfig.tiny()}
CARD_SHAPES = sorted(set().union(*(linear_shapes(c) for c in CONFIGS.values()))
                     | {(256, 384), (208, 144), (336, 272)})


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_every_model_config_takes_the_kernel(name):
    shapes = linear_shapes(CONFIGS[name])
    assert len(shapes) >= 5
    for K, N in shapes:
        w8a8_check(K, N)


def test_check_raises_off_the_16_grid():
    w8a8_check(16, 16)
    for K, N in ((4104, 4096), (4096, 4100), (333, 260), (8, 4096), (0, 16), (16, 0)):
        with pytest.raises(ValueError, match="multiples of 16|K % 16"):
            w8a8_check(K, N)
    with pytest.raises(ValueError):
        w8a8_plan(17, 4096, 4100)


@pytest.mark.parametrize("K,N", CARD_SHAPES)
def test_split_is_a_function_of_k_and_n_alone(K, N):
    ks, sps = stage_split(K, N, W8A8_STAGE)
    n_stages = -(-K // W8A8_STAGE)
    assert 1 <= ks and (ks - 1) * sps < n_stages <= ks * sps  # no split is empty
    assert ks == 1 or sps * W8A8_STAGE >= 512  # a split keeps 512 rows of K at the least
    cols = -(-N // 128)
    for M in ROWS:
        plan = w8a8_plan(M, K, N)
        assert (plan.ksplit, plan.stages_per_split) == (ks, sps)
        assert plan.warpgroups == (1 if M <= 64 else 2)
        tiles = -(-M // (64 * plan.warpgroups))
        assert plan.grid == (cols, tiles, split_blocks(ks, cols, tiles))


def test_splits_run_in_one_block_where_the_row_tiles_fill_the_card():
    # Llama-2-7B at M = 1, 17, 64, 65, 256, 512, 4096. wo, down and qkv (32
    # or 96 column blocks, 4 splits) launch their splits as blocks until 4
    # row tiles of 128 rows fill the 132 SMs (wo: 128 blocks, 97 % of a
    # wave); gate/up (172 column blocks, 2 splits) from 2 tiles (344
    # blocks, 87 % of their last wave); the LM head's 250 column blocks
    # need no split.
    widths = (1, 17, 64, 65, 256, 512, 4096)
    for K, N, ks, blocks in ((4096, 4096, 4, [4, 4, 4, 4, 4, 1, 1]),
                             (11008, 4096, 4, [4, 4, 4, 4, 4, 1, 1]),
                             (4096, 12288, 4, [4, 4, 4, 4, 4, 1, 1]),
                             (4096, 22016, 2, [2, 2, 2, 2, 1, 1, 1]),
                             (4096, 32000, 1, [1] * 7)):
        assert w8a8_plan(1, K, N).ksplit == ks
        assert [w8a8_plan(M, K, N).grid[2] for M in widths] == blocks
    assert split_blocks(4, 32, 4) == 1 and split_blocks(4, 32, 3) == 4


def _byte_perm(x: int, y: int, sel: int) -> int:
    b = x.to_bytes(4, "little") + y.to_bytes(4, "little")
    return int.from_bytes(bytes(b[(sel >> (4 * i)) & 7] for i in range(4)), "little")


def _sw_offset(u: int, row: int) -> int:
    """sw_offset<128>(u, row, 128) of csrc/wgmma_common.cuh."""
    return row * 128 + ((u ^ (row & 7)) << 4)


def _transpose_stage(qs: np.ndarray) -> tuple:
    """csrc/w8a8_wgmma.cuh transpose_stage, thread by thread: the operand
    buffer it writes and, per (warp, step), the 16-byte bank group of each
    lane's store."""
    bs = np.full(128 * 128, -1, dtype=np.int32)
    groups = {}
    for tid in range(256):
        u, lane = tid >> 5, tid & 31
        w = [int.from_bytes(qs[16 * u + r, 4 * lane:4 * lane + 4].tobytes(), "little")
             for r in range(16)]
        for step in range(4):
            c = (step + (lane >> 1)) & 3
            n = 4 * lane + c
            sel = c | ((c + 4) << 4)
            v = [_byte_perm(_byte_perm(w[4 * h], w[4 * h + 1], sel),
                            _byte_perm(w[4 * h + 2], w[4 * h + 3], sel), 0x5410)
                 for h in range(4)]
            off = _sw_offset(u, n)
            assert (bs[off:off + 16] == -1).all()  # every byte written once
            bs[off:off + 16] = np.frombuffer(
                b"".join(x.to_bytes(4, "little") for x in v), dtype=np.uint8)
            groups.setdefault((u, step), []).append((off // 16) % 8)
    return bs, groups


def test_transposed_operand_holds_the_weight_k_major_in_the_swizzle():
    rng = np.random.default_rng(0)
    qs = rng.integers(0, 256, size=(128, 128), dtype=np.uint8)  # [k][n], as TMA lands it
    bs, groups = _transpose_stage(qs)
    assert (bs >= 0).all()
    # what the tensor cores read: operand row n, k in chunk k / 16 at its
    # swizzled slot
    got = np.empty((128, 128), dtype=np.int32)
    for n in range(128):
        for k in range(128):
            got[n, k] = bs[_sw_offset(k // 16, n) + k % 16]
    np.testing.assert_array_equal(got, qs.T.astype(np.int32))
    # each 8-lane phase of a 16-byte store hits 8 different bank groups
    for lanes in groups.values():
        for p in range(4):
            assert len(set(lanes[8 * p:8 * p + 8])) == 8


def test_w8a8_params_check_refuses_a_weight_off_the_16_grid():
    g = torch.Generator().manual_seed(0)

    def leaf(K, N, fp8, L=2):
        q = torch.randint(-127, 128, (L, K, N), generator=g, dtype=torch.int8)
        return {"q": q.to(FP8) if fp8 else q, "s": torch.ones(L, N)}

    ok = {"layers": {"wqkv": leaf(64, 192, False), "wo": leaf(64, 64, True),
                     "norm": torch.ones(2, 64)},
          "lm_head": {"q": leaf(64, 512, True, 1)["q"][0], "s": torch.ones(512)},
          # weight-only int8 (bf16 group scales) leaves are not K8's; block
          # fp8 leaves (K9) take K8's rule
          "int8": {"q": torch.zeros(2, 72, 200, dtype=torch.int8),
                   "s": torch.ones(2, 1, 200, dtype=torch.bfloat16)},
          "block": {"q": torch.zeros(80, 208, dtype=FP8), "s": torch.ones(1, 2)},
          # the fp8 embedding table (per-row scales)
          "embed": {"q": torch.zeros(100, 64, dtype=FP8), "s": torch.ones(100)}}
    check_w8a8_params(ok)
    for bad in ({"layers": {"wo": leaf(72, 64, False)}},  # K % 16
                {"lm_head": [leaf(64, 200, True, 1)]},  # N % 16
                {"moe": {"moe_wgu": {"q": torch.zeros(2, 8, 64, 100, dtype=torch.int8),
                                     "s": torch.ones(2, 8, 100)}}},
                {"block": {"q": torch.zeros(72, 200, dtype=FP8),  # K9, both off
                           "s": torch.ones(1, 2)}},
                {"block": {"q": torch.zeros(2, 128, 200, dtype=FP8),  # K9, N % 16
                           "s": torch.ones(2, 1, 2)}}):
        with pytest.raises(ValueError, match="16"):
            check_w8a8_params(bad)


# ---------------------------------------------------------------------------
# K9, the 128x128-block fp8 GEMM (csrc/block_fp8_gemm.cu): K8's body and shape
# rule, one ring stage a scale block
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["fp8_block", "fp8_tb"])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_every_model_config_takes_the_block_fp8_kernel(name, mode):
    """Every linear of every model (the LM head where it is not tied) in
    both block formats: on the 16 grid, and planned with K8's split."""
    assert QuantSpec.from_mode(mode).block == BLOCK == W8A8_STAGE
    for K, N in linear_shapes(CONFIGS[name]):
        block_fp8_check(K, N)
        for M in (1, 17, 512):
            assert block_fp8_plan(M, K, N) == w8a8_plan(M, K, N)


@pytest.mark.parametrize("K,N", CARD_SHAPES)
def test_block_fp8_split_is_a_function_of_k_and_n_alone(K, N):
    ks, sps = stage_split(K, N, BLOCK)
    for M in ROWS:
        plan = block_fp8_plan(M, K, N)
        assert (plan.ksplit, plan.stages_per_split) == (ks, sps)
        assert plan.grid[:2] == (-(-N // 128), -(-M // (64 * plan.warpgroups)))


def test_block_fp8_check_raises_off_the_16_grid():
    block_fp8_check(16, 16)
    for K, N in ((333, 256), (336, 260), (200, 132), (4096, 4100), (0, 16), (16, 0)):
        with pytest.raises(ValueError, match="K % 16 == 0 and N % 16 == 0"):
            block_fp8_check(K, N)
        with pytest.raises(ValueError, match="block-fp8"):
            block_fp8_plan(17, K, N)


@pytest.mark.parametrize("mode", ["fp8_block", "fp8_tb"])
def test_block_fp8_params_of_a_model_pass_the_check(mode):
    spec = QuantSpec.from_mode(mode)
    params = init_params(ModelConfig.tiny(), torch.Generator().manual_seed(0), device="cpu",
                         quant=spec)
    leaves = [p for p in quant_leaves(params) if p["s"].dim() == p["q"].dim()]
    assert leaves and all(p["q"].dtype == FP8 for p in leaves)
    check_w8a8_params(params)
    for p in leaves:
        block_fp8_plan(17, *p["q"].shape[-2:])


def _fold_replay(xq, xs, q, s, ks, sps):
    """The kernel's order of operations on exact k32 sums (the tensor cores'
    own accumulation aside): each 32-deep sum folded into its split's sum
    with one fma by the stage's c = xs[m, kb] * s[kb, n / 128], the splits
    added in order. fp32 torch ops; an fma is taken in fp64 and rounded
    once."""
    M, K = xq.shape
    N = q.shape[1]
    x, w = xq.to(torch.float64), q.to(torch.float64)
    total = torch.zeros(M, N, dtype=torch.float32)
    for sp in range(ks):
        acc = torch.zeros(M, N, dtype=torch.float32)
        for kb in range(sp * sps, min((sp + 1) * sps, -(-K // BLOCK))):
            c = (xs[:, kb:kb + 1] * s[kb].repeat_interleave(BLOCK)[None, :N]).to(torch.float32)
            for k0 in range(kb * BLOCK, min((kb + 1) * BLOCK, K), 32):
                pa = (x[:, k0:k0 + 32] @ w[k0:k0 + 32]).to(torch.float32)
                acc = (pa.to(torch.float64) * c.to(torch.float64)
                       + acc.to(torch.float64)).to(torch.float32)
        total = total + acc
    return total


@pytest.mark.parametrize("M,K,N", [(3, 4096, 256), (5, 11008, 128), (2, 336, 272)])
def test_block_fp8_fold_order_holds_the_tolerance(M, K, N):
    """The scaled folds and the split order alone stay well inside the 1e-4
    (fp32) tolerance the card holds the kernel to against
    ``block_fp8_gemm_plain``; the rest of the budget is the tensor cores'
    own accumulation inside one instruction."""
    g = torch.Generator().manual_seed(0)
    xq, xs = quant_act(torch.randn(M, K, generator=g), QuantSpec.from_mode("fp8_block"))
    q = torch.randn(K, N, generator=g).to(FP8)
    s = torch.rand(-(-K // BLOCK), -(-N // BLOCK), generator=g) * 1e-4 + 2e-5
    plan = block_fp8_plan(M, K, N)
    got = _fold_replay(xq, xs, q, s, plan.ksplit, plan.stages_per_split)
    ref = block_fp8_gemm_plain(xq, xs, q, s, torch.float32)
    assert ((got - ref).abs().max() / ref.abs().max()).item() < 1e-5
