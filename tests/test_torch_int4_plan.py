"""The int4 GEMM kernels' launch plan and operand arithmetic, on the CPU.

The kernels (``csrc/weight_only_wgmma.cuh``) run only on the card; what they are
given is decided here, in Python that the wrappers call: the K split (a
function of K, N and the group alone, so that a row's bits do not depend on
the batch), the grid, the grouped kernel's bounded row extent, and the
shapes that raise. The bf16 dequantization trick and the operand row at
which the kernels' ``dequant_stage`` writes every packed nibble are held
against the plain unpacking.
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from painlessinferenceacceleration_tpu_torch.layers.linear import unpack_int4
from painlessinferenceacceleration_tpu_torch.ops.moe_matmul import (
    BLOCK_M,
    grouped_int4_plan,
    grouped_row_bound,
    moe_align,
)
from painlessinferenceacceleration_tpu_torch.ops.quant_matmul import (
    INT4_GROUPS,
    check_int4_params,
    int4_check,
    int4_plan,
    int4_split,
    split_blocks,
)

# (K, N) of every weight the card paths give the int4 kernels: Llama-2-7B's
# qkv, wo, gate/up, down and LM head; Mixtral-8x7B's and Qwen3-30B-A3B's
# experts; the card tests' shapes
CARD_SHAPES = [(4096, 12288), (4096, 4096), (4096, 22016), (11008, 4096), (4096, 32000),
               (4096, 28672), (14336, 4096), (2048, 1536), (768, 2048),
               (4096, 1024), (11008, 512), (256, 384), (512, 1024), (512, 512),
               (256, 512), (768, 256), (4096, 256)]
ROWS = (1, 17, 63, 64, 65, 128, 512, 4096)


@pytest.mark.parametrize("K,N", CARD_SHAPES)
@pytest.mark.parametrize("group", INT4_GROUPS)
def test_plan_takes_every_card_shape_and_its_split_ignores_m(K, N, group):
    ks, gps = int4_split(K, N, group)
    n_groups = K // group
    assert 1 <= ks and (ks - 1) * gps < n_groups <= ks * gps  # no split is empty
    for M in ROWS:
        plan = int4_plan(M, K, N, group)
        assert (plan.ksplit, plan.stages_per_split) == (ks, gps)
        assert plan.warpgroups == (1 if M <= 64 else 2)
        tiles = -(-M // (64 * plan.warpgroups))
        assert plan.grid == (N // 128, tiles, split_blocks(ks, N // 128, tiles))
    for R, pairs in ((BLOCK_M * 10, 2), (BLOCK_M * 73, 8192)):
        gplan = grouped_int4_plan(R, K, N, group, 8, pairs)
        assert (gplan.ksplit, gplan.stages_per_split, gplan.warpgroups) == (ks, gps, 2)


@pytest.mark.parametrize("group", INT4_GROUPS)
def test_split_fills_the_card_at_the_7b_shapes(group):
    for K, N in CARD_SHAPES:
        ks, gps = int4_split(K, N, group)
        assert ks == 1 or gps * group >= 512  # a split keeps 512 rows of K at the least


def test_splits_run_in_one_block_where_the_tiles_fill_the_card():
    # Llama-2-7B qkv (4 splits): launched as blocks at decode, in one block
    # from 4 row tiles (384 blocks, 97 % of their last wave)
    assert [int4_plan(M, 4096, 12288, 128).grid[2] for M in (1, 17, 64, 65, 512, 4096)] \
        == [4, 4, 4, 4, 1, 1]
    assert split_blocks(4, 32, 4) == 1  # 128 blocks fill 97 % of one wave
    assert split_blocks(4, 32, 3) == 4  # 96 blocks: 73 %
    assert split_blocks(1, 12, 1) == 1
    # the grouped kernel decides from its bounded grid: Mixtral's down
    # projection at decode (3 row blocks) and over 8192 routed rows
    R = (1 + 8 + 1) * BLOCK_M
    assert grouped_int4_plan(R, 14336, 4096, 128, 8, 2).grid == (32, 3, 4)
    R = (64 + 8 + 1) * BLOCK_M
    assert grouped_int4_plan(R, 14336, 4096, 128, 8, 8192).grid == (32, 72, 1)


@pytest.mark.parametrize("K,N,group", [(4096, 4096, 16), (4096, 4096, 256), (4096, 4104, 128),
                                       (4000, 4096, 128), (0, 4096, 128), (4096, 0, 64),
                                       (4096, 4096, 96)])
def test_plan_raises_on_shapes_the_kernels_do_not_take(K, N, group):
    with pytest.raises(ValueError):
        int4_check(K, N, group)
    with pytest.raises(ValueError):
        int4_plan(17, K, N, group)
    with pytest.raises(ValueError):
        grouped_int4_plan(BLOCK_M * 4, K, N, group, 8, 2)


def test_plan_raises_on_empty_or_ragged_rows():
    with pytest.raises(ValueError):
        int4_plan(0, 4096, 4096, 128)
    with pytest.raises(ValueError):
        grouped_int4_plan(BLOCK_M * 4 + 1, 4096, 4096, 128, 8, 2)


def test_grouped_grid_is_bounded_at_decode():
    # Mixtral decode (T = 1, k = 2, X = 8): 3 row blocks of the 10 padded
    R = (1 + 8 + 1) * BLOCK_M
    plan = grouped_int4_plan(R, 4096, 28672, 128, 8, 2)
    assert plan.grid == (224, 3, 1)
    # Qwen3-30B-A3B decode (T = 1, k = 8, X = 128): 9 of 130
    R = (1 + 128 + 1) * BLOCK_M
    assert grouped_int4_plan(R, 2048, 1536, 128, 128, 8).grid[1] == 9
    # a prefill's bound is every block of the padded layout
    assert grouped_int4_plan(R, 2048, 1536, 128, 128, 4096).grid[1] == R // BLOCK_M
    assert grouped_row_bound(10, 8, 4096) == 10


@settings(max_examples=40, deadline=None, database=None)
@given(T=st.integers(1, 4096), k=st.integers(1, 8), X=st.integers(1, 256),
       drop=st.sampled_from([0.0, 0.2, 1.0]), seed=st.integers(0, 2**31 - 1))
def test_used_blocks_never_exceed_the_bound(T, k, X, drop, seed):
    k = min(k, X)
    rng = np.random.default_rng(seed)
    # k distinct experts a token, skewed towards the low ids, some dropped
    scores = rng.random((T, X)) ** 3 + np.arange(X)[None, :] * rng.random() * 0.01
    topi = np.argsort(scores, axis=1)[:, :k]
    topi = np.where(rng.random((T, k)) < drop, X, topi)
    topv = rng.random((T, k)).astype(np.float32)
    dest_tok, _, be, nu = moe_align(torch.from_numpy(topi.astype(np.int32)),
                                    torch.from_numpy(topv), X, T)
    NB = be.numel()
    assert NB == -(-T * k // BLOCK_M) + X + 1
    bound = grouped_row_bound(NB, X, T * k)
    assert int(nu[0]) <= bound <= NB
    # every routed row lies inside the launched blocks
    routed = (dest_tok < T).nonzero()[:, 0]
    used = routed[routed < int(nu[0]) * BLOCK_M]
    assert used.numel() == 0 or int(used.max()) < bound * BLOCK_M


def test_bf16_magic_number_is_exact_for_every_nibble():
    nib = torch.arange(16, dtype=torch.int32)
    biased = (nib | 0x4300).to(torch.int16).view(torch.bfloat16)  # 128 + nibble
    assert torch.equal(biased.float(), nib.float() + 128)
    minus = biased - torch.tensor(136, dtype=torch.bfloat16)  # bf16 arithmetic
    assert minus.dtype == torch.bfloat16
    assert torch.equal(minus.float(), nib.float() - 8)
    # both halves of a word at once, as the kernel's bf16x2 sees them
    words = (nib[:, None] | (nib[None, :] << 16)).reshape(-1)
    halves = ((words & 0x000F000F) | 0x43004300).view(torch.int16).view(torch.bfloat16)
    got = (halves - torch.tensor(136, dtype=torch.bfloat16)).float().reshape(16, 16, 2)
    assert torch.equal(got[..., 0], (nib[:, None] - 8).float().expand(16, 16))
    assert torch.equal(got[..., 1], (nib[None, :] - 8).float().expand(16, 16))


def _operand_row(group: int, j: int, hi: bool) -> int:
    """The k row of its group at which ``dequant_stage`` (csrc/weight_only_wgmma.cuh)
    writes packed byte j's low (or high) nibble: warp (v, p) takes bytes
    j = 16 v + 2 e + p and stores them to chunk u = v + (p + 2 hi) g / 32 of
    the operand, element e, so k = 8 u + e."""
    v, p, e = j // 16, j % 2, (j % 16) // 2
    return 8 * (v + (p + 2 * int(hi)) * (group // 32)) + e


@pytest.mark.parametrize("group", INT4_GROUPS)
def test_operand_rows_place_every_nibble_where_unpack_does(group):
    g = torch.Generator().manual_seed(group)
    N = 16
    packed = torch.randint(0, 256, (group // 2, N), generator=g, dtype=torch.int32)
    w = unpack_int4(packed.to(torch.uint8), group)  # [group, N] signed
    rows = set()
    for j in range(group // 2):
        for hi in (False, True):
            k = _operand_row(group, j, hi)
            rows.add(k)
            nib = (packed[j] >> 4) & 0xF if hi else packed[j] & 0xF
            assert torch.equal(w[k].to(torch.int32), nib - 8), (j, hi)
    assert rows == set(range(group))  # a permutation of the group's rows
    # a warp's 8 packed rows of one band and parity fill one 16-byte chunk:
    # 8 consecutive k from a multiple of 8
    for j0 in range(0, group // 2, 16):
        for p in (0, 1):
            for hi in (False, True):
                ks = [_operand_row(group, j0 + 2 * e + p, hi) for e in range(8)]
                assert ks == list(range(ks[0], ks[0] + 8)) and ks[0] % 8 == 0


def test_int4_params_check_refuses_a_group_the_kernels_do_not_take():
    g = torch.Generator().manual_seed(0)
    q = torch.randint(0, 256, (2, 64, 256), generator=g).to(torch.uint8)  # [L, K/2, N]
    ok = {"layers": {"wqkv": {"q": q, "s": torch.ones(2, 4, 256, dtype=torch.bfloat16)},
                     "norm": torch.ones(2, 128)},
          "lm_head": [{"q": q[0], "s": torch.ones(1, 256, dtype=torch.bfloat16)}]}
    check_int4_params(ok)  # groups of 32 and 128
    bad = {"layers": {"wqkv": {"q": q, "s": torch.ones(2, 8, 256, dtype=torch.bfloat16)}}}
    with pytest.raises(ValueError, match="groups"):
        check_int4_params(bad)  # a group of 16
