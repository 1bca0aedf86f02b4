"""The port's ``DistLLM`` over 4 ranks against the JAX single-device
``LLM``, on the CPU: tensor parallelism over (1, 4), tensor and data
parallelism over (2, 2), context parallelism over 4 ranks whose pages
the requests straddle, and context parallelism beside a data axis over
(2, 2) (each data group the whole arena over its 2 model ranks' pages).
One group of 4 gloo processes (``tests/torch_dist_worker.py``) runs the
four cases while the JAX reference is computed; each rank's greedy and
lookahead tokens must equal the JAX tokens, and its first-step logits be
within 1e-4 of the JAX prefill's (``tests/_parallel_cases.py``); under
context parallelism each rank's pages equal, bit for bit, those of a
one-process engine whose attention is the oracle of its model axis."""

import pytest

import _parallel_cases as pc
from _torch_dist import Ranks


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    (tp, jp), look = pc.port_params("dense"), pc.LOOK
    ranks = Ranks(4, [
        pc.case("tp4_la", "dense", tp, (1, 4), 4, look, logits=True),
        pc.case("tpdp_la", "dense", tp, (2, 2), 4, look, logits=True),
        pc.case("cp4", "dense", tp, (1, 4), 4,
                dict(look, context_parallel=True, num_pages=16, page_size=8),
                logits=True, cp_oracle=True),
        pc.case("cp_dp", "dense", tp, (2, 2), 4,
                dict(look, context_parallel=True, num_pages=16, page_size=8),
                logits=True, cp_oracle=True),
    ], str(tmp_path_factory.mktemp("dist4")))
    ref = pc.jax_reference("dense", jp)
    return ranks.results(), ref


@pytest.mark.parametrize("name", ["tp4_la", "tpdp_la", "cp4", "cp_dp"])
def test_four_ranks_match_jax(served, name):
    res, ref = served
    pc.check_case(res, name, *ref)
    assert res[0][name]["spec_steps"] > 0
    if name == "cp4":  # 4 pages a rank behind its null page, the oracle's arena
        assert res[0][name]["kv_pages"] == 16 // 4 + 1
        assert min(res[0][name]["pages_on_ranks"]) > 0
        for r in res:
            assert r[name]["cp_oracle_tokens_equal"] and r[name]["cp_arena_equal"]
    if name == "cp_dp":
        # 8 pages a rank; each data group's two ranks hold the whole arena, the
        # same bits in both groups (the other group's rows replayed onto a
        # rank's own pages). A group's forward runs its own rows, so the CPU's
        # fp32 GEMMs (whose row bits depend on the row count) put its K / V
        # rows within 1e-5 of the one-process oracle's, not bit for bit (the
        # card's kernels are row-invariant: chip_smoke.py holds them equal)
        assert res[0][name]["kv_pages"] == 16 // 2 + 1
        assert min(res[0][name]["pages_on_ranks"]) > 0
        assert len({r[name]["cp_arena_digest"] for r in res}) == 1
        for r in res:
            assert r[name]["cp_oracle_tokens_equal"] and r[name]["cp_arena_max_err"] < 1e-5
