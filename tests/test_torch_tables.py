"""The port's device draft tables against the JAX package, on the CPU.

A token stream over a small alphabet, with 16 buckets, gives bucket
collisions, 2-grams with several continuations and frequency ties; the
tables after every update, the retrieved branches and the tree inputs must
be identical in both packages.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from painlessinferenceacceleration_tpu.lookahead import device_tables as jdt
from painlessinferenceacceleration_tpu_torch.lookahead import device_tables as tdt

KEYS = ("key0", "key1", "freq", "branch")


def _cfgs(**kw):
    return jdt.DraftTableConfig(**kw), tdt.DraftTableConfig(**kw)


def _same(jt, tt):
    for k in KEYS:
        assert (tt[k].numpy() == np.asarray(jt[k])).all(), k


def test_bucket_hash_matches_jax_with_pads_and_large_ids():
    p0 = np.array([-1, 0, 7, 31999, 2**31 - 1, -1, 123456], np.int32)
    p1 = np.array([-1, -1, 3, 31998, 5, 9, 2**31 - 1], np.int32)
    for buckets in (16, 16384):
        ref = np.asarray(jdt._bucket_of(jnp.asarray(p0), jnp.asarray(p1), buckets))
        got = tdt._bucket_of(torch.from_numpy(p0), torch.from_numpy(p1), buckets)
        assert (got.numpy() == ref).all()


@pytest.mark.parametrize("streaming", [False, True])
def test_update_retrieve_and_tree_match_jax(streaming):
    jc, tc = _cfgs(buckets=16, ways=4, branch_length=4, retrieve_count=2)
    rng = np.random.default_rng(0)
    stream = rng.integers(0, 6, size=120).astype(np.int32)
    jt, tt = jdt.init_draft_tables(jc), tdt.init_draft_tables(tc, "cpu")
    T = 14  # a buffer of the last T tokens per update, as the decode loop keeps
    pos = 2
    while pos < len(stream):
        n_new = int(rng.integers(1, 6))
        hi = min(pos + n_new, len(stream))
        lo_buf = max(0, hi - T)
        buf = np.full(T, -1, np.int32)
        buf[: hi - lo_buf] = stream[lo_buf:hi]
        nv = hi - lo_buf
        if streaming:
            wlo, whi = pos - lo_buf, nv
            jt = jdt.update_tables_seq(jt, jc, jnp.asarray(buf), jnp.int32(nv),
                                       win_lo=jnp.int32(wlo), win_hi=jnp.int32(whi))
            tdt.update_tables_seq(tt, tc, torch.from_numpy(buf), nv, win_lo=wlo, win_hi=whi)
        else:
            jt = jdt.update_tables_seq(jt, jc, jnp.asarray(buf), jnp.int32(nv))
            tdt.update_tables_seq(tt, tc, torch.from_numpy(buf), nv)
        _same(jt, tt)
        pos = hi
    freqs = np.asarray(jt["freq"])
    assert (freqs[freqs > 0][:, None] == freqs[freqs > 0][None]).sum() > len(freqs[freqs > 0])
    assert (np.asarray(jt["key0"]) >= 0).sum(axis=1).max() > 1  # collisions in a bucket

    p0 = np.array([a for a in range(6) for _ in range(6)], np.int32)
    p1 = np.array([b for _ in range(6) for b in range(6)], np.int32)
    tb, tf = tdt.retrieve_drafts(tt, tc, torch.from_numpy(p0), torch.from_numpy(p1))
    hits = 0
    for i in range(len(p0)):
        jb, jf = jdt.retrieve_drafts(jt, jc, jnp.int32(p0[i]), jnp.int32(p1[i]))
        assert (tb[i].numpy() == np.asarray(jb)).all()
        assert (tf[i].numpy() == np.asarray(jf)).all()
        hits += int(np.asarray(jf)[1] > 0)
        jtree = jdt.build_tree_inputs(jnp.int32(p1[i]), jb)
        ttree = tdt.build_tree_inputs(torch.tensor(int(p1[i])), tb[i])
        for j, t in zip(jtree, ttree):
            assert (t.numpy() == np.asarray(j)).all()
    assert hits > 0  # some 2-grams offer two branches


def test_batched_tree_inputs_match_per_row_jax():
    rng = np.random.default_rng(1)
    branches = rng.integers(0, 9, size=(3, 2, 5)).astype(np.int32)
    branches[1, 0, 2:] = -1  # a short branch
    branches[2, 1, :] = -1  # an empty branch
    roots = np.array([4, 5, 6], np.int32)
    got = tdt.build_tree_inputs(torch.from_numpy(roots), torch.from_numpy(branches))
    for b in range(3):
        ref = jdt.build_tree_inputs(jnp.int32(roots[b]), jnp.asarray(branches[b]))
        for j, t in zip(ref, got):
            assert (t[b].numpy() == np.asarray(j)).all()


@pytest.mark.parametrize("factor", [None, 0.25, 0.8])
def test_decay_tables_match_jax(factor):
    """``decay_tables`` (the squeeze law: freq halved, or times ``factor``)
    on tables filled by a stream gives the JAX package's tables bit for bit,
    and leaves the tables it was given as they were."""
    jc, tc = _cfgs(buckets=16, ways=4, branch_length=4, retrieve_count=2)
    stream = np.random.default_rng(1).integers(0, 6, size=60).astype(np.int32)
    jt, tt = jdt.init_draft_tables(jc), tdt.init_draft_tables(tc, "cpu")
    jt = jdt.update_tables_seq(jt, jc, jnp.asarray(stream), jnp.int32(len(stream)))
    tdt.update_tables_seq(tt, tc, torch.from_numpy(stream), len(stream))
    _same(jt, tt)
    before = tt["freq"].clone()
    kw = {} if factor is None else {"factor": factor}
    jd, td = jdt.decay_tables(jt, **kw), tdt.decay_tables(tt, **kw)
    _same(jd, td)
    assert torch.equal(tt["freq"], before) and (td["freq"] < before).any()
