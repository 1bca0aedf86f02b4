"""The MLA attention kernel's launch plan, geometry rule and order of
operations, on the CPU.

The kernel (``csrc/mla_attention.cu``, K13) runs only on the card; what it
is given is decided in Python that the wrapper calls (``mla_check``,
``mla_plan``, ``tile_last_key``, ``tile_chunks``): tiles of 64 query rows,
each request's keys cut into chunks at absolute positions, the grid of each
route, and the workspace, all from shapes the host knows (the window of the
page table, never ``ctx``). ``replay`` repeats the body's order of
operations in numpy float32: key blocks of one page from key 0, the online
softmax a block at a time inside a chunk, each chunk's partial (m, l, O)
from (-1e30, 0, 0), and the fold of the partials in ascending chunk order
with the kernel's formulas (``fold``, ``final``), through the split route
(one partial a chunk, then the combine) or the walk (one block folds at
each chunk edge). It is held against the JAX package's
``paged_attention_ref`` in float32 (1e-5 of the largest value: sums in
other orders and exp2 for exp), and it shows the two facts the kernel's
bit-equality rests on: the fold of one chunk is that chunk's partial bit
for bit, and a chunk with no visible key leaves the state bit for bit; so a
row is the same at every Q, B and H and in either route.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from painlessinferenceacceleration_tpu.ops import attention as jatt
from painlessinferenceacceleration_tpu_torch.config import EngineConfig, ModelConfig
from painlessinferenceacceleration_tpu_torch.ops.mla_attention import (
    CHUNK_KEYS,
    K_DIM,
    KEY_BLOCK,
    LOG2E,
    TILE_ROWS,
    V_DIM,
    mla_check,
    mla_plan,
    tile_chunks,
    tile_last_key,
    tile_of,
)

NEG = np.float32(-1e30)  # the kernel's masked score and empty max
jax_ref = jax.jit(jatt.paged_attention_ref, static_argnums=(6,),
                  static_argnames=("v_dim",))


def _f32(x):
    return np.asarray(x, dtype=np.float32)


def _fma(a, b, c):
    """a * b + c rounded once to float32 (the product of two float32 values
    is exact in float64)."""
    return _f32(np.float64(a) * np.float64(b) + np.float64(c))


# ---------------------------------------------------------------------------
# the fold and the final division (csrc/mla_attention.cu fold_coeffs,
# fold_val, final_inv, final_val)
# ---------------------------------------------------------------------------


def fold(state, part, sfac):
    """(M, L, A) with a chunk's partial (m, l, O): M' = max(M, m), scaled by
    2^((M - M') f) and 2^((m - M') f). M, L, m, l [rows]; A, O [rows, Dv]."""
    M, L, A = state
    m, l, O = part
    Mn = np.maximum(M, m)
    a = np.exp2(_f32(_f32(M - Mn) * sfac))
    b = np.exp2(_f32(_f32(m - Mn) * sfac))
    return Mn, _fma(l, b, _f32(L * a)), _fma(O, b[:, None], _f32(A * a[:, None]))


def final(A, L):
    inv = _f32(np.float32(1) / np.where(L > 0, L, np.float32(1)))
    return _f32(A * inv[:, None])


def init_state(rows, dv):
    return (np.full(rows, NEG, np.float32), np.zeros(rows, np.float32),
            np.zeros((rows, dv), np.float32))


# ---------------------------------------------------------------------------
# the body's order of operations
# ---------------------------------------------------------------------------


def _visible(rule, j, t, ctx, Q, qmask_b):
    """[rows, keys] visibility of absolute keys j to rows at positions t
    (-1 for padding), as the kernel's softmax decides it."""
    jj, tt = j[None, :], t[:, None]
    if rule == "causal":
        return (tt >= 0) & (jj <= ctx + tt)
    s = jj - ctx
    in_step = (s >= 0) & (s < Q)
    if Q == 1:
        step_ok = in_step
    else:
        step_ok = in_step & qmask_b[np.clip(tt, 0, Q - 1), np.clip(s, 0, Q - 1)]
    return (tt >= 0) & ((jj < ctx) | step_ok)


def chunk_partial(qrows, t, kp, pt_b, ctx, Q, qmask_b, rule, c, n_blocks, chunk, sfac,
                  dv):
    """A chunk's (m, l, O): the online softmax over its key blocks from
    (-1e30, 0, 0), O rescaled then the block's P V added."""
    rows = qrows.shape[0]
    m, l, O = init_state(rows, dv)
    cb = chunk // KEY_BLOCK
    for kb in range(c * cb, min((c + 1) * cb, n_blocks)):
        K = kp[pt_b[kb]]  # [64, Dk]
        j = kb * KEY_BLOCK + np.arange(KEY_BLOCK)
        s = _f32((qrows[:, None, :] * K[None, :, :]).sum(-1))
        s = np.where(_visible(rule, j, t, ctx, Q, qmask_b), s, NEG)
        m_new = np.maximum(m, s.max(-1))
        alpha = np.exp2(_f32(_f32(m - m_new) * sfac))
        mk = _f32(-m_new * sfac)
        with np.errstate(over="ignore"):  # masked scores: selected away, as in the kernel
            p = np.where(s == NEG, np.float32(0), np.exp2(_fma(s, sfac, mk[:, None])))
        l = _fma(l, alpha, _f32(p.sum(-1)))
        m = m_new
        O = _f32(_f32(O * alpha[:, None]) + _f32((p[:, :, None] * K[None, :, :dv]).sum(1)))
    return m, l, O


def replay(q, kp, pt, ctx, qmask, scale, causal, route, chunk=CHUNK_KEYS, dv=V_DIM):
    """The kernel's result for q [B, Q, H, Dk] over pages kp [n, 64, Dk]:
    per (request, tile) the chunks' partials, then the output written by
    the chunk's block (one chunk), the combine's fold ('split') or the
    block's fold at each chunk edge ('walk'). Returns [B, Q, H, dv]."""
    B, Q, H, Dk = q.shape
    P = pt.shape[1]
    plan = mla_plan(B, Q, H, P, causal, chunk, walk=route == "walk")
    sfac = np.float32(scale * LOG2E)
    rule = "causal" if causal else "mask"
    out = np.zeros((B, Q * H, dv), np.float32)
    for b in range(B):
        qb = q[b].reshape(Q * H, Dk)
        for z in range(plan.n_tiles):
            tile = tile_of(z, plan.n_tiles, causal)
            r0 = tile * TILE_ROWS
            r = np.arange(r0, r0 + TILE_ROWS)
            t = np.where(r < Q * H, r // H, -1)
            qrows = np.zeros((TILE_ROWS, Dk), np.float32)
            qrows[: min(TILE_ROWS, Q * H - r0)] = qb[r0:r0 + TILE_ROWS]
            last = tile_last_key(int(ctx[b]), Q, H, tile, P, causal)
            nct = tile_chunks(int(ctx[b]), Q, H, tile, P, causal, chunk)
            parts = [chunk_partial(qrows, t, kp, pt[b], int(ctx[b]), Q,
                                   None if qmask is None else qmask[b], rule, c,
                                   last // KEY_BLOCK + 1, chunk, sfac, dv)
                     for c in range(nct)]
            if nct == 1:
                res = final(parts[0][2], parts[0][1])
            else:  # the combine's fold and the walk's are the same steps
                state = init_state(TILE_ROWS, dv)
                for part in parts:
                    state = fold(state, part, sfac)
                res = final(state[2], state[1])
            n = min(TILE_ROWS, Q * H - r0)
            out[b, r0:r0 + n] = res[:n]
    return out.reshape(B, Q, H, dv)


def _inputs(seed, B, Q, H, ctx, dk=80, n_extra=2):
    rng = np.random.default_rng(seed)
    P = -(-(max(ctx) + Q) // KEY_BLOCK) + n_extra
    n = B * P + 1
    kp = _f32(rng.standard_normal((n, KEY_BLOCK, dk)))
    pt = (rng.permutation(n - 1)[: B * P] + 1).reshape(B, P).astype(np.int32)
    q = _f32(rng.standard_normal((B, Q, H, dk)))
    return q, kp, pt, np.array(ctx, np.int32)


def _jax_ref(q, kp, pt, ctx, qmask, scale, dv):
    with jax.default_matmul_precision("highest"):
        return np.asarray(jax_ref(jnp.asarray(q), jnp.asarray(kp), jnp.asarray(kp[..., :dv]),
                                  jnp.asarray(pt), jnp.asarray(ctx), jnp.asarray(qmask),
                                  scale, v_dim=dv))


def _causal(B, Q):
    return np.broadcast_to(np.tril(np.ones((Q, Q), bool)), (B, Q, Q)).copy()


# ---------------------------------------------------------------------------
# the launch plan, from host-known shapes
# ---------------------------------------------------------------------------

PLANS = [  # B, Q, H, P (pages in the window), causal
    (1, 1, 16, 12, False), (1, 1, 16, 72, False), (1, 1, 128, 72, False),
    (4, 1, 16, 66, False), (1, 17, 16, 66, False), (1, 17, 128, 66, False),
    (8, 17, 16, 9, False), (1, 512, 16, 9, True), (1, 512, 16, 17, True),
    (1, 4096, 16, 72, True), (2, 300, 16, 14, True), (1, 1, 16, 8, False),
]


@pytest.mark.parametrize("B,Q,H,P,causal", PLANS)
def test_plan_grid_chunks_and_workspace(B, Q, H, P, causal):
    plan = mla_plan(B, Q, H, P, causal)
    n_tiles = -(-Q * H // TILE_ROWS)
    n_chunks = -(-P * KEY_BLOCK // CHUNK_KEYS)
    assert (plan.n_tiles, plan.n_chunks, plan.walk) == (n_tiles, n_chunks, causal)
    if causal:  # prefill: one block a tile walks every chunk
        assert plan.grid == (1, B, n_tiles) and plan.combine_grid is None
        assert plan.workspace_floats == 0
        assert plan.scratch_floats == (B * n_tiles * TILE_ROWS * V_DIM if n_chunks > 1
                                       else 0)
    else:  # decode / verify: one block a chunk, the combine over the partials
        assert plan.grid == (n_chunks, B, n_tiles) and plan.scratch_floats == 0
        if n_chunks > 1:
            assert plan.combine_grid == (Q * H, B)
            assert plan.workspace_floats == B * n_tiles * n_chunks * TILE_ROWS * (V_DIM + 2)
        else:
            assert plan.combine_grid is None and plan.workspace_floats == 0


def test_plan_workspace_bytes_at_the_main_path():
    """DeepSeek-V2-Lite's main path: a 4096-token prefill, decode and a
    17-wide verify over a window of 4608 keys (72 pages)."""
    assert mla_plan(1, 4096, 16, 72, True).scratch_floats * 4 == 1024 * 64 * 512 * 4
    assert mla_plan(1, 1, 16, 72, False).workspace_floats * 4 == 9 * 64 * 514 * 4
    assert mla_plan(1, 17, 16, 72, False).workspace_floats * 4 == 5 * 9 * 64 * 514 * 4


def test_plan_refuses_what_the_grid_cannot_hold():
    with pytest.raises(ValueError):
        mla_plan(65536, 1, 16, 8, False)
    with pytest.raises(ValueError):
        mla_plan(1, 70000, 64, 8, True)  # 70000 tiles
    with pytest.raises(ValueError):
        mla_plan(1, 1, 16, 8, False, chunk=100)
    with pytest.raises(ValueError):
        mla_plan(0, 1, 16, 8, False)


@pytest.mark.parametrize("chunk", [256, 512, 1024])
def test_chunks_are_absolute_and_end_at_the_tiles_last_key(chunk):
    P = 80
    for ctx in (0, chunk - 2, chunk - 1, chunk, chunk + 1, 2 * chunk - 1, 2 * chunk, 4000):
        # decode: the row sees keys 0..ctx
        assert tile_last_key(ctx, 1, 16, 0, P, False) == ctx
        assert tile_chunks(ctx, 1, 16, 0, P, False, chunk) == ctx // chunk + 1
        # a 17-wide verify sees up to ctx + 16 in every tile
        for tile in range(-(-17 * 16 // TILE_ROWS)):
            assert tile_last_key(ctx, 17, 16, tile, P, False) == ctx + 16
        # causal: tile z holds positions 4z..4z+3 at 16 heads
        for tile in (0, 1, 7):
            assert tile_last_key(ctx, 512, 16, tile, P, True) == ctx + 4 * tile + 3
    # the window bounds it
    assert tile_last_key(10 ** 6, 1, 16, 0, P, False) == P * KEY_BLOCK - 1
    # the last tile of a ragged Q H: its last real row
    assert tile_last_key(0, 5, 16, 1, P, True) == 4
    assert [tile_of(z, 4, True) for z in range(4)] == [3, 2, 1, 0]
    assert [tile_of(z, 4, False) for z in range(4)] == [0, 1, 2, 3]


# ---------------------------------------------------------------------------
# the geometry the card takes
# ---------------------------------------------------------------------------


def _deepseek_v3_shape():
    """DeepSeek-V3's attention widths (128 heads over the same latent row),
    which chip_smoke.py runs kernel-only."""
    return dict(H=128, Dk=512 + 64, Dv=512)


@pytest.mark.parametrize("name", ["deepseek_v2_lite", "mla_3b"])
def test_every_mla_config_passes_mla_check(name):
    cfg = getattr(ModelConfig, name)()
    assert cfg.is_mla and cfg.mla_latent_cache
    ps = EngineConfig().page_size
    mla_check(cfg.num_attention_heads, cfg.kv_lora_rank + cfg.qk_rope_head_dim,
              cfg.kv_lora_rank, ps)


def test_deepseek_v3_shape_passes_mla_check():
    s = _deepseek_v3_shape()
    mla_check(s["H"], s["Dk"], s["Dv"], KEY_BLOCK)


@pytest.mark.parametrize("H,Dk,Dv,ps", [(16, 576, 512, 16), (16, 576, 512, 128),
                                        (4, 40, 32, 64), (16, 576, 256, 64),
                                        (16, 640, 512, 64), (0, 576, 512, 64)])
def test_mla_check_refuses_other_geometries(H, Dk, Dv, ps):
    with pytest.raises(ValueError):
        mla_check(H, Dk, Dv, ps)


def test_the_kernels_geometry_constants():
    assert (K_DIM, V_DIM, KEY_BLOCK, TILE_ROWS) == (576, 512, 64, 64)
    assert CHUNK_KEYS % KEY_BLOCK == 0
    src = (__import__("pathlib").Path(__file__).resolve().parent.parent /
           "painlessinferenceacceleration_tpu_torch" / "csrc" / "mla_attention.cu").read_text()
    for const in (f"kRows = {TILE_ROWS};", f"kKeys = {KEY_BLOCK};", f"kDk = {K_DIM};",
                  f"kDv = {V_DIM};"):
        assert const in src


# ---------------------------------------------------------------------------
# the fold: identity, empty chunks
# ---------------------------------------------------------------------------


def test_the_fold_of_one_chunk_is_its_partial_bit_for_bit():
    rng = np.random.default_rng(0)
    rows, dv, sfac = 64, 32, np.float32(0.06 * LOG2E)
    for _ in range(20):
        m = _f32(rng.standard_normal(rows) * 30)
        m[::7] = NEG  # rows that saw no key in the chunk
        l = _f32(rng.uniform(0.5, 60, rows))
        l[::7] = 0
        O = _f32(rng.standard_normal((rows, dv)) * 5)
        O[::7] = 0
        M, L, A = fold(init_state(rows, dv), (m, l, O), sfac)
        assert np.array_equal(M, m) and np.array_equal(L, l) and np.array_equal(A, O)
        assert np.array_equal(final(A, L), final(O, l))


def test_an_empty_chunk_leaves_the_state_bit_for_bit():
    rng = np.random.default_rng(1)
    rows, dv, sfac = 64, 32, np.float32(0.05 * LOG2E)
    empty = init_state(rows, dv)
    for _ in range(20):
        M = _f32(rng.standard_normal(rows) * 30)
        M[::5] = NEG
        L = _f32(rng.uniform(0.5, 60, rows))
        L[::5] = 0
        A = _f32(rng.standard_normal((rows, dv)) * 5)
        A[::5] = 0
        got = fold((M, L, A), empty, sfac)
        for x, y in zip(got, (M, L, A)):
            assert np.array_equal(x, y)


def test_a_masked_key_block_leaves_the_chunks_state():
    """A chunk whose last key blocks are past a row's last key gives that
    row the same partial as the chunk cut at its last key."""
    q, kp, pt, ctx = _inputs(2, 1, 1, 16, [70])
    sfac = np.float32(0.1 * LOG2E)
    t = np.zeros(TILE_ROWS, np.int64)
    t[16:] = -1
    qrows = np.zeros((TILE_ROWS, q.shape[-1]), np.float32)
    qrows[:16] = q[0, 0]
    short = chunk_partial(qrows, t, kp, pt[0], 70, 1, None, "mask", 0, 2, 512, sfac, 64)
    long_ = chunk_partial(qrows, t, kp, pt[0], 70, 1, None, "mask", 0, 4, 512, sfac, 64)
    for x, y in zip(short, long_):
        assert np.array_equal(x, y)


# ---------------------------------------------------------------------------
# the replay against the JAX reference, and a row's bits across routes
# ---------------------------------------------------------------------------

REF_CASES = {  # B, Q, H, ctx, kind, chunk
    "decode_edges": (4, 1, 4, [127, 128, 129, 300], "decode", 128),
    "verify_tree": (2, 7, 4, [120, 250], "verify", 128),
    "prefill_resumed_across_an_edge": (2, 40, 4, [100, 0], "prefill", 128),
    "prefill_chunk_512": (1, 160, 2, [400], "prefill", 512),
    "decode_chunk_512": (2, 1, 16, [511, 1100], "decode", 512),
}


@pytest.mark.parametrize("case", REF_CASES)
def test_replay_matches_the_jax_reference(case):
    B, Q, H, ctx, kind, chunk = REF_CASES[case]
    q, kp, pt, ctx_a = _inputs(3, B, Q, H, ctx)
    rng = np.random.default_rng(4)
    if kind == "verify":
        qmask = np.tril(rng.random((B, Q, Q)) < 0.6) | np.eye(Q, dtype=bool)[None]
    else:
        qmask = _causal(B, Q)
    scale, dv = 0.09, 64
    ref = _jax_ref(q, kp, pt, ctx_a, qmask, scale, dv)
    for route in ("split", "walk"):
        got = replay(q, kp, pt, ctx_a, None if kind == "prefill" else qmask, scale,
                     kind == "prefill", route, chunk, dv)
        err = np.abs(got - ref).max() / np.abs(ref).max()
        assert err < 1e-5, (route, err)


def test_a_rows_bits_do_not_depend_on_q_b_or_the_route():
    """Decode rows (Q = 1, the split route) equal the same tokens' rows in a
    causal prefill (the walk), in a 17-wide verify under the causal mask
    (split), in a batch of three requests, and in the prefill sent through
    the partials (split): bit for bit, at positions on both sides of chunk
    edges."""
    chunk, H, dv, scale = 128, 4, 64, 0.08
    Qp = 300
    q, kp, pt, _ = _inputs(5, 1, Qp, H, [0])
    ctx0 = np.array([0], np.int32)
    pre_walk = replay(q, kp, pt, ctx0, None, scale, True, "walk", chunk, dv)
    pre_split = replay(q, kp, pt, ctx0, None, scale, True, "split", chunk, dv)
    assert np.array_equal(pre_walk, pre_split)
    one = np.ones((1, 1, 1), bool)
    for t in (0, 63, 127, 128, 129, 255, 256, 299):
        row = replay(q[:, t:t + 1], kp, pt, np.array([t], np.int32), one, scale, False,
                     "split", chunk, dv)
        assert np.array_equal(row[0, 0], pre_walk[0, t]), t
    # 17-wide verify windows ending on either side of a chunk edge, under
    # the causal mask
    for ctx_v in (2 * chunk - 17, 2 * chunk - 16):
        wide = replay(q[:, ctx_v:ctx_v + 17], kp, pt, np.array([ctx_v], np.int32),
                      _causal(1, 17), scale, False, "split", chunk, dv)
        assert np.array_equal(wide[0], pre_walk[0, ctx_v:ctx_v + 17])
    # three requests over one arena, the first one this request at t = 200
    q3 = _f32(np.random.default_rng(6).standard_normal((3, 1, H, q.shape[-1])))
    q3[0, 0] = q[0, 200]
    batch = replay(q3, kp, np.repeat(pt, 3, 0), np.array([200, 150, 5], np.int32),
                   np.ones((3, 1, 1), bool), scale, False, "split", chunk, dv)
    assert np.array_equal(batch[0, 0], pre_walk[0, 200])
