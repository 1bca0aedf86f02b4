"""The paged attention kernel's launch plan, shape rule, operand layout and
order of operations, on the CPU.

The kernel (``csrc/paged_attention.cu``) runs only on the card; what it is
given is decided in Python that the wrappers call (``attention_check``,
``attention_plan``, ``tile_of``, ``key_blocks``): the tiles of 128 query
rows, the grid, the heaviest-first order of causal tiles, the key blocks
each tile walks, and the geometries that raise. The operand layout is the
hardware's: TMA lands K and V in the 128-byte swizzle (or the converter
warps write widened e4m3 rows there), wgmma reads Q and K K-major and V
MN-major through descriptors, and P goes from the score accumulator to the
A fragments in registers; all of it is replayed in numpy. ``emulate``
repeats the body's order of operations in torch (key blocks of 64 at
absolute positions, the online softmax a block at a time, P rounded to
bf16, the per-token scales where the kernel applies them; heads of 80 or
96 lanes read as the 128-lane build reads them, Q zero past the head); it
is held against the JAX package's ``paged_attention_ref`` and its Pallas
kernels in interpret mode (rel 2e-2: P and the output rounded to bf16;
3e-2 against the e4m3 Pallas kernels, which compute in bf16 throughout;
a tree verify past 128 rows, which the JAX package leaves to XLA, against
``paged_attention_ref`` alone), at G = 1 to 7 query heads a kv head (5, 6
and 7 do not divide 128: a tile's last rows are padding), and a row's bits
are shown not to depend on the width, the route or its place in the tile.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from painlessinferenceacceleration_tpu.ops import attention as jatt
from painlessinferenceacceleration_tpu.ops.paged_attention import (
    paged_attention as j_paged_attention,
    paged_attention_prefill as j_paged_attention_prefill,
    paged_attention_tok as j_paged_attention_tok,
)
from painlessinferenceacceleration_tpu_torch.config import EngineConfig, ModelConfig
from painlessinferenceacceleration_tpu_torch.ops.attention import NEG_INF, causal_qmask
from painlessinferenceacceleration_tpu_torch.ops.paged_attention import (
    KEY_BLOCK,
    TILE_ROWS,
    attention_check,
    attention_plan,
    key_blocks,
    tile_of,
)
from test_torch_bf16_plan import _kmajor_read, _mnmajor_read, _tma_land
from test_torch_w8a8_plan import CONFIGS

LOG2E = np.float32(1.4426950408889634)
# the JAX reference under one jit a shape (op by op it compiles every op)
jax_ref = jax.jit(jatt.paged_attention_ref, static_argnums=(6,))
GS = (1, 2, 4, 5, 6, 7, 8, 16, 32, 64, 128)


def _tiles(Q, G, positions):
    """(t0, nt) of each tile, and its rows (head in the group, position)."""
    out = []
    for tile in range(-(-Q // positions)):
        t0 = tile * positions
        nt = min(positions, Q - t0)
        out.append((t0, nt, [(r // nt, t0 + r % nt) for r in range(G * nt)]))
    return out


# ---------------------------------------------------------------------------
# the launch plan
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("G", GS)
def test_tiles_hold_whole_heads_and_every_row_once(G):
    Hkv = 2
    for Q in (1, 17, 63, 64, 65, 128, 129, 300, 512, 2048):
        plan = attention_plan(3, Q, G * Hkv, Hkv)
        assert plan.positions == TILE_ROWS // G
        assert plan.n_tiles == -(-Q // plan.positions)
        assert plan.grid == (Hkv, 3, plan.n_tiles)
        seen = []
        for t0, nt, rows in _tiles(Q, G, plan.positions):
            assert 1 <= len(rows) <= G * plan.positions <= TILE_ROWS
            seen += rows
        assert sorted(seen) == [(g, t) for g in range(G) for t in range(Q)]
        if Q * G <= TILE_ROWS:  # decode and verify: one tile a kv head
            assert plan.n_tiles == 1


def _visible(ctx, Q, t, causal, qmask):
    """Keys query position t sees (ops/attention.py's rule)."""
    keys = list(range(ctx))
    for s in range(Q):
        if (s <= t) if causal else qmask[t, s]:
            keys.append(ctx + s)
    return keys


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("G", [1, 4, 8])
def test_key_blocks_cover_what_the_rows_see(causal, G):
    rng = np.random.default_rng(G)
    positions = TILE_ROWS // G
    for ctx in (0, 1, 63, 64, 70, 333):
        for Q in ((17, 64, 129, 300) if causal else (1, 16, 17, 64)):
            qmask = rng.random((Q, Q)) < 0.5
            P = -(-(ctx + Q) // KEY_BLOCK) + 1
            for t0, nt, rows in _tiles(Q, G, positions):
                nb = key_blocks(ctx, Q, t0, nt, causal, P)
                last = max(max(_visible(ctx, Q, t, causal, qmask), default=0)
                           for _, t in rows)
                assert last < nb * KEY_BLOCK  # every visible key is walked
                if causal:  # and no block past the tile's last visible key
                    assert nb == last // KEY_BLOCK + 1
                else:  # the mask rule walks to the step's last key
                    assert nb == (ctx + Q - 1) // KEY_BLOCK + 1
    assert key_blocks(700, 17, 0, 17, False, 5) == 5  # bounded by the page table


def test_causal_tiles_launch_heaviest_first():
    for Q, G in ((512, 1), (2048, 4), (4096, 4), (129, 1)):
        n = attention_plan(1, Q, 8 * G, 8).n_tiles
        positions = TILE_ROWS // G
        order = [tile_of(z, n, True) for z in range(n)]
        assert sorted(order) == list(range(n))
        walks = [key_blocks(0, Q, t * positions, min(positions, Q - t * positions), True, 99)
                 for t in order]
        assert walks == sorted(walks, reverse=True) and walks[0] > walks[-1]
        assert [tile_of(z, n, False) for z in range(n)] == list(range(n))


# ---------------------------------------------------------------------------
# the shape rule
# ---------------------------------------------------------------------------

# the configs whose attention runs through the paged attention kernel (MLA
# models run K13; the tiny preset is the CPU tests' model, head dim 16)
ATTENTION_CONFIGS = sorted(n for n, c in CONFIGS.items() if not c.is_mla and n != "tiny")


@pytest.mark.parametrize("name", ATTENTION_CONFIGS)
def test_every_model_config_takes_the_kernel(name):
    cfg = CONFIGS[name]
    ps = EngineConfig().page_size
    attention_check(cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim, ps)
    attention_plan(8, 4096, cfg.num_attention_heads, cfg.num_key_value_heads)
    # the GPU tests' small models: head dim 64, two query heads a kv head
    attention_check(4, 2, 64, ps)


# geometries of published sizes whose G does not divide 128 or whose head is
# not whole 64-lane boxes: G = 3 (a 12 / 4 test shape), Qwen2.5-14B /
# Qwen3-14B's 40 / 8 (G = 5), Qwen2.5-1.5B's 12 / 2 (G = 6), Qwen2.5-7B's 28 / 4
# and Qwen2-0.5B's 14 / 2 (G = 7), OPT-2.7B's and BLOOM-3b's 32 heads of 80
# lanes, BLOOM-1b1's 16 of 96; and G = 128, the largest
ACCEPTED = ((12, 4, 128), (40, 8, 128), (12, 2, 128), (28, 4, 128), (14, 2, 64),
            (32, 32, 80), (16, 16, 96), (128, 1, 128))


@pytest.mark.parametrize("Hq,Hkv,D", ACCEPTED)
def test_geometries_the_kernel_takes(Hq, Hkv, D):
    attention_check(Hq, Hkv, D, 64)
    G = Hq // Hkv
    plan = attention_plan(2, 129, Hq, Hkv)
    assert plan.positions == TILE_ROWS // G
    assert 0 <= TILE_ROWS - G * plan.positions < G  # the tile's padding rows


def test_geometries_the_kernel_does_not_take_raise():
    for D in (16, 32, 48, 112, 512):
        with pytest.raises(ValueError, match="head dims"):
            attention_check(8, 8, D, 64)
    for D, Dv in ((80, 128), (96, 80), (128, 96)):  # 80 / 96 only as (D, D) pairs
        with pytest.raises(ValueError, match="head dims"):
            attention_check(16, 16, D, 64, Dv)
    for D, Dv in ((192, 192), (128, 192), (256, 128), (64, 128)):
        with pytest.raises(ValueError, match="head dims"):
            attention_check(16, 16, D, 64, Dv)
    # GPT-J's 256 and DeepSeek's expanded MLA (K 192 lanes, V 128) are built
    attention_check(16, 16, 256, 64)
    attention_check(16, 16, 192, 64, 128)
    t = ModelConfig.tiny()
    with pytest.raises(ValueError, match="head dims"):  # the CPU preset
        attention_check(t.num_attention_heads, t.num_key_value_heads, t.head_dim, 64)
    for ps in (16, 32, 128):
        with pytest.raises(ValueError, match="pages of 64"):
            attention_check(8, 8, 128, ps)
    for Hq, Hkv in ((256, 1), (129, 1), (9, 2), (8, 0)):  # G past 128; Hq % Hkv; no kv head
        with pytest.raises(ValueError, match="query heads a kv head"):
            attention_check(Hq, Hkv, 128, 64)
    with pytest.raises(ValueError):
        attention_plan(65536, 1, 8, 8)
    with pytest.raises(ValueError):
        attention_plan(1, 0, 8, 8)


# ---------------------------------------------------------------------------
# the operand layout: TMA's 128-byte swizzle, the widening pass, the
# descriptors and the P fragments
# ---------------------------------------------------------------------------


def _land_stage(x: np.ndarray) -> np.ndarray:
    """A page's K (or V) rows [64 keys][D] as TMA lands them: 64-column
    boxes of 64 keys, 8192 bytes apart (2-byte elements), padded to two
    boxes for D = 64."""
    boxes = [_tma_land(x[:, c:c + 64]) for c in range(0, x.shape[1], 64)]
    if len(boxes) == 1:
        boxes.append(np.full_like(boxes[0], -1))
    return np.concatenate(boxes)


@pytest.mark.parametrize("D", [64, 128])
def test_k_stage_reads_as_the_keys_and_v_stage_as_the_values(D):
    """S's B operand: k16 step t reads K[:, 16 t : 16 t + 16] (K-major,
    descriptor at chunk t / 4, 32 bytes a step); P V's B operand: k16 step t
    reads V[16 t : 16 t + 16, :] (MN-major, transposed bit, 16 keys a
    step)."""
    rng = np.random.default_rng(D)
    k = rng.integers(0, 1 << 16, size=(KEY_BLOCK, D))
    v = rng.integers(0, 1 << 16, size=(KEY_BLOCK, D))
    ks, vs = _land_stage(k), _land_stage(v)
    for t in range(D // 16):
        np.testing.assert_array_equal(
            _kmajor_read(ks, (t // 4) * KEY_BLOCK * 128 + 32 * (t % 4), 64),
            k[:, 16 * t:16 * t + 16])
    for t in range(KEY_BLOCK // 16):
        np.testing.assert_array_equal(_mnmajor_read(vs, 16 * 128 * t)[:, :D],
                                      v[16 * t:16 * t + 16])


@pytest.mark.parametrize("D", [64, 128])
def test_q_rows_land_where_each_warpgroup_reads_them(D):
    """The kernel's Q store (16-byte unit u of row r at (u / 8) * 128 * 128
    + r * 128 + ((u % 8) ^ (r % 8)) * 16) read through warpgroup w's
    K-major descriptor gives rows 64 w .. 64 w + 63."""
    rng = np.random.default_rng(7)
    q = rng.integers(0, 1 << 16, size=(TILE_ROWS, D))
    smem = np.full(TILE_ROWS * D, -1, dtype=np.int64)
    for r in range(TILE_ROWS):
        for u in range(D // 8):
            off = (u // 8) * (TILE_ROWS * 128) + r * 128 + (((u % 8) ^ (r & 7)) << 4)
            smem[off // 2: off // 2 + 8] = q[r, 8 * u:8 * u + 8]
    for w in (0, 1):
        for t in range(D // 16):
            start = (t // 4) * (TILE_ROWS * 128) + w * 64 * 128 + 32 * (t % 4)
            np.testing.assert_array_equal(_kmajor_read(smem, start, 64),
                                          q[64 * w:64 * w + 64, 16 * t:16 * t + 16])


@pytest.mark.parametrize("D", [64, 128])
def test_widened_e4m3_stage_is_the_tma_landing_of_its_values(D):
    """The converter warps' stores (raw 16-byte unit u of key k: its 16
    values to the 16-byte units 2 (u % 4), +1 of 64-column chunk u / 4, each
    XOR k % 8) put every value where TMA lands a bf16 stage, for K and V."""
    rng = np.random.default_rng(D + 1)
    half = KEY_BLOCK * D  # elements of a stage's K (or V)
    vals = rng.integers(0, 1 << 16, size=(2, KEY_BLOCK, D))
    smem = np.full(2 * half, -1, dtype=np.int64)
    for which in (0, 1):
        for k in range(KEY_BLOCK):
            for u in range(D // 16):
                row = which * half * 2 + (u // 4) * (KEY_BLOCK * 128) + k * 128
                u0 = 2 * (u % 4)
                for i, unit in enumerate((u0, u0 + 1)):
                    off = row + ((unit ^ (k & 7)) << 4)
                    smem[off // 2: off // 2 + 8] = vals[which, k, 16 * u + 8 * i:16 * u + 8 * i + 8]
    for which in (0, 1):
        want = _land_stage(vals[which])[:half]
        np.testing.assert_array_equal(smem[which * half:(which + 1) * half], want)


def test_p_fragments_are_the_score_accumulator():
    """The kernel packs pa[4 t + i] = (s[8 t + 2 i], s[8 t + 2 i + 1]): for
    every thread of the warpgroup this is the A fragment of k16 step t of
    P V (wgmma's m64k16 register layout: a[i] holds row +8 (i % 2), k +8
    (i / 2) + 2 (lane % 4) (+1)), read off the m64n64 accumulator layout
    (s[4 j + 2 h + c] is row +8 h, column 8 j + 2 (lane % 4) + c)."""
    for warp in range(4):
        for lane in range(32):
            base, quad = 16 * warp + lane // 4, lane % 4

            def acc(idx):
                j, h, c = idx // 4, (idx // 2) % 2, idx % 2
                return base + 8 * h, 8 * j + 2 * quad + c
            for t in range(KEY_BLOCK // 16):
                for i in range(4):
                    for e in range(2):
                        frag = (base + 8 * (i % 2), 16 * t + 8 * (i // 2) + 2 * quad + e)
                        assert acc(8 * t + 2 * i + e) == frag


# ---------------------------------------------------------------------------
# the body's order of operations, emulated
# ---------------------------------------------------------------------------


def _dequant_rows(pages, page, h, D, lanes):
    """A page's rows of kv head h as fp32, ``lanes`` of them from the
    head's first (the build's width: past the head's D lanes the next
    head's, and zeros past the row, as TMA fills them): bf16 as it is, e4m3
    widened (exact; the scales are applied where the kernel applies them)."""
    rows = pages[page, :, h * D:h * D + lanes].to(torch.float32)
    return torch.nn.functional.pad(rows, (0, lanes - rows.shape[1]))


def emulate(q, k_pages, v_pages, pt, ctx, qmask, scale, mode="bf16", ks=None, vs=None):
    """The kernel's arithmetic in torch, unit by unit: a unit is a tile of a
    (request, kv head) as the plan launches it, its rows walked over its own
    key blocks. Row-wise the arithmetic is elementwise (fp32), the scores
    exact products summed in fp64, so a row's result depends only on the
    blocks it walks and the keys it sees there. qmask None: the causal
    rule. mode: bf16, fp8 (static [Hkv] scales) or fp8_tok ([n_pages, ps,
    Hkv]). Heads of 80 or 96 lanes run in the 128-lane build's width (D
    rounded up to whole 64-lane boxes, as ``pa_dispatch`` picks the build):
    Q zero past D, the rows read from the head's first lane, O's lanes past
    D dropped."""
    B, Q, Hq, D = q.shape
    lanes = -(-D // 64) * 64
    Hkv = k_pages.shape[2] // D
    G = Hq // Hkv
    causal = qmask is None
    plan = attention_plan(B, Q, Hq, Hkv)
    out = torch.zeros(B, Q, Hq, D, dtype=torch.bfloat16)
    for b in range(B):
        c = int(ctx[b])
        for h in range(Hkv):
            for z in range(plan.n_tiles):
                tile = tile_of(z, plan.n_tiles, causal)
                t0 = tile * plan.positions
                nt = min(plan.positions, Q - t0)
                rows = [(h * G + r // nt, t0 + r % nt) for r in range(G * nt)]
                nb = key_blocks(c, Q, t0, nt, causal, pt.shape[1])
                qr = torch.stack([q[b, t, qh] for qh, t in rows]).to(torch.float64)
                qr = torch.nn.functional.pad(qr, (0, lanes - D))
                tpos = torch.tensor([t for _, t in rows])
                kfac = torch.tensor(scale, dtype=torch.float32)
                if mode == "fp8":
                    kfac = kfac * ks[h]
                kfac = kfac * torch.tensor(LOG2E)
                # the scores stay in the products' units (and m with them)
                # but in the per-token mode, which scales each column first
                sfac = torch.tensor(1.0) if mode == "fp8_tok" else kfac
                R = len(rows)
                m = torch.full((R,), NEG_INF, dtype=torch.float32)
                lq = torch.zeros(R, 4)  # each quad thread's share of l
                o = torch.zeros(R, lanes)
                for kb in range(nb):
                    page = int(pt[b, kb])
                    kk = _dequant_rows(k_pages, page, h, D, lanes)
                    vv = _dequant_rows(v_pages, page, h, D, lanes)
                    s = (qr @ kk.to(torch.float64).T).to(torch.float32)
                    if mode == "fp8_tok":
                        s = s * kfac * ks[page, :, h]
                    key = kb * KEY_BLOCK + torch.arange(KEY_BLOCK)
                    if causal:
                        vis = key[None] <= c + tpos[:, None]
                    else:
                        sl = (key - c).clamp(0, Q - 1)
                        vis = (key[None] < c) | ((key[None] >= c) & (key[None] < c + Q)
                                                 & qmask[b][tpos][:, sl])
                    s = torch.where(vis, s, torch.tensor(NEG_INF))
                    m_new = torch.maximum(m, s.max(1).values)
                    alpha = torch.exp2((m - m_new) * sfac)
                    m = m_new
                    # 2^(s sfac - m sfac): the kernel fuses it into one fma
                    p = torch.where(s == NEG_INF, torch.tensor(0.0),
                                    torch.exp2(s * sfac - m_new[:, None] * sfac))
                    # a quad thread's columns 8 j + 2 quad + c: pairs (c = 0, 1),
                    # then a fixed tree over j
                    pr = p.reshape(R, 8, 4, 2)
                    a = pr[..., 0] + pr[..., 1]  # [R, j, quad]
                    ps = ((a[:, 0] + a[:, 1]) + (a[:, 2] + a[:, 3])) + \
                        ((a[:, 4] + a[:, 5]) + (a[:, 6] + a[:, 7]))
                    lq = lq * alpha[:, None] + ps
                    if mode == "fp8_tok":
                        p = p * vs[page, :, h]
                    pb = p.to(torch.bfloat16).to(torch.float32)
                    o = o * alpha[:, None]
                    for kk_i in range(KEY_BLOCK):
                        o = o + pb[:, kk_i:kk_i + 1] * vv[kk_i]
                lt = (lq[:, 0] + lq[:, 1]) + (lq[:, 2] + lq[:, 3])
                inv = 1.0 / torch.where(lt > 0, lt, torch.ones_like(lt))
                if mode == "fp8":
                    inv = inv * vs[h]
                res = (o[:, :D] * inv[:, None]).to(torch.bfloat16)
                for i, (qh, t) in enumerate(rows):
                    out[b, t, qh] = res[i]
    return out


PS = KEY_BLOCK
D_EMU = 64


def _case(B, ctx, Q, Hkv, G, mode, seed, D=D_EMU):
    """bf16-exact inputs (q, an arena of ctx + Q written rows a request,
    permuted page tables; heads of ``D`` lanes) as numpy for JAX and
    torch for the emulation."""
    rng = np.random.default_rng(seed)
    P = -(-(max(ctx) + Q) // PS) + 1
    n_pages = B * P + 1
    bf = lambda a: torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)  # noqa: E731
    q = bf(rng.normal(size=(B, Q, G * Hkv, D)))
    k = rng.normal(size=(n_pages, PS, Hkv * D))
    v = rng.normal(size=(n_pages, PS, Hkv * D))
    pt = (rng.permutation(n_pages - 1)[:B * P] + 1).reshape(B, P).astype(np.int32)
    ks = vs = None
    if mode == "bf16":
        kt, vt = bf(k), bf(v)
        kn, vn = kt.float().numpy(), vt.float().numpy()
    else:
        k8 = np.asarray(jnp.asarray(k * 4).astype(jnp.float8_e4m3fn))
        v8 = np.asarray(jnp.asarray(v * 4).astype(jnp.float8_e4m3fn))
        kn, vn = k8, v8
        kt = torch.from_numpy(k8.view(np.uint8).copy()).view(torch.float8_e4m3fn)
        vt = torch.from_numpy(v8.view(np.uint8).copy()).view(torch.float8_e4m3fn)
        shape = (Hkv,) if mode == "fp8" else (n_pages, PS, Hkv)
        ks = rng.uniform(0.01, 0.1, shape).astype(np.float32)
        vs = rng.uniform(0.01, 0.1, shape).astype(np.float32)
    return q, kt, vt, kn, vn, pt, ks, vs


def _tree_mask(B, Q, seed):
    m = np.random.default_rng(seed).random((B, Q, Q)) < 0.4
    m |= np.eye(Q, dtype=bool)
    m[:, :, 0] = True
    return m


def _rel(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-12))


@pytest.mark.parametrize("G", [1, 2, 4, 5, 7])
@pytest.mark.parametrize("mode", ["bf16", "fp8_tok"])
@pytest.mark.parametrize("kind", ["decode", "verify", "prefill"])
def test_emulated_body_matches_the_jax_package(G, mode, kind):
    """Against the fp32 reference, and the Pallas kernel of the case in
    interpret mode (the per-token e4m3 kernel serves decode only)."""
    _body_against_jax(G, mode, kind)


@pytest.mark.parametrize("G", [1, 5, 7])
@pytest.mark.parametrize("mode", ["bf16", "fp8_tok"])
@pytest.mark.parametrize("Q", [129, 200])
def test_emulated_wide_tree_verify_matches_the_jax_reference(G, mode, Q):
    """A tree verify of 129 or 200 rows (several tiles of the mask rule,
    each walking the keys up to the step's last) against the fp32
    reference: the JAX package has no Pallas kernel past 128 rows and
    serves it through XLA, as ``paged_attention_ref`` computes it."""
    _body_against_jax(G, mode, "verify", Q)


def _body_against_jax(G, mode, kind, Q=None):
    B, Hkv, ctx = 2, 2, [70, 133]
    Q = Q or {"decode": 1, "verify": 17, "prefill": 200}[kind]
    q, kt, vt, kn, vn, pt, ks, vs = _case(B, ctx, Q, Hkv, G, mode, seed=G)
    scale = D_EMU ** -0.5
    ctx_np = np.array(ctx, np.int32)
    if kind == "prefill":
        qmask = None
        jmask = np.broadcast_to(np.tril(np.ones((Q, Q), bool)), (B, Q, Q))
    else:
        jmask = np.ones((B, 1, 1), bool) if Q == 1 else _tree_mask(B, Q, G)
        qmask = torch.from_numpy(jmask)
    got = emulate(q, kt, vt, torch.from_numpy(pt), ctx_np, qmask, scale, mode,
                  None if ks is None else torch.from_numpy(ks),
                  None if vs is None else torch.from_numpy(vs)).float().numpy()
    qn = q.float().numpy()
    jks = jvs = None
    if mode == "fp8_tok":  # JAX's per-token scale arena is lane-padded to 128
        jks = np.zeros((1,) + ks.shape[:2] + (128,), np.float32)
        jvs = np.zeros_like(jks)
        jks[0, ..., :Hkv], jvs[0, ..., :Hkv] = ks, vs
    ref = jax_ref(jnp.asarray(qn), jnp.asarray(kn), jnp.asarray(vn), jnp.asarray(pt),
                  jnp.asarray(ctx_np), jnp.asarray(jmask), scale,
                  None if jks is None else jnp.asarray(jks[0]),
                  None if jvs is None else jnp.asarray(jvs[0]))
    assert _rel(got, ref) < 2e-2
    if (mode == "fp8_tok" and kind != "decode") or Q > 128 and kind == "verify":
        return
    if mode == "fp8_tok":
        pallas = j_paged_attention_tok(jnp.asarray(qn), jnp.asarray(kn)[None],
                                       jnp.asarray(vn)[None], jnp.asarray(jks),
                                       jnp.asarray(jvs), jnp.asarray(pt), jnp.asarray(ctx_np),
                                       scale, interpret=True, layer=jnp.int32(0))
        tol = 3e-2
    elif kind == "prefill":
        pallas = j_paged_attention_prefill(jnp.asarray(qn), jnp.asarray(kn), jnp.asarray(vn),
                                           jnp.asarray(pt), jnp.asarray(ctx_np), scale,
                                           interpret=True, qt=64)
        tol = 2e-2
    else:
        pallas = j_paged_attention(jnp.asarray(qn), jnp.asarray(kn), jnp.asarray(vn),
                                   jnp.asarray(pt), jnp.asarray(ctx_np), jnp.asarray(jmask),
                                   scale, interpret=True)
        tol = 2e-2
    assert _rel(got, np.asarray(pallas.astype(jnp.float32))) < tol


@pytest.mark.parametrize("mode", ["bf16", "fp8", "fp8_tok"])
@pytest.mark.parametrize("G", [1, 2, 4, 7])
def test_emulated_rows_are_the_same_at_every_width_route_and_place(mode, G):
    """A row of a causal 300-token prefill equals, bit for bit, the decode
    of its token over ctx + t keys (Q = 1), at every place of a tile (the
    first tile's positions with all G heads fill its G * (128 // G) places,
    126 at G = 7; the last tile's rows too), and the same rows inside a
    17-wide verify whose mask is causal."""
    _rows_same(mode, G, 1, D_EMU)


@pytest.mark.parametrize("mode", ["bf16", "fp8", "fp8_tok"])
def test_emulated_rows_of_80_lane_heads_are_the_same_at_every_width_route_and_place(mode):
    """As above for heads of 80 lanes in the 128-lane build (two kv heads:
    head 0 reads head 1's first 48 lanes beside its own, head 1 zeros past
    the row), at G = 2."""
    _rows_same(mode, 2, 2, 80)


def _rows_same(mode, G, Hkv, D):
    ctx, Q = [45], 300
    q, kt, vt, _, _, pt, ks, vs = _case(1, ctx, Q, Hkv, G, mode, seed=10 + G, D=D)
    ks_t = None if ks is None else torch.from_numpy(ks)
    vs_t = None if vs is None else torch.from_numpy(vs)
    ptt = torch.from_numpy(pt)
    pre = emulate(q, kt, vt, ptt, ctx, None, 0.125, mode, ks_t, vs_t)
    places = {r for t0, nt, rows in _tiles(Q, G, TILE_ROWS // G)
              for r, _ in enumerate(rows)}
    assert places == set(range(G * (TILE_ROWS // G)))
    one = torch.ones(1, 1, 1, dtype=torch.bool)
    for t in list(range(TILE_ROWS // G)) + list(range(Q - 12, Q)):
        dec = emulate(q[:, t:t + 1], kt, vt, ptt, [ctx[0] + t], one, 0.125, mode, ks_t, vs_t)
        assert torch.equal(dec[:, 0], pre[:, t]), t
    for t0 in (0, 111, 283):  # verify windows: rows t0 .. t0 + 16 of the chunk
        ver = emulate(q[:, t0:t0 + 17], kt, vt, ptt, [ctx[0] + t0], causal_qmask(17)[None],
                      0.125, mode, ks_t, vs_t)
        assert torch.equal(ver, pre[:, t0:t0 + 17])
