"""K4's compaction entry and K15's order of operations, on the CPU.

K4 (``csrc/kv_permute.cu``): ``kv_compact_tail`` takes up to four arenas
(K, V and fp8_tok's scale arenas, rows of any multiple of 4 bytes) and the
verify step's own tensors and derives each request's window and moves
inside the kernel. On the CPU it is its plain version, the composed
route (``tail_window`` and ``kv_permute_pages_plain``), held here byte for
byte against the JAX package's ``compact_kv_tail`` (the whole arena, page 0
included, but where a row is inactive: there page 0 is held against the
JAX package's Pallas route in interpret mode; in every case at most one
request's window names the null page, whose rows are otherwise undefined
where two requests write them). The
kernel's own steps (the window's page ids, the later-slot rule on aliased
pages, the list of moving rows, staged before any is written) are replayed
in Python (``compaction_moves``) and must give the same bytes, and change
exactly the rows the plain version changes, in every arena of a four-arena
call; ``permute_plan`` is checked against the kernel's shared-memory rule,
and the launch structs against the sources.

K6 (``csrc/kv_page_write.cu``) and K17 (``csrc/kv_rows.cu`` ``kv_move_rows``):
their launch plans (``page_write_plan``, ``move_plan``) cover every byte of
every page or row exactly once within a block's shared memory.

K15 (``csrc/rmsnorm.cu``): ``rms_norm_replay`` repeats the kernel's order
of operations in fp32 torch ops (lanes from ``norm_plan``, each summing its
chunks in order, an xor butterfly, warps in order). It is held against the
JAX package's ``rms_norm`` / ``rms_group_norm``: bf16 within one bf16 ulp
of the largest value (2^-7; a value next to a rounding boundary may round
the other way after the fp32 sum in another order), fp32 within 2e-6 of it
(the fp32 sum in another order and XLA's rsqrt, a few ulps). On the card
the kernel must equal the replay bit for bit (``tests/test_torch_gpu.py``).
"""

import ctypes
import re
from pathlib import Path

import numpy as np
import pytest
from hypothesis import given, settings, strategies as hst

import jax.numpy as jnp
import torch

from painlessinferenceacceleration_tpu.engine import cache as jcache
from painlessinferenceacceleration_tpu.ops import rmsnorm as jrms
from painlessinferenceacceleration_tpu.ops.kv_update import kv_permute_pages_pallas

from _kv_cases import CASES, LAYERS, PS, compact_case

from painlessinferenceacceleration_tpu_torch.engine import cache as tcache
from painlessinferenceacceleration_tpu_torch.ops import rmsnorm as trms
from painlessinferenceacceleration_tpu_torch.ops import kv_update as ku
from painlessinferenceacceleration_tpu_torch.ops.kv_update import (
    MAX_MOVES,
    STAGE_BYTES,
    compact_static,
    compaction_moves,
    kv_compact_tail,
    kv_compact_tail_plain,
    move_plan,
    page_write_plan,
    permute_plan,
    tail_window,
    window_pages,
)

CSRC = Path(ku.__file__).resolve().parent.parent / "csrc"
SMEM_LIMIT = 232448  # the H100's shared memory a block may take


def _t(a, dtype=None):
    """A torch copy of a (the compactions work in place)."""
    t = torch.from_numpy(np.array(a))
    return t if dtype is None else t.to(dtype)


def _args(c, wide=False):
    it = torch.int64 if wide else torch.int32
    return (_t(c["pt"], it), _t(c["ctx"], it), _t(c["path"], it), _t(c["ne"], it), c["Q"],
            _t(c["active"]))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", CASES)
def test_compaction_plain_matches_jax_byte_for_byte(kind, dtype):
    c = compact_case(kind)
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    k, v = _t(c["k"], tdt), _t(c["v"], tdt)
    before = kv_compact_tail.launches
    kv_compact_tail((k, v), *_args(c, wide=kind == "r2l8"))
    assert kv_compact_tail.launches == before  # the CPU takes the plain version
    # An inactive row's window is the null page. The JAX package's two routes
    # fill page 0 differently there (its jnp route copies the row's own
    # window into it, its Pallas route permutes page 0 itself, as the port
    # does), so page 0 is held against the Pallas route in interpret mode.
    first = 0 if c["active"].all() else 1
    page_ids, src_of, base = tail_window(*_args(c)[:5], PS, _t(c["active"]))
    src_rel = (src_of - base[:, None]).clamp(0, src_of.shape[1] - 1)
    for got, a in ((k, c["k"]), (v, c["v"])):
        ja = jnp.asarray(a).astype(jdt)
        ref = jcache.compact_kv_tail(ja, jnp.asarray(c["pt"]), jnp.asarray(c["ctx"]),
                                     jnp.asarray(c["path"]), jnp.asarray(c["ne"]), c["Q"],
                                     jnp.asarray(c["active"]))
        want = np.asarray(ref.astype(jnp.float32))
        assert (got.float().numpy()[:, first:] == want[:, first:]).all()
        if first:
            pallas = kv_permute_pages_pallas(ja, jnp.asarray(page_ids.int().numpy()),
                                             jnp.asarray(src_rel.int().numpy()), interpret=True)
            assert (got.float().numpy() == np.asarray(pallas.astype(jnp.float32))).all()


@pytest.mark.parametrize("kind", ["r2l8", "q128", "clip", "mla"])
def test_k_and_v_in_one_call_equal_two_calls(kind):
    c = compact_case(kind, seed=1)
    k, v = _t(c["k"]), _t(c["v"])
    k1, v1 = k.clone(), v.clone()
    tcache.compact_kv_tail((k, v), *_args(c))
    tcache.compact_kv_tail(k1, *_args(c))
    tcache.compact_kv_tail(v1, *_args(c))
    assert torch.equal(k, k1) and torch.equal(v, v1)
    assert not torch.equal(k, _t(c["k"]))  # something moved


@pytest.mark.parametrize("kind", CASES)
def test_replayed_move_lists_change_what_the_plain_version_changes(kind):
    c = compact_case(kind, seed=2)
    k = _t(c["k"])
    plain = kv_compact_tail_plain((k.clone(),), *_args(c))[0]
    moves = compaction_moves(c["pt"], c["ctx"], c["path"], c["ne"], c["Q"], PS, c["active"])
    # the kernel: every listed source read (staged), then every destination written
    flat = k.reshape(LAYERS, -1, k.shape[-1]).clone()
    srcs = [s for m in moves for s, _ in m]
    dsts = [d for m in moves for _, d in m]
    assert len(set(dsts)) == len(dsts)
    flat[:, dsts] = flat[:, srcs].clone()
    assert torch.equal(flat.reshape(k.shape), plain)
    changed = (plain != k).any(-1).any(0).reshape(-1).nonzero().flatten().tolist()
    assert sorted(changed) == sorted(dsts)
    M = c["path"].shape[1]
    assert all(len(m) <= M for m in moves)  # the plan stages max_moves = M rows
    if kind in ("identity", "no_edges"):
        assert not dsts


def _four_arenas(c, heads=2):
    """e4m3 K and V rows (as uint8 here: the bytes) and f32 scale rows of
    ``heads`` heads, numpy, from a compaction case."""
    rng = np.random.default_rng(5)
    k, v = (rng.integers(0, 256, c[n].shape, dtype=np.uint8) for n in "kv")
    ks, vs = (rng.normal(size=c["k"].shape[:3] + (heads,)).astype(np.float32)
              for _ in range(2))
    return k, v, ks, vs


@pytest.mark.parametrize("kind", CASES)
def test_replayed_move_lists_change_what_the_plain_version_changes_in_four_arenas(kind):
    """One four-arena call (32- and 36-byte K rows, 32-byte V rows, 8-byte
    scale rows: the kernel's 16-byte and 4-byte routes) changes each arena as
    its own call does and as the replayed move lists do."""
    c = compact_case(kind, seed=6, widths=(32, 32))
    arenas = tuple(_t(a) for a in _four_arenas(c))
    plain = kv_compact_tail_plain(tuple(a.clone() for a in arenas), *_args(c))
    moves = compaction_moves(c["pt"], c["ctx"], c["path"], c["ne"], c["Q"], PS, c["active"])
    srcs = [s_ for m in moves for s_, _ in m]
    dsts = [d for m in moves for _, d in m]
    for a, got in zip(arenas, plain):
        alone = kv_compact_tail_plain((a.clone(),), *_args(c))[0]
        assert torch.equal(got, alone)
        flat = a.reshape(LAYERS, -1, a.shape[-1]).clone()
        flat[:, dsts] = flat[:, srcs].clone()
        assert torch.equal(flat.reshape(a.shape), got)
    rbs = tuple(a.shape[-1] * a.element_size() for a in arenas)
    plan = permute_plan(rbs, LAYERS, c["path"].shape[1], len(c["ctx"]), c["pt"].shape[1])
    assert plan.units == sum(LAYERS * -(-rb // plan.cb) for rb in rbs)


@pytest.mark.parametrize("row_bytes,L,max_moves,B,P", [
    ((4096, 4096, 128, 128), 32, 16, 8, 64),  # fp8_tok at Llama-2-7B: e4m3 + 32 heads' scales
    ((4096, 4096, 8, 8), 8, 16, 8, 12),  # fp8_tok with 2 kv heads: 8-byte scale rows
    ((1024, 1024, 16, 16), 8, 63, 1, 16),  # 8 kv heads of e4m3, the generator's Q = 64
    ((8,), 2, 16, 3, 6),  # one 8-byte arena
    ((8192, 8192), 32, 16, 1, 64),  # Llama-2-7B K and V, Q = 17, 4096 tokens a table
    ((8192, 8192), 32, 16, 8, 64),  # serving's B = 8
    ((8192, 8192), 32, 63, 1, 16),  # the generator's Q = 64
    ((8192,), 32, 128, 1, 0),  # kv_permute_pages over a 128-slot window
    ((8192, 8192), 32, 127, 1, 64),  # Q = 128
    ((1152, 1024), 27, 16, 1, 80),  # DeepSeek-V2-Lite's latent K and V rows
    ((64, 64), 2, 16, 3, 6),  # the tests' tiny rows
])
def test_permute_plan_stages_every_move_within_the_budget(row_bytes, L, max_moves, B, P):
    plan = permute_plan(row_bytes, L, max_moves, B, P)
    cb = plan.cb
    assert cb >= 16 and cb & (cb - 1) == 0 and max_moves * cb <= STAGE_BYTES
    assert cb < 2 * max(row_bytes) or cb == 16  # no wider than the widest row needs
    assert 2 * cb * max_moves > STAGE_BYTES or cb >= max(row_bytes)  # the widest that fits
    assert plan.units == sum(L * -(-rb // cb) for rb in row_bytes)
    blocks, b = plan.grid
    assert b == B and 1 <= blocks <= plan.units
    # the kernel's layout: the two move lists and the page-table row (each
    # to 16 bytes), then the stage
    assert plan.smem == ((8 * max_moves + 15) // 16 * 16 + (4 * P + 15) // 16 * 16
                         + max_moves * cb)
    assert plan.smem <= 227 * 1024


def test_permute_plan_refuses_more_moves_than_the_stage_holds():
    with pytest.raises(ValueError, match="moving rows"):
        permute_plan((8192,), 32, STAGE_BYTES // 16 + 1, 1)


@pytest.mark.parametrize("row_bytes", [(4096, 6), (2,), (), (16,) * 5, (4096, 0)])
def test_permute_plan_refuses_rows_off_the_4_byte_rule(row_bytes):
    with pytest.raises(ValueError, match="multiple of 4"):
        permute_plan(row_bytes, 2, 16, 1, 6)


def test_compact_static_takes_four_arenas_and_refuses_rows_off_the_4_byte_rule():
    c = compact_case("r2l8", widths=(32, 32))
    k, v, ks, vs = (_t(a) for a in _four_arenas(c))
    args = _args(c)[:5] + (_t(c["active"]),)
    st, addr = compact_static((k, v, ks, vs), *args)
    assert list(st.row_bytes) == [32, 32, 8, 8] and addr == ctypes.addressof(st)
    assert list(compact_static((k,), *args)[0].row_bytes) == [32, 0, 0, 0]
    six = torch.zeros(k.shape[:3] + (6,), dtype=torch.uint8)  # 6-byte rows
    with pytest.raises(ValueError, match="4-byte-multiple"):
        compact_static((k, six), *args)
    with pytest.raises(ValueError, match="1-4 arenas"):
        compact_static((k, v, ks, vs, ks), *args)
    with pytest.raises(ValueError, match="1-4 arenas"):
        compact_static((k, ks[:, :-1]), *args)  # another geometry


def _c_struct(src: str, name: str) -> list:
    """(field, type, dims) of a C struct of the kernel sources."""
    body = re.search(r"struct %s \{(.*?)\};" % name, src, re.S).group(1)
    fields = []
    for line in body.splitlines():
        line = line.split("//")[0].strip().rstrip(";")
        if not line:
            continue
        kind, names = (("long long", line[len("long long"):]) if line.startswith("long long")
                       else line.split(None, 1))
        for f in names.split(","):
            f = f.strip()
            fields.append((f.split("[")[0], kind, [int(d) for d in re.findall(r"\[(\d+)\]", f)]))
    return fields


def _py_struct(cls) -> list:
    out = []
    for name, ctype in cls._fields_:
        dims = []
        while hasattr(ctype, "_length_"):
            dims.append(ctype._length_)
            ctype = ctype._type_
        out.append((name, "long long" if ctype is ctypes.c_longlong else "int", dims))
    return out


@pytest.mark.parametrize("source,struct,cls", [
    ("kv_permute.cu", "KvPermuteStatic", "_Static"),
    ("kv_page_write.cu", "KvPageWriteStatic", "_PageWriteStatic"),
    ("kv_rows.cu", "KvMoveStatic", "_MoveStatic"),
])
def test_launch_structs_match_the_kernel_sources(source, struct, cls):
    src = (CSRC / source).read_text()
    assert _c_struct(src, struct) == _py_struct(getattr(ku, cls))
    consts = {m.group(1): int(m.group(2))
              for m in re.finditer(r"constexpr int (k\w+) = (\d+);", src)}
    if source == "kv_permute.cu":
        assert consts["kMaxArenas"] == ku.MAX_ARENAS
    if source == "kv_rows.cu":
        assert consts["kMaxMoves"] == MAX_MOVES
    if source == "kv_page_write.cu":
        assert consts["kPiece"] == ku.PAGE_PIECE


def _covers_once(n_bytes: int, part: int, parts: int) -> None:
    """Blocks [c * part, min((c + 1) * part, n_bytes)) for c < parts: each
    non-empty, together every byte once."""
    assert parts * part >= n_bytes > (parts - 1) * part


@settings(max_examples=300, deadline=None)
@given(unit=hst.sampled_from([16, 4, 1]), units=hst.integers(1, 8192),
       N=hst.integers(1, MAX_MOVES), L=hst.sampled_from([1, 2, 8, 27, 32, 80]),
       sms=hst.sampled_from([1, 132]))
def test_move_plan_covers_every_byte_of_every_row_once(unit, units, N, L, sms):
    row_bytes = max(4, min(8192, units * unit) // unit * unit)
    plan = move_plan(N, row_bytes, L, unit, SMEM_LIMIT, sms)
    _covers_once(row_bytes, plan.slice, plan.grid_x)
    assert plan.slice % unit == 0 and plan.slice & (plan.slice - 1) == 0
    assert plan.table >= 2 * N and plan.table & (plan.table - 1) == 0
    assert plan.smem == ((8 * N + 15) // 16 * 16 + 8 * plan.table
                         + plan.stages * N * plan.slice)
    assert plan.smem <= SMEM_LIMIT
    # every unit is walked: a block each (4- and 1-byte rows), or a
    # persistent grid over them (the 16-byte ring)
    n_units = plan.grid_x * L
    if unit == 16:
        assert 1 <= plan.stages <= ku.MOVE_STAGES and 1 <= plan.blocks <= n_units
        assert plan.blocks <= ku.MOVE_BLOCKS_PER_SM * sms
    else:
        assert plan.stages == 1 and plan.blocks == n_units
    # no wider than the row needs, and one stage within the budget where it can be
    assert plan.slice < 2 * row_bytes or plan.slice == unit
    if N * unit <= ku.MOVE_STAGE_BYTES:
        assert N * plan.slice <= ku.MOVE_STAGE_BYTES


@pytest.mark.parametrize("N", [12, 63, 252, 1024])
def test_move_plan_at_the_7b_rows(N):
    """Row 12's cases (8192-byte rows, 32 layers): a ring of stages within
    the budget over enough units, the grid filling the card."""
    plan = move_plan(N, 8192, 32, 16, SMEM_LIMIT, 132)
    assert N * plan.slice <= ku.MOVE_STAGE_BYTES and plan.stages == ku.MOVE_STAGES
    assert plan.grid_x * 32 >= ku.MOVE_MIN_UNITS and plan.blocks >= 132


@pytest.mark.parametrize("args", [(0, 16, 2, 16), (MAX_MOVES + 1, 16, 2, 16),
                                  (4, 36, 2, 16), (4, 6, 2, 4), (4, 16, 2, 8)])
def test_move_plan_refuses(args):
    with pytest.raises(ValueError, match="kv_move_rows"):
        move_plan(*args, SMEM_LIMIT, 132)


def test_move_plan_refuses_what_no_block_fits():
    with pytest.raises(ValueError, match="shared memory"):
        move_plan(1024, 8192, 2, 16, 1024, 132)  # a 1 KB limit


@settings(max_examples=200, deadline=None)
@given(page_bytes=hst.integers(1, 1 << 20), W=hst.integers(1, 64),
       L=hst.sampled_from([1, 2, 8, 32]), sms=hst.sampled_from([1, 132]))
def test_page_write_plan_covers_every_byte_of_a_page_once(page_bytes, W, L, sms):
    pieces, grid = page_write_plan(page_bytes, W, L, sms)
    _covers_once(page_bytes, ku.PAGE_PIECE, pieces)
    assert 1 <= grid <= min(W * L * pieces, ku.PAGE_BLOCKS_PER_SM * sms)
    assert grid == W * L * pieces or grid == ku.PAGE_BLOCKS_PER_SM * sms


@pytest.mark.parametrize("width", [128, 512, 2048, 4096, 7168])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_rms_norm_replay_matches_jax(width, dtype):
    rng = np.random.default_rng(width)
    x = (rng.normal(size=(9, width)) * 2).astype(np.float32)
    w = (1 + 0.2 * rng.normal(size=width)).astype(np.float32)
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tol = 2e-6 if dtype == "float32" else 2 ** -7
    got = trms.rms_norm_replay(_t(x, tdt), _t(w, tdt), 1e-6).float().numpy()
    ref = np.asarray(jrms.rms_norm(jnp.asarray(x).astype(jdt), jnp.asarray(w).astype(jdt),
                                   1e-6).astype(jnp.float32))
    assert np.abs(got - ref).max() <= tol * np.abs(ref).max()
    # the grouped kind at the hybrids' per-head width
    if width % 128 == 0 and width > 128:
        g = width // 128
        got = trms.rms_norm_replay(_t(x, tdt), _t(w, tdt), 1e-6, g).float().numpy()
        ref = np.asarray(jrms.rms_group_norm(jnp.asarray(x).astype(jdt),
                                             jnp.asarray(w).astype(jdt), 1e-6, g)
                         .astype(jnp.float32))
        assert np.abs(got - ref).max() <= tol * np.abs(ref).max()


@pytest.mark.parametrize("gw,elt,lanes", [
    (128, 2, 16), (512, 2, 32), (2048, 2, 32), (4096, 2, 64), (7168, 2, 128),
    (128, 4, 32), (4096, 4, 128), (8, 2, 1), (100, 2, 16)])
def test_norm_plan_covers_each_chunk_once(gw, elt, lanes):
    got_lanes, n, per_block = trms.norm_plan(gw, elt)
    assert got_lanes == lanes and 1 <= n <= trms.MAX_CHUNKS
    chunks = -(-gw * elt // 16)
    held = sorted(l + k * lanes for l in range(lanes) for k in range(n)
                  if l + k * lanes < chunks)
    assert held == list(range(chunks))
    assert per_block * lanes <= trms.MAX_LANES and (per_block * lanes) % 32 == 0


def test_rms_norm_replay_does_not_depend_on_the_rows():
    rng = np.random.default_rng(3)
    x = _t(rng.normal(size=(64, 4096)).astype(np.float32), torch.bfloat16)
    w = _t(rng.normal(size=4096).astype(np.float32), torch.bfloat16)
    full = trms.rms_norm_replay(x, w, 1e-5)
    for m in (1, 17):
        assert torch.equal(trms.rms_norm_replay(x[:m], w, 1e-5), full[:m])


def test_vec_bytes_takes_16_byte_loads_where_every_operand_allows():
    vec = trms._vec_bytes
    assert vec(2, 4096, 1152, 1024, 0, 512) == 16  # MLA's kv_a rows, stride 576
    assert vec(2, 4098, 8192, 4096, 0, 512) == 2  # x one element off
    assert vec(2, 4096, 8192, 200, 0, 512) == 2  # groups of 100 bf16
    assert vec(4, 4096, 400, 400, 0, 256) == 16
    assert vec(4, 4096, 400, 400, 4100, 256) == 4  # the gate off
