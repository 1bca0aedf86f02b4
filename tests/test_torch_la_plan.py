"""K14's launch plan, its fixed launch fields and its readout order, on the
CPU.

K14 (``csrc/linear_attention.cu``) reads out the recurrent state in one
fixed order that decode and tree verify share: d cut into
``READOUT_SPLIT`` ranges, each summed in ascending d with a rounded product
and sum each, then the partials added in a fixed pairwise tree. The plain
``la_readout`` repeats it; here it is held bit for bit against a scalar
replay written from that description in numpy float32, and the three
recurrent modes' plain versions (the CPU path) against each other: a
verified row equals the AR row at its position, a commit of n nodes n AR
steps. ``la_plan`` and ``la_static`` are held against every hybrid
configuration the port runs, their refusals, and the kernel source's own
constants and struct layout. The JAX parity of the same functions is in
``tests/test_torch_linear.py``.
"""

import ctypes
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from painlessinferenceacceleration_tpu_torch.config import ModelConfig
from painlessinferenceacceleration_tpu_torch.models.linear_attn import (
    default_decays,
    loglam_of,
)
from painlessinferenceacceleration_tpu_torch.ops import linear_attention as la

SRC = (Path(la.__file__).resolve().parent.parent / "csrc" / "linear_attention.cu").read_text()


def _rand(rng, *shape, scale=1.0):
    return torch.from_numpy((rng.normal(size=shape) * scale).astype(np.float32))


def _readout_replay(q: np.ndarray, S: np.ndarray) -> np.ndarray:
    """sum_d q[d] S[d, e] for each column e, one float32 operation at a
    time: READOUT_SPLIT ranges of ceil(D / READOUT_SPLIT) d, each summed from
    0 in ascending d; then ((p0 + p4) + (p2 + p6)) + ((p1 + p5) + (p3 + p7))."""
    f = np.float32
    D, E = S.shape
    rl = -(-D // la.READOUT_SPLIT)
    out = np.empty(E, np.float32)
    for e in range(E):
        p = []
        for r in range(la.READOUT_SPLIT):
            acc = f(0.0)
            for d in range(r * rl, min(D, (r + 1) * rl)):
                acc = f(acc + f(q[d] * S[d, e]))
            p.append(acc)
        out[e] = f(f(f(p[0] + p[4]) + f(p[2] + p[6])) + f(f(p[1] + p[5]) + f(p[3] + p[7])))
    return out


@pytest.mark.parametrize("D", [128, 64, 12, 8])
def test_readout_replays_the_fixed_split_order(D):
    rng = np.random.default_rng(D)
    q, S = _rand(rng, 2, 3, D, scale=0.7), _rand(rng, 2, 3, D, D)
    got = la.la_readout(q, S).numpy()
    for b in range(2):
        for h in range(3):
            assert np.array_equal(got[b, h], _readout_replay(q[b, h].numpy(),
                                                             S[b, h].numpy())), (b, h)


def test_readout_is_not_the_ascending_sum():
    """The split order differs from one ascending sum over d (the parent
    order) on some column: the test above would notice a fallback."""
    rng = np.random.default_rng(7)
    q, S = _rand(rng, 128), _rand(rng, 128, 128)
    acc = torch.zeros(128)
    for d in range(128):
        acc = acc + q[d] * S[d]
    assert not torch.equal(la.la_readout(q, S), acc)


def _tree(Q, R, L, dead=0):
    """Parallel branches after the root, ``dead`` nodes dead at the end."""
    par = torch.full((1, Q), -1, dtype=torch.int64)
    for i in range(1, Q):
        par[0, i] = 0 if (i - 1) % L == 0 else i - 1
    valid = torch.ones(1, Q, dtype=torch.bool)
    if dead:
        valid[0, Q - dead:] = False
        par[0, Q - dead:] = -2
    return par, valid


@pytest.mark.parametrize("D", [32, 128])
def test_decode_tree_commit_share_one_step(D):
    """On slot arenas, with int64 indices: every live node's verify row
    equals the AR decode row at its position (on its branch), and the commit
    of each branch's first n nodes equals n AR steps, in every layer."""
    H, R, L, slots, n_lin = 2, 3, 4, 3, 2
    Q = 1 + R * L
    rng = np.random.default_rng(D)
    q, k, v = (torch.nn.functional.silu(_rand(rng, 1, H, Q, D)) for _ in range(3))
    arena = _rand(rng, n_lin, slots, H, D, D, scale=0.1)
    ll = loglam_of(default_decays(H))
    lls = torch.stack([ll, ll * 0.5])
    sid = torch.tensor([2])
    par, valid = _tree(Q, R, L, dead=2)
    tree = la.linear_attention_tree(q, k, v, arena[0], par, valid, ll, sid)
    assert not tree[0, :, Q - 2:].any()
    for br in range(R):
        chain = [0] + list(range(1 + br * L, 1 + (br + 1) * L))
        live = [c for c in chain if valid[0, c]]
        s_ar = arena[0].clone()
        for c in live:
            o, _ = la.linear_attention_decode(*(t[:, :, c:c + 1] for t in (q, k, v)), s_ar,
                                              torch.ones(1, 1, dtype=torch.bool), ll, sid)
            assert torch.equal(o[0, :, 0], tree[0, :, c]), (br, c)
        for n in (1, len(live)):
            committed = arena.clone()
            la.linear_attention_commit(committed, torch.stack([k, k * 0.5]),
                                       torch.stack([v, v * 2.0]), torch.tensor([chain]),
                                       torch.tensor([n]), lls, sid)
            for layer, (kk, vv, lg) in enumerate(((k, v, ll), (k * 0.5, v * 2.0, ll * 0.5))):
                s_n = arena[layer].clone()
                for c in chain[:n]:
                    la.linear_attention_decode(*(t[:, :, c:c + 1] for t in (q, kk, vv)), s_n,
                                               torch.ones(1, 1, dtype=torch.bool), lg, sid)
                assert torch.equal(committed[layer], s_n), (br, n, layer)


def _hybrids():
    ring = ModelConfig.ring_mini_linear_2()
    return {
        "ring_mini_linear_2": ring,
        # tests/test_torch_linear.py's tiny models (CPU only: D = 8 and 16)
        "tiny_ring": ModelConfig(model_type="ring_linear", vocab_size=256, hidden_size=32,
                                 intermediate_size=64, num_hidden_layers=4,
                                 num_attention_heads=4, num_key_value_heads=4,
                                 linear_attention=True, layer_group_size=2),
        "tiny_bailing": ModelConfig(model_type="bailing_moe_linear_v2", vocab_size=256,
                                    hidden_size=64, intermediate_size=96,
                                    moe_intermediate_size=32, num_hidden_layers=4,
                                    num_attention_heads=4, num_key_value_heads=2,
                                    head_dim=16, linear_attention=True, layer_group_size=3,
                                    num_experts=8, num_experts_per_tok=2),
        # tests/test_torch_gpu.py's card hybrid
        "card_hybrid": ModelConfig(model_type="bailing_moe_linear_v2", vocab_size=512,
                                   hidden_size=256, intermediate_size=512,
                                   moe_intermediate_size=128, num_hidden_layers=4,
                                   num_attention_heads=4, num_key_value_heads=2, head_dim=64,
                                   linear_attention=True, layer_group_size=2,
                                   num_experts=8, num_experts_per_tok=2),
    }


@pytest.mark.parametrize("name", list(_hybrids()))
def test_plan_over_every_hybrid_config(name):
    cfg = _hybrids()[name]
    assert cfg.linear_attention
    H, D = cfg.num_attention_heads, cfg.head_dim
    n_lin = sum(1 for i in range(cfg.num_hidden_layers)
                if (i + 1) % cfg.layer_group_size != 0)
    if D % la.SLAB:
        with pytest.raises(ValueError, match="multiple of 16"):
            la.la_plan("chunk", 1, H, 4096, D)
        return
    for B, C in ((1, 4096), (2, 4096), (8, 512), (1, 1)):
        p = la.la_plan("chunk", B, H, C, D)
        tiles = -(-C // la.TILE)
        assert p.grids[0] == p.grids[2] == (tiles, H, B)
        assert p.grids[1][1:] == (H, B) and p.grids[1][0] * 4 * la.SCAN_THREADS >= D * D
        assert max(p.smem) <= la.SMEM_LIMIT
        assert p.workspace_bytes == 8 * B * H * tiles * D * D
    for B in (1, 8):
        p = la.la_plan("decode", B, H, 1, D)
        assert p.grids == ((D // la.SLAB, H, B),) and p.smem == (0,)
    for Q in (17, 64):
        p = la.la_plan("tree", 1, H, Q, D)
        assert p.smem[0] <= la.SMEM_LIMIT
    p = la.la_plan("commit", 1, H, 17, D, n_lin=n_lin)
    assert p.grids == ((D // la.SLAB, H, n_lin),)
    if name == "ring_mini_linear_2":
        assert n_lin == 16
        # the card is filled at B = 1: 16 heads x 64 tiles, 128 recurrent blocks
        assert np.prod(la.la_plan("chunk", 1, H, 4096, D).grids[0]) == 1024
        assert max(la.la_plan("chunk", 1, H, 4096, D).smem) <= la.SMEM_LIMIT // 2
        assert np.prod(la.la_plan("decode", 1, H, 1, D).grids[0]) == 128


@pytest.mark.parametrize("args,match", [
    (("chunk", 1, 16, 64, 8), "multiple of 16"),
    (("chunk", 1, 16, 64, 24), "multiple of 16"),
    (("tree", 1, 16, 17, 136), "multiple of 16"),
    (("decode", 1, 16, 2, 128), "one token a row"),
    (("tree", 1, 16, 300, 128), "shared memory|more than a block"),
    (("commit", 1, 16, 500, 128), "more than a block"),
    (("chunk", 0, 16, 64, 128), "positive"),
    (("decode", 70000, 16, 1, 128), "at most 65535"),
    (("prefill", 1, 16, 64, 128), "no mode"),
])
def test_plan_refuses(args, match):
    with pytest.raises(ValueError, match=match):
        la.la_plan(*args)


def _chunk_operands(C=100, D=64, **over):
    B, H = 2, 4
    ops = dict(xq=torch.zeros(B, H, C, D), xk=torch.zeros(B, H, C, D),
               xv=torch.zeros(B, H, C, D), state=torch.zeros(3, H, D, D),
               loglam=torch.zeros(H), slot_ids=torch.tensor([2, 0], dtype=torch.int32),
               lens=torch.tensor([C, 7], dtype=torch.int64))
    ops.update(over)
    return ops


def test_static_fields_for_each_mode():
    st, addr, plan = la.la_static("chunk", **_chunk_operands(C=300))
    assert addr == ctypes.addressof(st)
    assert (st.B, st.H, st.Q, st.D, st.tiles, st.slot_wide, st.lens_wide) == (2, 4, 300, 64,
                                                                               5, 0, 1)
    assert (st.smem, st.smem2) == (plan.smem[0], plan.smem[2])
    x = torch.zeros(2, 4, 50, 64)[:, :, 3:20]  # a strided view
    st, _, _ = la.la_static("tree", x, x, x, torch.zeros(2, 4, 64, 64), torch.zeros(4),
                            valid=torch.ones(2, 17, dtype=torch.bool),
                            parents=torch.zeros(2, 17, dtype=torch.int64))
    assert [list(r) for r in st.xs] == [list(x.stride()[:3])] * 3
    assert (st.idx_wide, list(st.valid_stride), st.smem) == (1, [17, 1],
                                                             la.la_plan("tree", 2, 4, 17,
                                                                        64).smem[0])
    arena = torch.zeros(3, 5, 4, 64, 64)
    win = torch.zeros(3, 2, 4, 17, 64)
    st, _, plan = la.la_static("commit", None, win, win, arena, torch.zeros(3, 4),
                               torch.tensor([4, 1]), lens=torch.tensor([3, 0]),
                               chain=torch.zeros(2, 9, dtype=torch.int32))
    assert (st.n_lin, st.M, st.layer_stride, st.win_layer) == (3, 9, 5 * 4 * 64 * 64,
                                                               2 * 4 * 17 * 64)
    assert plan.grids == ((4, 4, 6),)


@pytest.mark.parametrize("case", ["half", "valid_uint8", "ids_int16", "unaligned_rows",
                                  "loglam_shape", "state_view", "win_strides"])
def test_static_refuses(case):
    if case == "half":
        ops = _chunk_operands(xq=torch.zeros(2, 4, 100, 64, dtype=torch.float16))
        with pytest.raises(ValueError, match="fp32"):
            la.la_static("chunk", **ops)
    elif case == "valid_uint8":
        x = torch.zeros(1, 4, 1, 64)
        with pytest.raises(ValueError, match="bool"):
            la.la_static("decode", x, x, x, torch.zeros(1, 4, 64, 64), torch.zeros(4),
                         valid=torch.ones(1, 1, dtype=torch.uint8))
    elif case == "ids_int16":
        with pytest.raises(ValueError, match="int32 or int64"):
            la.la_static("chunk", **_chunk_operands(lens=torch.tensor([3, 1],
                                                                      dtype=torch.int16)))
    elif case == "unaligned_rows":
        x = torch.zeros(2, 4, 100, 66)[..., :64]  # rows 66 floats apart
        with pytest.raises(ValueError, match="multiples of 4"):
            la.la_static("chunk", **_chunk_operands(xq=x))
    elif case == "loglam_shape":
        with pytest.raises(ValueError, match="loglam"):
            la.la_static("chunk", **_chunk_operands(loglam=torch.zeros(1, 4)))
    elif case == "state_view":
        st = torch.zeros(3, 4, 64, 128)[..., :64]
        with pytest.raises(ValueError, match="contiguous fp32 state"):
            la.la_static("chunk", **_chunk_operands(state=st))
    else:
        win = torch.zeros(1, 1, 4, 17, 64)
        with pytest.raises(ValueError, match="must match"):
            la.la_static("commit", None, win, torch.zeros(1, 1, 4, 17, 128)[..., :64],
                         torch.zeros(1, 2, 4, 64, 64), torch.zeros(1, 4), torch.tensor([0]),
                         lens=torch.tensor([1]), chain=torch.zeros(1, 17, dtype=torch.int32))


def test_struct_matches_the_kernel_source():
    """``_Static`` lists ``LaStatic``'s fields in its order and types, and
    the module's geometry is the source's constants."""
    body = re.search(r"struct LaStatic \{(.*?)\};", SRC, re.S).group(1)
    fields = []
    for line in body.splitlines():
        line = line.split("//")[0].strip().rstrip(";")
        if not line:
            continue
        kind, names = line.split(None, 1) if not line.startswith("long long") else (
            "long long", line[len("long long"):])
        for name in names.split(","):
            name = name.strip()
            dims = [int(d) for d in re.findall(r"\[(\d+)\]", name)]
            fields.append((name.split("[")[0], kind, dims))
    want = []
    for name, ctype in la._Static._fields_:
        dims = []
        while hasattr(ctype, "_length_"):
            dims.append(ctype._length_)
            ctype = ctype._type_
        want.append((name, "long long" if ctype is ctypes.c_longlong else "int", dims))
    assert fields == want
    consts = {m.group(1): int(m.group(2))
              for m in re.finditer(r"constexpr int (k\w+) = (\d+);", SRC)}
    assert (consts["kTile"], consts["kSlab"], consts["kSplit"], consts["kMaxD"],
            consts["kScanThreads"]) == (la.TILE, la.SLAB, la.READOUT_SPLIT, la.MAX_HEAD_DIM,
                                        la.SCAN_THREADS)
    assert ctypes.sizeof(la._Static) == 192
