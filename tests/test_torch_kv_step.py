"""K16's step entry (``kv_write_step``) on the CPU: its shape rule, its
once-a-shape launch struct, and the rule by which its kernel picks the
rows it writes.

The kernel (``csrc/kv_rows.cu``) runs only on the card, where it takes the
step's K/V, page tables, start lengths and valid mask as the models pass
them. What it is given is decided here, in Python the wrapper calls:
``step_static`` checks the operands and fills the struct of the launch's
fixed fields, for every model configuration and arena kind of the port.
Which rows the kernel writes is replayed in plain Python (``step_writes``):
applied in any order, those rows must leave the arenas as the eager route
(``kv_write_step_plain``, the CPU path of ``write_kv_pages``) leaves them,
outside the null page 0, also past the end of a page table, where the
clamped page index makes two tokens name one row and the later one wins.
"""

import ctypes

import numpy as np
import pytest
import torch

from painlessinferenceacceleration_tpu_torch.config import ModelConfig
from painlessinferenceacceleration_tpu_torch.engine.cache import write_kv_pages
from painlessinferenceacceleration_tpu_torch.models.mla import (
    mla_cache_heads,
    mla_head_dims,
)
from painlessinferenceacceleration_tpu_torch.ops.kv_update import (
    FP8,
    STEP_MODES,
    kv_step_rows,
    kv_write_step,
    kv_write_step_plain,
    step_static,
    step_writes,
)

CONFIGS = {"llama2_7b": ModelConfig.llama2_7b(), "mixtral_8x7b": ModelConfig.mixtral_8x7b(),
           "deepseek_v2_lite": ModelConfig.deepseek_v2_lite(),
           "ring_mini_linear_2": ModelConfig.ring_mini_linear_2(),
           "mla_3b": ModelConfig.mla_3b(), "tiny": ModelConfig.tiny()}


def _kinds(cfg):
    """The arena kinds a model of ``cfg`` holds (an MLA or hybrid arena is
    in the model's type only)."""
    return ("none",) if cfg.is_mla or cfg.linear_attention else ("none", "fp8", "fp8_tok")


CASES = [(name, kind) for name in sorted(CONFIGS) for kind in _kinds(CONFIGS[name])]


def _step(cfg, kind, B=2, Q=3, L=2, n_pages=5, ps=16, dtype=torch.bfloat16, idx=torch.int32):
    """Arenas of ``kind`` at ``cfg``'s row widths and a step's tensors as
    ``models/base.py`` (K after rope, V a view of the fused projection) and
    ``models/mla.py`` (the latent K row and c_kv) pass them."""
    g = torch.Generator().manual_seed(0)
    if cfg.is_mla:
        H, (D, Dv) = mla_cache_heads(cfg), mla_head_dims(cfg)
        r = cfg.kv_lora_rank
        kva = torch.randn(B, Q, D, generator=g).to(dtype)  # [c_kv | k_pe]
        nk = kva[:, :, None, :].contiguous()
        nv = kva[:, :, None, :r]
    else:
        H, D = cfg.num_key_value_heads, cfg.head_dim
        Dv = D
        qkv = torch.randn(B, Q, (cfg.num_attention_heads + 2 * H) * D, generator=g).to(dtype)
        nk = qkv[..., cfg.num_attention_heads * D:][..., : H * D].reshape(B, Q, H, D).clone()
        nv = qkv[..., (cfg.num_attention_heads + H) * D:].reshape(B, Q, H, Dv)
    fp8 = kind != "none"
    arenas = tuple(torch.zeros(L, n_pages, ps, H * w, dtype=FP8 if fp8 else dtype)
                   for w in (D, Dv))
    ks = vs = None
    if kind == "fp8_tok":
        arenas += tuple(torch.zeros(L, n_pages, ps, H) for _ in range(2))
    elif kind == "fp8":
        ks, vs = torch.full((H,), 0.01), torch.full((H,), 0.02)
    pt = torch.arange(1, 1 + B * 2, dtype=idx).reshape(B, 2)
    start = torch.tensor([3, 17][:B], dtype=idx)
    valid = torch.ones(B, Q, dtype=torch.bool)
    valid[-1, -1] = False
    return arenas, nk, nv, pt, start, valid, ks, vs


@pytest.mark.parametrize("name,kind", CASES)
def test_step_struct_for_every_model_and_arena(name, kind):
    cfg = CONFIGS[name]
    arenas, nk, nv, pt, start, valid, ks, vs = _step(cfg, kind)
    st, addr, L = step_static(arenas, nk, nv, pt, start, valid, ks, vs)
    assert addr == ctypes.addressof(st) and L == arenas[0].shape[0]
    B, Q, H, D = nk.shape
    assert (st.B, st.Q, st.H, st.D, st.Dv) == (B, Q, H, D, nv.shape[-1])
    assert tuple(st.k_stride) == nk.stride()[:3] and tuple(st.v_stride) == nv.stride()[:3]
    assert (st.P, st.ps, st.n_pages, st.L) == (pt.shape[1], 16, 5, 2)
    assert (st.pt_stride, st.valid_stride) == (pt.stride(0), valid.stride(0))
    assert (st.pt_wide, st.start_wide, st.in_f32) == (0, 0, 0)
    assert STEP_MODES[st.mode] == {"none": "bf16"}.get(kind, kind)
    # the eager route writes every valid token's rows where step_writes says
    out = kv_write_step(tuple(a.clone() for a in arenas), nk, nv, pt, start, valid, 1, ks, vs)
    written = step_writes(pt, start, valid, Q, 16)
    assert len(written) == int(valid.sum())
    for b, q, page, row in written:
        assert out[0][1, page, row].view(torch.uint8).any()


@pytest.mark.parametrize("dtype,idx", [(torch.float32, torch.int64),
                                       (torch.bfloat16, torch.int64)])
def test_step_struct_takes_fp32_rows_and_int64_indices(dtype, idx):
    arenas, nk, nv, pt, start, valid, ks, vs = _step(CONFIGS["tiny"], "none", dtype=dtype,
                                                     idx=idx)
    st = step_static(arenas, nk, nv, pt, start, None, ks, vs)[0]
    assert (st.pt_wide, st.start_wide, st.valid_stride) == (1, 1, 0)
    assert st.in_f32 == int(dtype == torch.float32)
    assert STEP_MODES[st.mode] == ("fp32" if dtype == torch.float32 else "bf16")


def _refused(arenas, nk, nv, pt, start, valid, ks, vs):
    with pytest.raises(ValueError, match="kv_write_step"):
        step_static(arenas, nk, nv, pt, start, valid, ks, vs)


def test_step_refuses_strides_and_layouts_it_does_not_take():
    cfg = CONFIGS["llama2_7b"]
    arenas, nk, nv, pt, start, valid, ks, vs = _step(cfg, "none")
    ok = (arenas, nk, nv, pt, start, valid, ks, vs)
    step_static(*ok)
    B, Q, H, D = nk.shape
    # the last axis strided (heads' lanes interleaved)
    _refused(arenas, nk.transpose(2, 3).contiguous().transpose(2, 3), nv, pt, start, valid,
             ks, vs)
    _refused(arenas, nk, nv[..., ::2], pt, start, valid, ks, vs)  # V's lanes strided
    # D off the 8-lane groups (and rows that no longer fit the arena)
    t = _step(CONFIGS["tiny"], "none")
    _refused(tuple(a[..., :12 * 2] for a in t[0]), t[1][..., :12], t[2][..., :12], *t[3:])
    _refused(arenas, nk.float(), nv, pt, start, valid, ks, vs)  # K and V of two types
    _refused(arenas, nk.half(), nv.half(), pt, start, valid, ks, vs)  # fp16 rows
    _refused(arenas, nk, nv, pt.to(torch.int16), start, valid, ks, vs)  # index type
    _refused(arenas, nk, nv, pt.t().contiguous().t(), start, valid, ks, vs)  # pt columns
    _refused(arenas, nk, nv, pt, start, valid.t().contiguous().t(), ks, vs)  # valid strided
    _refused(arenas, nk, nv, pt, start, valid.int(), ks, vs)  # valid not bool
    _refused(arenas, nk, nv, pt[:1], start, valid, ks, vs)  # one page-table row short
    _refused((arenas[0].transpose(1, 2), arenas[1]), nk, nv, pt, start, valid, ks, vs)
    _refused(arenas[:1], nk, nv, pt, start, valid, ks, vs)  # K alone
    _refused(arenas, nk, nv, pt, start, valid, torch.ones(H), torch.ones(H))  # bf16 + scales
    e4m3 = _step(cfg, "fp8")
    _refused(*e4m3[:6], None, None)  # a static e4m3 arena without its scales
    _refused(*e4m3[:6], e4m3[6][:-1], e4m3[7])  # scales of one head short
    tok = _step(cfg, "fp8_tok")
    _refused(tok[0][:3] + (tok[0][3][..., :-1],), *tok[1:])  # a scale arena of H - 1
    # more heads than the kernel's amax table
    wide = tuple(torch.zeros(1, 2, 16, 300 * 8, dtype=torch.bfloat16) for _ in range(2))
    rows = torch.zeros(1, 1, 300, 8, dtype=torch.bfloat16)
    _refused(wide, rows, rows, pt[:1], start[:1], None, None, None)


def _eager_and_replayed(B, Q, P, ps, start, valid, kind="none", seed=0):
    """The eager route's arenas and the arenas with only ``step_writes``'
    rows written (in reverse order), from the same zeroed arenas."""
    g = torch.Generator().manual_seed(seed)
    H, D = 2, 8
    nk = torch.randn(B, Q, H, D, generator=g).to(torch.bfloat16)
    nv = torch.randn(B, Q, H, D, generator=g).to(torch.bfloat16)
    n_pages = B * P + 1
    dt = FP8 if kind != "none" else torch.bfloat16
    arenas = tuple(torch.zeros(2, n_pages, ps, H * D, dtype=dt) for _ in range(2))
    ks = vs = None
    if kind == "fp8_tok":
        arenas += tuple(torch.zeros(2, n_pages, ps, H) for _ in range(2))
    elif kind == "fp8":
        ks, vs = torch.full((H,), 0.003), torch.full((H,), 0.005)
    pt = (torch.randperm(B * P, generator=g) + 1).reshape(B, P).to(torch.int32)
    start = torch.tensor(start, dtype=torch.int32)
    valid = None if valid is None else torch.tensor(valid, dtype=torch.bool)
    eager = kv_write_step_plain(tuple(a.clone() for a in arenas), nk, nv, pt, start, valid,
                                1, ks, vs)
    rows, _, _ = kv_step_rows(arenas, nk, nv, pt, start, valid, ks, vs)
    replay = tuple(a.clone() for a in arenas)
    written = step_writes(pt, start, valid, Q, ps)
    for b, q, page, row in reversed(written):
        for a, r in zip(replay, rows):
            a.view(torch.uint8)[1, page, row] = r.view(torch.uint8)[b * Q + q]
    return eager, replay, written


@pytest.mark.parametrize("kind", ["none", "fp8", "fp8_tok"])
def test_step_writes_give_the_eager_bytes_past_the_end_of_a_page_table(kind):
    """Request 0 starts at slot 1 of its two pages of 4 and runs 9 slots
    past their end (page index clamped to the last): from slot 4 on, slots
    1 + q and 1 + q + 4 k name one row, the later valid token wins; request
    1 stays inside its table."""
    B, Q, P, ps = 2, 16, 2, 4
    valid = np.ones((B, Q), bool)
    valid[0, 15] = False  # the last token of a row of three invalid: 11 wins
    valid[1, 8:] = False
    eager, replay, written = _eager_and_replayed(B, Q, P, ps, [1, 0], valid.tolist(), kind)
    for a, b in zip(eager, replay):
        assert torch.equal(a[:, 1:].view(torch.uint8), b[:, 1:].view(torch.uint8))
    mine = sorted(q for b, q, _, _ in written if b == 0)
    # slots 1-3 on the first page; 4-16 on the last: its rows 1-3 from q =
    # 12-14, row 0 from q = 11 (q = 15 is invalid)
    assert mine == [0, 1, 2, 11, 12, 13, 14]
    assert sorted(q for b, q, _, _ in written if b == 1) == list(range(8))


@pytest.mark.parametrize("seed", range(4))
def test_step_writes_match_the_eager_route_on_random_steps(seed):
    rng = np.random.default_rng(seed)
    B, Q, P, ps = 3, 20, 3, 8
    start = rng.integers(0, P * ps, B).tolist()
    valid = rng.random((B, Q)) < 0.7
    eager, replay, written = _eager_and_replayed(B, Q, P, ps, start, valid.tolist(),
                                                 seed=seed)
    for a, b in zip(eager, replay):
        assert torch.equal(a[:, 1:].view(torch.uint8), b[:, 1:].view(torch.uint8))
    keys = [(p, r) for _, _, p, r in written]
    assert len(keys) == len(set(keys))  # no two writes name one row


def test_write_kv_pages_on_the_cpu_is_the_eager_route():
    arenas, nk, nv, pt, start, valid, ks, vs = _step(CONFIGS["tiny"], "fp8_tok")
    a = write_kv_pages(*(t.clone() for t in arenas[:2]), nk, nv, pt, start, valid, 1, None,
                       None, *(t.clone() for t in arenas[2:]))
    b = kv_write_step_plain(tuple(t.clone() for t in arenas), nk, nv, pt, start, valid, 1)
    assert len(a) == 4
    for x, y in zip(a, b):
        assert torch.equal(x.view(torch.uint8), y.view(torch.uint8))
