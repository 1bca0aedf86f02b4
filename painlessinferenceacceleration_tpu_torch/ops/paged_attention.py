"""Paged attention over the KV arena: kernel wrappers and plain versions.

``paged_attention`` (decode and tree verify under the mask rule, any Q:
a tree verify past 128 rows walks a tile of positions at a time) replaces
the Pallas ``_attn_decode_kernel`` and ``_attn_verify_kernel``;
``paged_attention_prefill`` (causal, Q > 128) replaces
``_attn_prefill_kernel``; ``paged_attention_tok`` (the per-token-scale e4m3
arena, every width) replaces ``_attn_decode_tok_kernel``
(``painlessinferenceacceleration_tpu/ops/paged_attention.py``). All three
launch the one tensor-core kernel of ``csrc/paged_attention.cu`` in one of
its arena modes: bf16; e4m3 with static per-(layer, kv head) scales
(``kv_scales``, the K scale folded into the scores and the V scale into the
output, as the Pallas wrappers fold them into q and the output); e4m3 with
per-token scales. One body for every width and route: a row's bits depend
only on the keys it sees, so a token's attention is the same in a prefill
chunk, a decode step or a verify window.

The arena arguments are one layer's views ``[n_pages, ps, Hkv*D]`` (and
``[n_pages, ps, Hkv]`` for per-token scales) of the stacked arenas, no
copy. A CPU tensor takes the plain version (``ops/attention.py``, which
dequantizes as it gathers); a CUDA tensor launches the kernel or raises:
the kernel takes the (K, V) head dims of ``HEAD_DIMS`` (64 and 128; OPT's
and BLOOM's 80 and 96, served by the 128-lane build; GPT-J's 256;
DeepSeek's expanded MLA, K rows of 192 lanes beside V rows of 128: the V
arena's width says which), pages of 64 keys (its key block) and any whole
G = Hq / Hkv from 1 to 128 (``attention_check``; a tile holds the G heads
of 128 // G positions, its last 128 - G * (128 // G) rows padding). Each
wrapper's ``launches`` counts its kernel launches, ``modes`` counts them
by width kind (decode / verify / prefill) and arena, ``dims`` by head dims
("DKxDV,kind,arena") and ``groups`` by query heads a kv head
("G,kind,arena"). ``attention_plan`` and
``key_blocks`` are the launch plan the kernel follows (its tiles, grid,
heaviest-first order and key walk), kept here so the CPU tests see it.

ALiBi (the bloom / baichuan-13b families) is the optional ``alibi`` [Hq]
fp32 slopes argument of all three: each score gains slope[h] * key position
before the softmax, in every width, route and arena. A committed key's
position is its slot; under the mask rule ``alibi_pos`` [B, Q] gives the
positions of the step's own Q keys (a tree verify's node at ctx + its
depth, whatever its slot; default: their slots, as in decode). The causal
rule takes none: it puts a chunk's key s at ctx + s. The kernel's ALiBi
build is a template of its own, so the slope-free one is unchanged. Its
launches count in ``modes`` under the same keys with ",alibi" added.

Context parallelism (``ops/cp_attention.py``) passes ``paged_attention``
and ``paged_attention_prefill`` a ``page_range`` (lo, hi): only the keys
whose page id lies in [lo, hi) count, and the kernel's RANGED build skips
the other key blocks whole (the bf16 arena without ALiBi); and
``return_lse``: also each row's fp32 log-sum-exp [B, Q, Hq], -inf with an
output of 0 for a row that sees no key. Their launches count under ",range".

AntGLM's prefix-LM prefill passes ``paged_attention_prefill`` (and
``paged_attention_tok`` under the causal rule) a ``window`` [B] int32: key
s of the chunk is also visible to every row where ctx + s < window[b] (JAX
``engine/step.py:75-78``, ``window = glm_ids[:, 0]``), so a chunk of any
width serves it. Its launches count under ",window".
"""

from __future__ import annotations

import collections
import ctypes
from typing import Optional, Tuple

import torch

from painlessinferenceacceleration_tpu_torch import _build
from painlessinferenceacceleration_tpu_torch.ops.attention import (
    causal_qmask,
    paged_attention_ref,
)

TILE_ROWS = 128  # csrc/paged_attention.cu kRows: query rows of a tile
KEY_BLOCK = 64  # kKeys: keys of a block, one page
_MODES = {"bf16": 0, "fp8": 1, "fp8_tok": 2}  # csrc/paged_attention.cu MODE
FP8 = torch.float8_e4m3fn
_ARGS = (ctypes.c_void_p,) * 12 + (ctypes.c_int,) * 9 + (
    ctypes.c_float,) + (ctypes.c_int,) * 4 + (ctypes.c_void_p, ctypes.c_void_p)
ALL_PAGES = (0, 2 ** 31 - 1)  # the page range of a call without one

AttentionPlan = collections.namedtuple("AttentionPlan", "positions n_tiles grid")
# the (K, V) head dims the kernel takes, and the library of each
# (csrc/paged_attention.cu and csrc/paged_attention_wide.cu, one body in
# csrc/paged_attention.cuh, compiled side by side): whole 64-lane boxes, and
# V's accumulator at most 256 lanes (at 256 its 128 fp32 a thread take the
# loader's registers). Rows of 80 and 96 lanes run the (128, 128) build
# with the head's own width (``pa_dispatch`` in csrc/paged_attention.cu):
# Q zero past it, each head's K and V read as two 64-lane boxes from its
# first lane, the lanes past it dropped at the store.
LIBRARY = {(64, 64): "paged_attention", (80, 80): "paged_attention",
           (96, 96): "paged_attention", (128, 128): "paged_attention",
           (256, 256): "paged_attention_wide", (192, 128): "paged_attention_wide"}
HEAD_DIMS = tuple(LIBRARY)


def attention_check(Hq: int, Hkv: int, D: int, ps: int, Dv: Optional[int] = None) -> None:
    """Raise ValueError unless the kernel takes this geometry: K head dim
    ``D`` and V head dim ``Dv`` (default D) one of ``HEAD_DIMS`` (whole
    64-lane TMA boxes and wgmma k steps, or 80 / 96 lanes inside the
    128-lane build; the pairs instantiated), pages of KEY_BLOCK keys (a key
    block is one page, so its TMA boxes are whole pages) and a whole number
    G of query heads per kv head, 1 <= G <= TILE_ROWS (a tile holds the G
    heads of at least one position)."""
    Dv = D if Dv is None else Dv
    if (D, Dv) not in HEAD_DIMS:
        why = ("rows of whole 64-lane boxes, or 80 / 96 lanes in the 128-lane build"
               if D % 64 or Dv % 64 else
               "an instantiation for it" if Dv <= 256 else "an accumulator of at most 256 lanes")
        raise ValueError(f"paged attention takes the head dims {HEAD_DIMS} (K, V), not "
                         f"({D}, {Dv}): it needs {why}")
    if ps != KEY_BLOCK:
        raise ValueError(f"paged attention on the card takes pages of {KEY_BLOCK} keys, "
                         f"not {ps}")
    if Hkv <= 0 or Hq % Hkv:
        raise ValueError(f"paged attention needs a whole number of query heads a kv head "
                         f"(Hq={Hq}, Hkv={Hkv})")
    if not 1 <= Hq // Hkv <= TILE_ROWS:
        raise ValueError(f"paged attention takes 1 to {TILE_ROWS} query heads a kv head "
                         f"(a tile holds the heads of one position), not {Hq // Hkv} "
                         f"(Hq={Hq}, Hkv={Hkv})")


def attention_plan(B: int, Q: int, Hq: int, Hkv: int) -> AttentionPlan:
    """The launch: tiles of TILE_ROWS rows, ``positions`` = TILE_ROWS // G
    query positions a tile (row r -> head h * G + r / nt, position t0 +
    r % nt, nt = min(positions, Q - t0); rows past G * nt are padding),
    grid (Hkv, B, n_tiles)."""
    if B < 1 or Q < 1:
        raise ValueError(f"paged attention needs B, Q >= 1 (B={B}, Q={Q})")
    if B > 65535:
        raise ValueError(f"paged attention takes at most 65535 requests, not {B}")
    positions = TILE_ROWS // (Hq // Hkv)
    n_tiles = -(-Q // positions)
    return AttentionPlan(positions, n_tiles, (Hkv, B, n_tiles))


def tile_of(z: int, n_tiles: int, causal: bool) -> int:
    """The query tile block z of the grid takes: under the causal rule the
    heaviest (last) first, so that the longest key walks start first."""
    return n_tiles - 1 - z if causal else z


def key_blocks(ctx: int, Q: int, t0: int, nt: int, causal: bool, P: int,
               window: int = 0) -> int:
    """Key blocks a tile of positions [t0, t0 + nt) walks, from key 0 up
    to its last visible key (bounded by the P pages of its page table):
    under the causal rule the later of its last row's key and the prefix-LM
    ``window``'s last key inside the chunk."""
    if causal:
        last = max(ctx + t0 + nt - 1, min(window, ctx + Q) - 1)
    else:
        last = ctx + Q - 1
    return min(last // KEY_BLOCK + 1, P)


def _check_scales(arena: str, k_pages, k_scale, v_scale, Hkv: int) -> None:
    if arena == "bf16":
        return
    n_pages, ps = k_pages.shape[:2]
    want = (Hkv,) if arena == "fp8" else (n_pages, ps, Hkv)
    for s in (k_scale, v_scale):
        if s is None or s.dtype != torch.float32 or tuple(s.shape) != want:
            raise ValueError(f"{arena} arena needs f32 scales of shape {want}")
        if not s.is_contiguous() or s.device != k_pages.device:
            raise ValueError("the scales must be contiguous, on the arena's device")


def _check_alibi(alibi, alibi_pos, causal: bool, B: int, Q: int, Hq: int, dev) -> None:
    if alibi is None:
        if alibi_pos is not None:
            raise ValueError("alibi_pos without alibi slopes")
        return
    if alibi.dtype != torch.float32 or tuple(alibi.shape) != (Hq,) \
            or not alibi.is_contiguous() or alibi.device != dev:
        raise ValueError(f"alibi must be contiguous f32 slopes [{Hq}] on {dev}")
    if alibi_pos is not None and causal:
        raise ValueError("the causal rule takes no alibi_pos: its key s is at ctx + s")
    if alibi_pos is not None and (alibi_pos.dtype != torch.int32
                                  or tuple(alibi_pos.shape) != (B, Q)
                                  or not alibi_pos.is_contiguous()
                                  or alibi_pos.device != dev):
        raise ValueError(f"alibi_pos must be contiguous int32 positions [{B}, {Q}] on {dev}")


def window_qmask(B: int, Q: int, ctx_lens: torch.Tensor, window: Optional[torch.Tensor],
                 device) -> torch.Tensor:
    """The in-step mask [B, Q, Q] of the causal rule, with the prefix-LM
    ``window`` [B] (or None): key s is visible to row t iff s <= t or ctx +
    s < window[b] (JAX ``engine/step.py:75-78``)."""
    qmask = causal_qmask(Q, device)[None].expand(B, Q, Q)
    if window is None:
        return qmask
    s = torch.arange(Q, device=device)
    pos = ctx_lens.to(device=device, dtype=torch.int64)[:, None] + s[None]
    return qmask | (pos < window.to(device=device, dtype=torch.int64)[:, None])[:, None, :]


def _check_window(window, causal: bool, B: int, dev) -> None:
    if window is None:
        return
    if not causal:
        raise ValueError("a prefix-LM window goes with the causal rule")
    if window.dtype != torch.int32 or tuple(window.shape) != (B,) \
            or not window.is_contiguous() or window.device != dev:
        raise ValueError(f"window must be contiguous int32 [{B}] on {dev}")


def _launch(wrapper, q, k_pages, v_pages, page_tables, ctx_lens, qmask, scale,
            causal: bool, arena: str, k_scale=None, v_scale=None, alibi=None,
            alibi_pos=None, page_range=None, return_lse=False, window=None):
    B, Q, Hq, D = q.shape
    n_pages, ps, HD = k_pages.shape
    Hkv = HD // D
    Dv = v_pages.shape[-1] // Hkv
    if HD % D or v_pages.shape[-1] % Hkv or tuple(v_pages.shape[:2]) != (n_pages, ps):
        raise ValueError(f"arenas {tuple(k_pages.shape)} / {tuple(v_pages.shape)} do not "
                         f"hold whole heads of q's {D} lanes")
    P = page_tables.shape[1]
    kv_dtype = torch.bfloat16 if arena == "bf16" else FP8
    if q.dtype != torch.bfloat16 or k_pages.dtype != kv_dtype \
            or v_pages.dtype != kv_dtype:
        raise TypeError(f"paged_attention ({arena}) takes bf16 q and a "
                        f"{kv_dtype} arena, not {q.dtype}/{k_pages.dtype}")
    attention_check(Hq, Hkv, D, ps, Dv)
    plan = attention_plan(B, Q, Hq, Hkv)
    if not (k_pages.is_contiguous() and v_pages.is_contiguous()):
        raise ValueError("the arena views must be contiguous")
    dev = q.device
    for t in (k_pages, v_pages, page_tables, ctx_lens):
        if t.device != dev:
            raise ValueError("paged_attention operands must be on one device")
    _check_scales(arena, k_pages, k_scale, v_scale, Hkv)
    _check_alibi(alibi, alibi_pos, causal, B, Q, Hq, dev)
    _check_window(window, causal, B, dev)
    q = q.contiguous()
    pt = page_tables.to(torch.int32).contiguous()
    cl = ctx_lens.to(torch.int32).contiguous()
    qm = None if causal else qmask.to(torch.uint8).contiguous()
    out = torch.empty((B, Q, Hq, Dv), dtype=q.dtype, device=dev)
    lo, hi = ALL_PAGES if page_range is None else page_range
    if page_range is not None:
        if not 0 <= lo <= hi < ALL_PAGES[1]:
            raise ValueError(f"page range [{lo}, {hi})")
        if arena != "bf16" or alibi is not None:
            raise ValueError("a page range takes the bf16 arena without ALiBi (context "
                             "parallelism refuses the others)")
    lse = torch.empty((B, Q, Hq), dtype=torch.float32, device=dev) if return_lse else None
    lib, fn = _build.function(LIBRARY[(D, Dv)], "paged_attention", _ARGS)
    err = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
             pt.data_ptr(), cl.data_ptr(), _build.ptr(qm), _build.ptr(k_scale),
             _build.ptr(v_scale), _build.ptr(alibi), _build.ptr(alibi_pos),
             _build.ptr(window), out.data_ptr(), B, Q, Hq, Hkv, D, Dv, n_pages, P,
             plan.positions, float(scale), int(causal), _MODES[arena], int(lo), int(hi),
             _build.ptr(lse), _build.stream_of(q))
    _build.check(lib, err, "paged_attention")
    wrapper.launches += 1
    kind = "decode" if Q == 1 else ("prefill" if causal else "verify")
    wrapper.modes[f"{kind},{arena}" + (",alibi" if alibi is not None else "")
                  + (",range" if page_range is not None else "")
                  + (",window" if window is not None else "")] += 1
    wrapper.dims[f"{D}x{Dv},{kind},{arena}"] += 1
    wrapper.groups[f"{Hq // Hkv},{kind},{arena}"] += 1
    return (out, lse) if return_lse else out


def _arena_of(k_pages, kv_scales) -> Tuple[str, Optional[torch.Tensor], Optional[torch.Tensor]]:
    if k_pages.dtype != FP8:
        return "bf16", None, None
    if kv_scales is None:
        raise ValueError("an e4m3 arena needs kv_scales=(k_scale, v_scale)")
    return "fp8", kv_scales[0], kv_scales[1]


def _plain_only(q, what):
    if q.device.type != "cpu":
        raise NotImplementedError(f"{what} on {q.device}")


def paged_attention(q: torch.Tensor, k_pages: torch.Tensor,
                    v_pages: torch.Tensor, page_tables: torch.Tensor,
                    ctx_lens: torch.Tensor, qmask: torch.Tensor,
                    scale: float, kv_scales=None,
                    alibi: Optional[torch.Tensor] = None,
                    alibi_pos: Optional[torch.Tensor] = None,
                    page_range: Optional[Tuple[int, int]] = None,
                    return_lse: bool = False):
    """Decode / tree-verify attention under the mask rule, q [B, Q, Hq, D]
    at any Q (past 128 rows a tree verify takes several tiles, each walking
    the keys up to the step's last).

    K/V of the Q in-step tokens must already be written at ctx..ctx+Q-1.
    ``kv_scales`` = (k_scale [Hkv], v_scale [Hkv]) for a static e4m3 arena;
    ``alibi`` the [Hq] ALiBi slopes, ``alibi_pos`` [B, Q] int32 the in-step
    keys' positions. ``page_range`` (lo, hi): only the keys whose page id
    lies in [lo, hi) count (a context-parallel rank's pages); the kernel
    skips the other key blocks whole. ``return_lse``: also each row's fp32
    log-sum-exp [B, Q, Hq] of its scaled scores, -inf (and output 0) for a
    row that sees no key."""
    if q.is_cuda:
        arena, ks, vs = _arena_of(k_pages, kv_scales)
        return _launch(paged_attention, q, k_pages, v_pages, page_tables,
                       ctx_lens, qmask, scale, False, arena, ks, vs, alibi, alibi_pos,
                       page_range, return_lse)
    _plain_only(q, "paged_attention")
    ks, vs = kv_scales if kv_scales is not None else (None, None)
    return paged_attention_ref(q, k_pages, v_pages, page_tables, ctx_lens,
                               qmask, scale, ks, vs, alibi=alibi, alibi_pos=alibi_pos,
                               page_range=page_range, return_lse=return_lse)


def paged_attention_prefill(q: torch.Tensor, k_pages: torch.Tensor,
                            v_pages: torch.Tensor, page_tables: torch.Tensor,
                            ctx_lens: torch.Tensor, scale: float,
                            kv_scales=None,
                            alibi: Optional[torch.Tensor] = None,
                            page_range: Optional[Tuple[int, int]] = None,
                            return_lse: bool = False,
                            window: Optional[torch.Tensor] = None):
    """Causal chunk attention over K/V already written at ctx..ctx+Q-1.

    Rows past a request's valid tokens give finite values that callers
    discard, as in the JAX package. ``page_range`` and ``return_lse`` as
    in ``paged_attention``; ``window`` [B] int32, AntGLM's prefix-LM window:
    key s of the chunk is also visible to every row where ctx + s <
    window[b]."""
    if q.is_cuda:
        arena, ks, vs = _arena_of(k_pages, kv_scales)
        return _launch(paged_attention_prefill, q, k_pages, v_pages,
                       page_tables, ctx_lens, None, scale, True, arena, ks, vs, alibi,
                       None, page_range, return_lse, window)
    _plain_only(q, "paged_attention_prefill")
    qmask = window_qmask(q.shape[0], q.shape[1], ctx_lens, window, q.device)
    ks, vs = kv_scales if kv_scales is not None else (None, None)
    return paged_attention_ref(q, k_pages, v_pages, page_tables, ctx_lens,
                               qmask, scale, ks, vs, alibi=alibi, page_range=page_range,
                               return_lse=return_lse)


def paged_attention_tok(q: torch.Tensor, k_pages: torch.Tensor,
                        v_pages: torch.Tensor, ks_pages: torch.Tensor,
                        vs_pages: torch.Tensor, page_tables: torch.Tensor,
                        ctx_lens: torch.Tensor, scale: float,
                        qmask: Optional[torch.Tensor] = None,
                        alibi: Optional[torch.Tensor] = None,
                        alibi_pos: Optional[torch.Tensor] = None,
                        window: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Attention over a per-token-scale e4m3 arena (``kv_quant='fp8_tok'``)
    at any width: ``qmask`` [B, Q, Q] for decode / verify, None for the
    causal rule (prefill, which takes no ``alibi_pos`` and may take the
    prefix-LM ``window``). ks_pages/vs_pages [n_pages, ps, Hkv] f32."""
    if qmask is None and alibi_pos is not None:
        raise ValueError("the causal rule takes no alibi_pos: its key s is at ctx + s")
    if q.is_cuda:
        return _launch(paged_attention_tok, q, k_pages, v_pages, page_tables,
                       ctx_lens, qmask, scale, qmask is None, "fp8_tok", ks_pages,
                       vs_pages, alibi, alibi_pos, window=window)
    _plain_only(q, "paged_attention_tok")
    if qmask is None:
        qmask = window_qmask(q.shape[0], q.shape[1], ctx_lens, window, q.device)
    elif window is not None:
        raise ValueError("a prefix-LM window goes with the causal rule")
    return paged_attention_ref(q, k_pages, v_pages, page_tables, ctx_lens,
                               qmask, scale, ks_pages, vs_pages, alibi=alibi,
                               alibi_pos=alibi_pos)


for _w in (paged_attention, paged_attention_prefill, paged_attention_tok):
    _w.launches = 0
    _w.modes = collections.Counter()
    _w.dims = collections.Counter()
    _w.groups = collections.Counter()


# Registers of the slope-free instantiations without the page range at the
# head dims of before, (K head dim, V head dim, arena) -> count, as nvcc 12.9
# builds them for sm_90a. The log-sum-exp epilogue changed them (the build
# before it: 146 / 130 / 135 at D = 64, 167 / 168 / 168 at D = 128), and the
# (K, V) template with the prefix-LM window's compare again at D = 64 (138 /
# 127 / 127 before it), with no spills before or after; one block an SM
# whatever the count (the launch bound), so none of these moves the
# occupancy. The page-range flag is a template flag of its own and the ALiBi
# flag a separate instantiation, so neither changes these counts. (The pairs
# of HEAD_DIMS added with the window are held to no spills only.)
SLOPE_FREE_REGISTERS = {(64, 64, "fp8_tok"): 148, (64, 64, "fp8"): 128,
                        (64, 64, "bf16"): 127, (128, 128, "fp8_tok"): 167,
                        (128, 128, "fp8"): 167, (128, 128, "bf16"): 167}


def ptxas_registers(ranged: bool = False) -> dict:
    """(K head dim, V head dim, arena, alibi) -> {"registers": n,
    "spills": bytes} of each instantiation of the kernel without the page
    range (``ranged``: with it, the bf16 arena without ALiBi only), from
    ptxas's report of its build (built here if it is not yet)."""
    import re

    seen, cur = {}, None
    for name in sorted(set(LIBRARY.values())):
        _build.library(name)
    report = "\n".join(_build.ptxas_report(name) for name in sorted(set(LIBRARY.values())))
    for line in report.splitlines():
        if "Compiling entry function" in line:
            m = re.search(r"paged_attention_wgmma_kernelILi(\d+)ELi(\d+)ELi(\d)ELb([01])"
                          r"ELb([01])E", line)
            cur = None
            if m and (m.group(5) == "1") == ranged:
                cur = (int(m.group(1)), int(m.group(2)), tuple(_MODES)[int(m.group(3))],
                       m.group(4) == "1")
                seen[cur] = {"spills": 0}
        if cur is None:
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m:
            seen[cur]["registers"] = int(m.group(1))
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            seen[cur]["spills"] += int(m.group(1)) + int(m.group(2))
    return seen
