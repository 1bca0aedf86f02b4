"""Decayed linear attention: the wrappers of ``csrc/linear_attention.cu``
(K14) and their plain versions, in four modes.

Per (batch row, head) with decay ``lam = exp(loglam[h])`` and a recurrent
state ``S`` [D, D] kept per engine slot (all fp32, the JAX package's
``[B, H, C, D]`` layouts at the public functions):

- ``linear_attention_chunk`` (the chunked prefill; replaces the Pallas
  ``_la_kernel`` of ``painlessinferenceacceleration_tpu/ops/
  linear_attention.py``): the chunkwise form over ``chunk_lens[b]`` valid
  tokens, walked in sub-tiles of ``TILE`` tokens that carry the state;
- ``linear_attention_decode`` (AR decode, Q = 1): one per-token step and
  its readout, written back to the slot;
- ``linear_attention_tree`` (lookahead verify; replaces ``_la_tree_kernel``):
  the same step walked from the committed state down each node's ancestor
  path, every node read out, no state written;
- ``linear_attention_commit`` (the JAX package does it in jnp,
  ``models/linear_attn.py`` ``commit_linear_states``): the accepted chain
  replayed into each slot's state with the same step.

The per-token step is ``S <- lam * S + k (x) v`` (two products and a sum,
each rounded) and the readout ``out = sum_d q[d] * S[d, :]`` in one fixed
order (``la_readout``: ``READOUT_SPLIT`` ranges of d, each summed in
ascending d, then the partials added in a fixed pairwise tree). Decode,
verify and commit share them, so a verified row has the bits of the AR row
at its position and the committed state the bits of AR's steps (the JAX
package's closed forms agree with it only in exact arithmetic). The plain
versions repeat that arithmetic operation for operation, so on the card a
recurrent mode equals its plain version bit for bit, and on the CPU
lookahead equals AR too. Chunk mode's products run in 3xTF32 on the card,
within 1e-5 of its plain version; a row's bits there depend on its own
tokens only.

The state argument is either the JAX-shaped ``[B, H, D, D]`` (row b is
state b) or, with ``slot_ids`` [B], one layer's slot arena ``[slots, H, D,
D]`` (row b is state ``slot_ids[b]``); chunk and decode update it in place.
Rows with nothing to do (``chunk_lens`` 0, an invalid decode row, a commit
of 0) leave their state alone, so padding rows may alias a real row's slot.
Outputs of padded, dead or inactive rows are 0.

On a CUDA tensor each wrapper launches K14 or raises; on a CPU tensor it
takes its plain version. A launch reads ``loglam``, ``valid`` (bool) and
the indices (int32 or int64) as they come and writes every output element,
through a ctypes struct of its fixed fields built once a shape
(``la_static``): one CUDA kernel a call, three in chunk mode (the tiles'
increments, the carry over the tiles, the outputs; a workspace from
``_build.scratch``). ``la_plan`` gives each launch's grid and shared
memory and holds the shape rule. Each wrapper's ``launches`` counts its
K14 calls.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import torch

from painlessinferenceacceleration_tpu_torch import _build

# csrc/linear_attention.cu's constants (tests/test_torch_la_plan.py holds
# them against the source)
TILE = 64  # chunk mode's sub-tile (kTile)
SLAB = 16  # value columns a block of the recurrent modes (kSlab)
READOUT_SPLIT = 8  # the readout's d-ranges (kSplit)
MAX_HEAD_DIM = 128  # a thread holds D / READOUT_SPLIT state elements (kMaxD)
SCAN_THREADS = 256  # chunk pass 2, 4 state elements a thread (kScanThreads)
SMEM_LIMIT = 232448  # the H100's dynamic shared memory a block
MAX_GRID_YZ = 65535


def decay_of(loglam: torch.Tensor) -> torch.Tensor:
    """The per-head decay the recurrent modes multiply by: one conversion,
    shared by decode, verify and commit (the kernel's ``expf``)."""
    return torch.exp(loglam.to(torch.float32))


def _slots(state: torch.Tensor, slot_ids: Optional[torch.Tensor], B: int) -> torch.Tensor:
    if slot_ids is None:
        if state.shape[0] != B:
            raise ValueError(f"state {tuple(state.shape)} is not [B={B}, H, D, D]")
        return torch.arange(B, device=state.device)
    return slot_ids.long()


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def la_step(S: torch.Tensor, lam: torch.Tensor, k: torch.Tensor,
            v: torch.Tensor) -> torch.Tensor:
    """``lam * S + k (x) v``: S [..., H, D, D], lam [H], k, v [..., H, D]."""
    return lam[:, None, None] * S + k[..., :, None] * v[..., None, :]


def la_readout(q: torch.Tensor, S: torch.Tensor) -> torch.Tensor:
    """``sum_d q[d] * S[d, :]`` in the kernel's order (a matmul's order
    depends on its shape): d cut into ``READOUT_SPLIT`` ranges of
    ceil(D / READOUT_SPLIT) (zeros past D), each summed in ascending d with
    a rounded product and sum each, then the partials added in a fixed
    pairwise tree, range r and r + half for half = 4, 2, 1."""
    D, E = S.shape[-2], S.shape[-1]
    rl = -(-D // READOUT_SPLIT)
    pad = READOUT_SPLIT * rl - D
    qp = torch.nn.functional.pad(q, (0, pad)).reshape(*q.shape[:-1], READOUT_SPLIT, rl)
    Sp = torch.nn.functional.pad(S, (0, 0, 0, pad)).reshape(*S.shape[:-2], READOUT_SPLIT,
                                                            rl, E)
    acc = torch.zeros(S.shape[:-2] + (READOUT_SPLIT, E), dtype=S.dtype, device=S.device)
    for j in range(rl):
        acc = acc + qp[..., j, None] * Sp[..., j, :]
    width = READOUT_SPLIT
    while width > 1:
        width //= 2
        acc = acc[..., :width, :] + acc[..., width:, :]
    return acc[..., 0, :]


def linear_attention_chunk_plain(xq, xk, xv, state, chunk_lens, loglam, slot_ids=None):
    """Chunk mode, one row at a time (a row's bits depend on its own tokens
    only), in sub-tiles of ``TILE`` tokens."""
    B, H, C, D = xq.shape
    sid = _slots(state, slot_ids, B)
    out = torch.zeros_like(xq)
    ll = loglam.to(torch.float32)
    pd = torch.exp(ll[:, None] * torch.arange(TILE + 1, device=xq.device,
                                              dtype=torch.float32)[None, :])  # [H, T+1]
    for b, n_tot in enumerate(chunk_lens.tolist()):
        if n_tot <= 0:
            continue
        S = state[sid[b]].to(torch.float32)
        for t0 in range(0, n_tot, TILE):
            n = min(TILE, n_tot - t0)
            q, k, v = (x[b, :, t0:t0 + n] for x in (xq, xk, xv))  # [H, n, D]
            i = torch.arange(n, device=xq.device)
            causal = i[:, None] >= i[None, :]
            A = torch.matmul(q, k.transpose(-1, -2)) * pd[:, (i[:, None] - i[None, :]).clamp(min=0)]
            A = torch.where(causal, A, torch.zeros_like(A))
            o = torch.matmul(A, v) + pd[:, i + 1][..., None] * torch.matmul(q, S)
            out[b, :, t0:t0 + n] = o
            kw = k * pd[:, n - 1 - i][..., None]
            S = pd[:, n][:, None, None] * S + torch.matmul(kw.transpose(-1, -2), v)
        state[sid[b]] = S.to(state.dtype)
    return out, state


def linear_attention_decode_plain(xq, xk, xv, state, valid, loglam, slot_ids=None):
    """One step per valid row (xq, xk, xv [B, H, 1, D], valid [B, 1])."""
    B = xq.shape[0]
    sid = _slots(state, slot_ids, B)
    lam = decay_of(loglam)
    S = la_step(state[sid], lam, xk[:, :, 0], xv[:, :, 0])
    ok = valid[:, 0].to(torch.bool)
    out = torch.where(ok[:, None, None], la_readout(xq[:, :, 0], S), 0.0)[:, :, None]
    keep = torch.where(ok[:, None, None, None], S, state[sid])
    state[sid[ok]] = keep[ok]
    return out, state


def linear_attention_tree_plain(xq, xk, xv, state, parents, valid, loglam, slot_ids=None):
    """Every node's state, each from its parent's (the root's from the
    committed state), then every live node read out."""
    B, H, Q, D = xq.shape
    sid = _slots(state, slot_ids, B)
    lam = decay_of(loglam)
    rows = torch.arange(B, device=xq.device)
    par = parents.long().clamp(0, Q - 1)
    allS = torch.empty((B, H, Q, D, D), dtype=torch.float32, device=xq.device)
    allS[:, :, 0] = la_step(state[sid].to(torch.float32), lam, xk[:, :, 0], xv[:, :, 0])
    for i in range(1, Q):
        allS[:, :, i] = la_step(allS[rows, :, par[:, i]], lam, xk[:, :, i], xv[:, :, i])
    live = valid.to(torch.bool) & valid[:, :1].to(torch.bool)
    live[:, 1:] &= (parents[:, 1:] >= 0)
    out = la_readout(xq, allS)
    return torch.where(live[:, None, :, None], out, 0.0)


def linear_attention_commit_plain(state, win_k, win_v, chain, n_commit, loglam, slot_ids):
    """state [n_lin, slots, H, D, D]; win_k, win_v [n_lin, B, H, Q, D];
    chain [B, M]; n_commit [B]; loglam [n_lin, H]."""
    lam = decay_of(loglam)[:, :, None, None]  # [n_lin, H, 1, 1]
    M = chain.shape[1]
    for b, n in enumerate(n_commit.tolist()):
        s = int(slot_ids[b])
        S = state[:, s]
        for c in chain[b, : min(n, M)].tolist():
            S = lam * S + win_k[:, b, :, c, :, None] * win_v[:, b, :, c, None, :]
        state[:, s] = S
    return state


# ---------------------------------------------------------------------------
# K14's plan and launch fields
# ---------------------------------------------------------------------------


class LaPlan(NamedTuple):
    """One K14 call's launches: a grid (x, y, z) and dynamic shared bytes
    each (chunk mode: the tiles' increments, the carry over the tiles, the
    outputs), and the workspace it needs (chunk mode: two fp32 [D, D]
    states a row, head and tile of the padded width: the tile's increment
    and the state it enters with)."""
    grids: tuple
    smem: tuple
    workspace_bytes: int


def la_plan(mode: str, B: int, H: int, Q: int, D: int, n_lin: int = 1) -> LaPlan:
    """K14's launches for ``mode`` ("chunk", "decode", "tree", "commit") at
    B rows, H heads, Q tokens a row (C in chunk mode; the chain's width in
    commit mode), head dim D and (commit) n_lin layers. Raises on what the
    kernel does not take: D not a multiple of ``SLAB`` in [16,
    ``MAX_HEAD_DIM``] (a block holds whole 16-column slabs, a thread D /
    ``READOUT_SPLIT`` elements of one), a decode of Q != 1, more than 65535
    heads or rows (commit: layers x rows), and a tree window or commit chain
    whose staged rows pass the block's shared memory."""
    if mode not in ("chunk", "decode", "tree", "commit"):
        raise ValueError(f"la_plan: no mode {mode!r}")
    if D % SLAB or not SLAB <= D <= MAX_HEAD_DIM:
        raise ValueError(f"linear attention on the card takes a head dim that is a multiple "
                         f"of {SLAB} in [{SLAB}, {MAX_HEAD_DIM}], not {D}")
    if min(B, H, Q, n_lin) < 1:
        raise ValueError(f"la_plan: B={B} H={H} Q={Q} n_lin={n_lin} must be positive")
    rows = B * n_lin
    if H > MAX_GRID_YZ or rows > MAX_GRID_YZ:
        raise ValueError(f"la_plan: {H} heads and {rows} rows take at most {MAX_GRID_YZ} each")
    slabs = D // SLAB
    if mode == "chunk":
        qs, vs = D + 4, D + 8
        delta = 4 * (2 * TILE * vs + TILE + 4)
        outs = 4 * (TILE * max(qs, TILE + 4) + max(D, TILE) * vs + TILE + 4)
        tiles = -(-Q // TILE)
        scan = -(-D * D // (4 * SCAN_THREADS))
        return LaPlan(((tiles, H, B), (scan, H, B), (tiles, H, B)), (delta, 0, outs),
                      8 * B * H * tiles * D * D)
    if mode == "decode":
        if Q != 1:
            raise ValueError(f"decode takes one token a row, not {Q}")
        return LaPlan(((slabs, H, B),), (0,), 0)
    if mode == "tree":
        smem = 4 * (2 * Q * D + Q * SLAB + 2 * READOUT_SPLIT * SLAB) + 4 * (3 * Q + 1)
        what = f"a tree window of {Q} nodes"
    else:
        smem = 4 * (Q * D + Q * SLAB) + 4 * Q
        what = f"a commit chain of {Q} nodes"
    if smem > SMEM_LIMIT:
        raise ValueError(f"{what} at D={D} stages {smem} bytes, more than a block's "
                         f"{SMEM_LIMIT}")
    return LaPlan(((slabs, H, rows),), (smem,), 0)


_LL, _I, _P = ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p


class _Static(ctypes.Structure):
    """What a K14 launch fixes for a shape of its operands (``LaStatic`` of
    ``csrc/linear_attention.cu``, field for field)."""
    _fields_ = ([("xs", (_LL * 3) * 3), ("valid_stride", _LL * 2), ("idx_stride", _LL * 2)]
                + [(n, _LL) for n in ("slot_stride", "lens_stride", "layer_stride",
                                      "win_layer")]
                + [(n, _I) for n in ("B", "H", "Q", "D", "n_lin", "M", "slot_wide",
                                     "lens_wide", "idx_wide", "slabs", "tiles", "smem",
                                     "smem2")])


def _index(t: Optional[torch.Tensor], dev, shape, what: str) -> int:
    """1 for int64, 0 for int32 (-1 for None); raises on anything else."""
    if t is None:
        return -1
    if t.dtype not in (torch.int32, torch.int64) or t.device != dev or t.shape != shape:
        raise ValueError(f"{what} must be int32 or int64 {tuple(shape)} on {dev}, got "
                         f"{t.dtype} {tuple(t.shape)} on {t.device}")
    if len(shape) == 2 and shape[1] > 1 and t.stride(1) != 1:
        raise ValueError(f"{what} needs a contiguous last axis, strides {t.stride()}")
    return int(t.dtype == torch.int64)


def _features(xs, lead: tuple, B, H, Q, D, dev, align: bool, what: str) -> list:
    """Each feature tensor's strides over (b, h, token), checked: fp32 of
    shape lead + (B, H, Q, D) on ``dev`` with a contiguous last axis."""
    strides = []
    for x in xs:
        if x.dtype != torch.float32 or x.device != dev or x.shape != lead + (B, H, Q, D):
            raise ValueError(f"{what} takes fp32 {lead + (B, H, Q, D)} features on {dev}, "
                             f"got {x.dtype} {tuple(x.shape)} on {x.device}")
        if x.stride(-1) != 1:
            raise ValueError(f"{what}: features need a contiguous last axis, strides "
                             f"{x.stride()}")
        s = x.stride()[-4:-1]
        if align and any(v % 4 for v in s):
            raise ValueError(f"{what} reads 16-byte rows: strides {x.stride()} must be "
                             f"multiples of 4")
        strides.append(s)
    return strides


def la_static(mode: str, xq, xk, xv, state, loglam, slot_ids=None, lens=None, valid=None,
              parents=None, chain=None) -> tuple:
    """K14's fixed launch fields for ``mode`` on these operands, checked:
    (the ctypes struct, its address, its plan). Chunk, decode and tree: xq,
    xk, xv fp32 [B, H, Q, D] with a contiguous last axis (chunk mode: the
    other strides multiples of 4), state a contiguous fp32 [slots, H, D, D]
    (row b's at ``slot_ids[b]``, or [B, H, D, D] without them), loglam fp32
    [H]; ``lens`` chunk_lens [B]; ``valid`` bool [B, Q]; ``parents`` [B, Q].
    Commit: xq None, xk / xv the stash [n_lin, B, H, Q, D] with one set of
    strides, state [n_lin, slots, H, D, D], loglam [n_lin, H], ``lens``
    n_commit [B], ``chain`` [B, M]. Indices int32 or int64. Builds on any
    device (the CPU tests build it)."""
    dev = state.device
    if mode == "commit":
        n_lin, B, H, Q, D = xk.shape
        if xv.shape != xk.shape or xv.stride() != xk.stride():
            raise ValueError(f"linear_attention_commit: win_v {tuple(xv.shape)} "
                             f"{xv.stride()} must match win_k {tuple(xk.shape)} "
                             f"{xk.stride()}")
        xs = _features((xk, xk, xv), (n_lin,), B, H, Q, D, dev, False,
                       "linear_attention_commit")
        if state.dim() != 5 or state.shape[0] != n_lin or state.shape[2:] != (H, D, D):
            raise ValueError(f"linear_attention_commit: arena {tuple(state.shape)} is not "
                             f"[{n_lin}, slots, {H}, {D}, {D}]")
        M = chain.shape[-1]
        plan = la_plan(mode, B, H, M, D, n_lin)
        ll_shape = (n_lin, H)
    else:
        B, H, Q, D = xq.shape
        n_lin, M = 1, 0
        xs = _features((xq, xk, xv), (), B, H, Q, D, dev, mode == "chunk",
                       f"linear_attention_{mode}")
        if state.dim() != 4 or state.shape[1:] != (H, D, D):
            raise ValueError(f"linear_attention_{mode}: state {tuple(state.shape)} is not "
                             f"[slots, {H}, {D}, {D}]")
        if slot_ids is None and state.shape[0] != B:
            raise ValueError(f"state {tuple(state.shape)} is not [B={B}, H, D, D]")
        plan = la_plan(mode, B, H, Q, D)
        ll_shape = (H,)
    if state.dtype != torch.float32 or not state.is_contiguous():
        raise ValueError(f"linear attention takes a contiguous fp32 state, not {state.dtype} "
                         f"strides {state.stride()}")
    if (loglam.dtype != torch.float32 or loglam.shape != ll_shape or loglam.device != dev
            or not loglam.is_contiguous()):
        raise ValueError(f"loglam must be contiguous fp32 {ll_shape} on {dev}, got "
                         f"{loglam.dtype} {tuple(loglam.shape)}")
    slot_wide = _index(slot_ids, dev, (B,), "slot_ids")
    lens_wide = _index(lens, dev, (B,), "chunk_lens / n_commit")
    idx = parents if mode == "tree" else chain
    idx_wide = _index(idx, dev, (B, Q if mode == "tree" else M), "parents / chain")
    vstride = (0, 0)
    if mode in ("decode", "tree"):
        if (valid is None or valid.dtype != torch.bool or valid.shape != (B, Q)
                or valid.device != dev):
            raise ValueError(f"valid must be bool {(B, Q)} on {dev}, got "
                             f"{None if valid is None else (valid.dtype, tuple(valid.shape))}")
        vstride = valid.stride()
    xs_c = ((_LL * 3) * 3)(*((_LL * 3)(*s) for s in xs))
    st = _Static(xs_c, (_LL * 2)(*vstride),
                 (_LL * 2)(*(idx.stride() if idx is not None else (0, 0))),
                 slot_ids.stride(0) if slot_ids is not None else 0,
                 lens.stride(0) if lens is not None else 0,
                 state[0].numel() if mode == "commit" else 0,
                 xk.stride(0) if mode == "commit" else 0,
                 B, H, Q, D, n_lin, M, max(slot_wide, 0), max(lens_wide, 0), max(idx_wide, 0),
                 D // SLAB, plan.grids[0][0] if mode == "chunk" else 0,
                 plan.smem[0], plan.smem[-1])
    return st, ctypes.addressof(st), plan


# ---------------------------------------------------------------------------
# K14 wrappers
# ---------------------------------------------------------------------------

# operands' shapes, strides, types and devices -> (struct, its address, workspace floats)
_STATICS = {}
_ARGS = {"la_chunk": (_P,) * 11, "la_decode": (_P,) * 10, "la_tree": (_P,) * 11,
         "la_commit": (_P,) * 9}


def _desc(t):
    """A tensor's part of a ``_STATICS`` key."""
    return None if t is None else (t.shape, t.stride(), t.dtype, t.get_device())


def _static(mode, xq, xk, xv, state, loglam, slot_ids, lens=None, valid=None, parents=None,
            chain=None) -> tuple:
    key = (mode, _desc(xq), _desc(xk), _desc(xv), _desc(state), _desc(loglam),
           _desc(slot_ids), _desc(lens), _desc(valid), _desc(parents), _desc(chain))
    hit = _STATICS.get(key)
    if hit is None:
        st, addr, plan = la_static(mode, xq, xk, xv, state, loglam, slot_ids, lens, valid,
                                   parents, chain)
        hit = _STATICS[key] = (st, addr, plan.workspace_bytes // 4)
    return hit


def _launch(entry: str, *args) -> None:
    lib, fn = _build.function("linear_attention", entry, _ARGS[entry])
    err = fn(*args)
    if err:
        _build.check(lib, err, entry)


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _out(x: torch.Tensor) -> torch.Tensor:
    return torch.empty_like(x, memory_format=torch.contiguous_format)


def _chunk_cuda(xq, xk, xv, state, chunk_lens, loglam, slot_ids):
    _, st, work = _static("chunk", xq, xk, xv, state, loglam, slot_ids, lens=chunk_lens)
    if (xq.data_ptr() | xk.data_ptr() | xv.data_ptr() | state.data_ptr()) & 15:
        raise ValueError("linear_attention_chunk reads 16-byte rows: features and state "
                         "must start on 16-byte boundaries")
    out = _out(xq)
    ws = _build.scratch(xq.device, work)
    _launch("la_chunk", st, xq.data_ptr(), xk.data_ptr(), xv.data_ptr(), state.data_ptr(),
            _ptr(slot_ids), chunk_lens.data_ptr(), loglam.data_ptr(), ws.data_ptr(),
            out.data_ptr(), _build.stream_of(xq))
    linear_attention_chunk.launches += 1
    return out


def linear_attention_chunk(xq: torch.Tensor, xk: torch.Tensor, xv: torch.Tensor,
                           state: torch.Tensor, chunk_lens: torch.Tensor,
                           loglam: torch.Tensor, slot_ids: Optional[torch.Tensor] = None
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunk mode: xq, xk, xv [B, H, C, D] (feature-mapped), chunk_lens [B],
    loglam [H]. Returns (out [B, H, C, D], state), the state updated in
    place."""
    if xq.is_cuda:
        if xq.numel() == 0:
            return torch.zeros_like(xq), state
        return _chunk_cuda(xq, xk, xv, state, chunk_lens, loglam, slot_ids), state
    if xq.device.type != "cpu":
        raise NotImplementedError(f"linear_attention_chunk on {xq.device}")
    return linear_attention_chunk_plain(xq, xk, xv, state, chunk_lens, loglam, slot_ids)


def linear_attention_decode(xq: torch.Tensor, xk: torch.Tensor, xv: torch.Tensor,
                            state: torch.Tensor, valid: torch.Tensor, loglam: torch.Tensor,
                            slot_ids: Optional[torch.Tensor] = None
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """AR decode: xq, xk, xv [B, H, 1, D], valid [B, 1] (bool on the card).
    Returns (out [B, H, 1, D], state), each valid row's state stepped in
    place."""
    if xq.shape[2] != 1:
        raise ValueError(f"decode takes one token a row, not {xq.shape[2]}")
    if not xq.is_cuda:
        if xq.device.type != "cpu":
            raise NotImplementedError(f"linear_attention_decode on {xq.device}")
        return linear_attention_decode_plain(xq, xk, xv, state, valid, loglam, slot_ids)
    if xq.numel() == 0:
        return torch.zeros_like(xq), state
    return _decode_cuda(xq, xk, xv, state, valid, loglam, slot_ids), state


def _decode_cuda(xq, xk, xv, state, valid, loglam, slot_ids):
    st = _static("decode", xq, xk, xv, state, loglam, slot_ids, valid=valid)[1]
    out = _out(xq)
    _launch("la_decode", st, xq.data_ptr(), xk.data_ptr(), xv.data_ptr(), state.data_ptr(),
            _ptr(slot_ids), valid.data_ptr(), loglam.data_ptr(), out.data_ptr(),
            _build.stream_of(xq))
    linear_attention_decode.launches += 1
    return out


def linear_attention_tree(xq: torch.Tensor, xk: torch.Tensor, xv: torch.Tensor,
                          state: torch.Tensor, parents: torch.Tensor, valid: torch.Tensor,
                          loglam: torch.Tensor, slot_ids: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """Tree verify over a window whose node 0 is the root: xq, xk, xv
    [B, H, Q, D], parents [B, Q] (-1 the root, -2 a dead node, else an
    earlier node), valid [B, Q] (bool on the card). Returns out [B, H, Q,
    D]; the state is only read."""
    if not xq.is_cuda:
        if xq.device.type != "cpu":
            raise NotImplementedError(f"linear_attention_tree on {xq.device}")
        return linear_attention_tree_plain(xq, xk, xv, state, parents, valid, loglam,
                                           slot_ids)
    if xq.numel() == 0:
        return torch.zeros_like(xq)
    return _tree_cuda(xq, xk, xv, state, parents, valid, loglam, slot_ids)


def _tree_cuda(xq, xk, xv, state, parents, valid, loglam, slot_ids):
    st = _static("tree", xq, xk, xv, state, loglam, slot_ids, valid=valid,
                 parents=parents)[1]
    out = _out(xq)
    _launch("la_tree", st, xq.data_ptr(), xk.data_ptr(), xv.data_ptr(), state.data_ptr(),
            _ptr(slot_ids), parents.data_ptr(), valid.data_ptr(), loglam.data_ptr(),
            out.data_ptr(), _build.stream_of(xq))
    linear_attention_tree.launches += 1
    return out


def linear_attention_commit(state: torch.Tensor, win_k: torch.Tensor, win_v: torch.Tensor,
                            chain: torch.Tensor, n_commit: torch.Tensor,
                            loglam: torch.Tensor, slot_ids: torch.Tensor) -> torch.Tensor:
    """Replay each row's first ``n_commit[b]`` chain nodes (window columns
    ``chain[b]``, root first) from the stash ``win_k``, ``win_v``
    [n_lin, B, H, Q, D] into slot ``slot_ids[b]`` of every layer of the
    arena ``state`` [n_lin, slots, H, D, D], in place; loglam [n_lin, H]."""
    if not state.is_cuda:
        if state.device.type != "cpu":
            raise NotImplementedError(f"linear_attention_commit on {state.device}")
        return linear_attention_commit_plain(state, win_k, win_v, chain, n_commit, loglam,
                                             slot_ids)
    if win_k.numel() == 0 or chain.shape[-1] == 0:
        return state
    return _commit_cuda(state, win_k, win_v, chain, n_commit, loglam, slot_ids)


def _commit_cuda(state, win_k, win_v, chain, n_commit, loglam, slot_ids):
    st = _static("commit", None, win_k, win_v, state, loglam, slot_ids, lens=n_commit,
                 chain=chain)[1]
    _launch("la_commit", st, state.data_ptr(), win_k.data_ptr(), win_v.data_ptr(),
            slot_ids.data_ptr(), chain.data_ptr(), n_commit.data_ptr(), loglam.data_ptr(),
            _build.stream_of(state))
    linear_attention_commit.launches += 1
    return state


for _wrapper in (linear_attention_chunk, linear_attention_decode, linear_attention_tree,
                 linear_attention_commit):
    _wrapper.launches = 0
