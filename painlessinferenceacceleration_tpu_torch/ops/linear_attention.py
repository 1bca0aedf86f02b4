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
each rounded) and the readout ``out = sum_d q[d] * S[d, :]`` over d in
ascending order. Decode, verify and commit share it, so a verified row has
the bits of the AR row at its position and the committed state the bits of
AR's steps (the JAX package's closed forms agree with it only in exact
arithmetic). The plain versions repeat that arithmetic operation for
operation, elementwise, so on the card a recurrent mode equals its plain
version bit for bit, and on the CPU lookahead equals AR too.

The state argument is either the JAX-shaped ``[B, H, D, D]`` (row b is
state b) or, with ``slot_ids`` [B], one layer's slot arena ``[slots, H, D,
D]`` (row b is state ``slot_ids[b]``); chunk and decode update it in place.
Rows with nothing to do (``chunk_lens`` 0, an invalid decode row, a commit
of 0) leave their state alone, so padding rows may alias a real row's slot.
Outputs of padded, dead or inactive rows are 0.

On a CUDA tensor each wrapper launches K14 or raises; on a CPU tensor it
takes its plain version. Each wrapper's ``launches`` counts its K14
launches.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from painlessinferenceacceleration_tpu_torch import _build

TILE = 64  # chunk mode's sub-tile (csrc/linear_attention.cu kTile)
MAX_HEAD_DIM = 128  # chunk mode's shared memory holds two [TILE, D + 1] tiles


def decay_of(loglam: torch.Tensor) -> torch.Tensor:
    """The per-head decay the recurrent modes multiply by: one conversion,
    shared by decode, verify and commit."""
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
    """``sum_d q[d] * S[d, :]`` over d ascending, a rounded product and sum
    each (the kernel's order; a matmul's order depends on its shape)."""
    acc = torch.zeros(S.shape[:-2] + S.shape[-1:], dtype=S.dtype, device=S.device)
    for d in range(S.shape[-2]):
        acc = acc + q[..., d, None] * S[..., d, :]
    return acc


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
# K14 wrappers
# ---------------------------------------------------------------------------


def _check(xq, state, what):
    B, H, Q, D = xq.shape
    if xq.dtype != torch.float32 or state.dtype != torch.float32:
        raise TypeError(f"{what} takes fp32 features and state, not {xq.dtype} / "
                        f"{state.dtype}")
    if not 0 < D <= MAX_HEAD_DIM:
        raise ValueError(f"{what}: head dim {D} not in (0, {MAX_HEAD_DIM}]")
    if state.shape[1:] != (H, D, D) or not state.is_contiguous():
        raise ValueError(f"{what}: state {tuple(state.shape)} is not a contiguous "
                         f"[slots, {H}, {D}, {D}]")


def _ids(t: torch.Tensor, dev) -> torch.Tensor:
    return t.to(device=dev, dtype=torch.int32).contiguous()


def _lib_fn(name: str, n_ptr: int, n_int: int, extra=()):
    """The entry ``name`` with n_ptr pointers, n_int ints, ``extra`` ctypes
    and the stream as its arguments."""
    lib = _build.library("linear_attention")
    fn = getattr(lib, name)
    fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int + list(extra)
                   + [ctypes.c_void_p])
    return lib, fn


def _recurrent_cuda(xq, xk, xv, state, parents, valid, loglam, slot_ids, write):
    B, H, Q, D = xq.shape
    _check(xq, state, "linear attention")
    dev = xq.device
    xq, xk, xv = (x.contiguous() for x in (xq, xk, xv))
    sid = _ids(_slots(state, slot_ids, B), dev)
    par = None if parents is None else _ids(parents, dev)
    val = valid.to(device=dev, dtype=torch.uint8).contiguous()
    lam = decay_of(loglam).contiguous()
    out = torch.zeros_like(xq)
    lib, fn = _lib_fn("la_recurrent", 9, 5)
    err = fn(xq.data_ptr(), xk.data_ptr(), xv.data_ptr(), state.data_ptr(), sid.data_ptr(),
             _build.ptr(par), val.data_ptr(), lam.data_ptr(), out.data_ptr(), B, H, Q, D,
             int(write), _build.stream_of(xq))
    _build.check(lib, err, "la_recurrent")
    (linear_attention_decode if write else linear_attention_tree).launches += 1
    return out


def _chunk_cuda(xq, xk, xv, state, chunk_lens, loglam, slot_ids):
    B, H, C, D = xq.shape
    _check(xq, state, "linear_attention_chunk")
    dev = xq.device
    xq, xk, xv = (x.contiguous() for x in (xq, xk, xv))
    sid = _ids(_slots(state, slot_ids, B), dev)
    lens = _ids(chunk_lens, dev)
    ll = loglam.to(device=dev, dtype=torch.float32).contiguous()
    out = torch.zeros_like(xq)
    lib, fn = _lib_fn("la_chunk", 8, 4)
    err = fn(xq.data_ptr(), xk.data_ptr(), xv.data_ptr(), state.data_ptr(), sid.data_ptr(),
             lens.data_ptr(), ll.data_ptr(), out.data_ptr(), B, H, C, D,
             _build.stream_of(xq))
    _build.check(lib, err, "la_chunk")
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
        return _chunk_cuda(xq, xk, xv, state, chunk_lens, loglam, slot_ids), state
    if xq.device.type != "cpu":
        raise NotImplementedError(f"linear_attention_chunk on {xq.device}")
    return linear_attention_chunk_plain(xq, xk, xv, state, chunk_lens, loglam, slot_ids)


def linear_attention_decode(xq: torch.Tensor, xk: torch.Tensor, xv: torch.Tensor,
                            state: torch.Tensor, valid: torch.Tensor, loglam: torch.Tensor,
                            slot_ids: Optional[torch.Tensor] = None
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """AR decode: xq, xk, xv [B, H, 1, D], valid [B, 1]. Returns (out
    [B, H, 1, D], state), each valid row's state stepped in place."""
    if xq.shape[2] != 1:
        raise ValueError(f"decode takes one token a row, not {xq.shape[2]}")
    if not xq.is_cuda:
        if xq.device.type != "cpu":
            raise NotImplementedError(f"linear_attention_decode on {xq.device}")
        return linear_attention_decode_plain(xq, xk, xv, state, valid, loglam, slot_ids)
    return _recurrent_cuda(xq, xk, xv, state, None, valid, loglam, slot_ids, True), state


def linear_attention_tree(xq: torch.Tensor, xk: torch.Tensor, xv: torch.Tensor,
                          state: torch.Tensor, parents: torch.Tensor, valid: torch.Tensor,
                          loglam: torch.Tensor, slot_ids: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """Tree verify over a window whose node 0 is the root: xq, xk, xv
    [B, H, Q, D], parents [B, Q] (-1 the root, -2 a dead node, else an
    earlier node), valid [B, Q]. Returns out [B, H, Q, D]; the state is only
    read."""
    if not xq.is_cuda:
        if xq.device.type != "cpu":
            raise NotImplementedError(f"linear_attention_tree on {xq.device}")
        return linear_attention_tree_plain(xq, xk, xv, state, parents, valid, loglam,
                                           slot_ids)
    return _recurrent_cuda(xq, xk, xv, state, parents, valid, loglam, slot_ids, False)


def _commit_cuda(state, win_k, win_v, chain, n_commit, loglam, slot_ids):
    n_lin, slots, H, D, _ = state.shape
    _, B, _, Q, _ = win_k.shape
    if state.dtype != torch.float32 or win_k.dtype != torch.float32 or not state.is_contiguous():
        raise TypeError("linear_attention_commit takes a contiguous fp32 arena and stash")
    if win_k.shape != (n_lin, B, H, Q, D) or win_v.shape != win_k.shape:
        raise ValueError(f"stash {tuple(win_k.shape)} does not match the arena "
                         f"{tuple(state.shape)}")
    dev = state.device
    wk, wv = win_k.contiguous(), win_v.contiguous()
    sid, ch, nc = _ids(slot_ids, dev), _ids(chain, dev), _ids(n_commit, dev)
    lam = decay_of(loglam).contiguous()
    lib, fn = _lib_fn("la_commit", 7, 6, (ctypes.c_longlong,))
    err = fn(state.data_ptr(), wk.data_ptr(), wv.data_ptr(), sid.data_ptr(), ch.data_ptr(),
             nc.data_ptr(), lam.data_ptr(), n_lin, B, H, Q, D, ch.shape[1],
             slots * H * D * D, _build.stream_of(state))
    _build.check(lib, err, "la_commit")
    linear_attention_commit.launches += 1
    return state


def linear_attention_commit(state: torch.Tensor, win_k: torch.Tensor, win_v: torch.Tensor,
                            chain: torch.Tensor, n_commit: torch.Tensor,
                            loglam: torch.Tensor, slot_ids: torch.Tensor) -> torch.Tensor:
    """Replay each row's first ``n_commit[b]`` chain nodes (window columns
    ``chain[b]``, root first) from the stash ``win_k``, ``win_v``
    [n_lin, B, H, Q, D] into slot ``slot_ids[b]`` of every layer of the
    arena ``state`` [n_lin, slots, H, D, D], in place; loglam [n_lin, H]."""
    if state.is_cuda:
        return _commit_cuda(state, win_k, win_v, chain, n_commit, loglam, slot_ids)
    if state.device.type != "cpu":
        raise NotImplementedError(f"linear_attention_commit on {state.device}")
    return linear_attention_commit_plain(state, win_k, win_v, chain, n_commit, loglam,
                                         slot_ids)


for _wrapper in (linear_attention_chunk, linear_attention_decode, linear_attention_tree,
                 linear_attention_commit):
    _wrapper.launches = 0
