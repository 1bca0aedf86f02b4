"""Engine steps: chunked prefill, the general tree verify and the
parallel-branch verify.

Port of ``prefill_step``, ``score_step``, ``_accept_walk``,
``verify_core``, ``verify_step``, ``verify_parallel_core`` and
``decode_inputs`` from ``painlessinferenceacceleration_tpu/engine/step.py``.
Where JAX jits the step and donates the KV arena, these run eagerly and
update the arena in place (the returned ``kv`` is the same dict).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from painlessinferenceacceleration_tpu_torch.config import ModelConfig
from painlessinferenceacceleration_tpu_torch.engine.cache import compact_kv_tail
from painlessinferenceacceleration_tpu_torch.layers.linear import QuantSpec
from painlessinferenceacceleration_tpu_torch.models.base import (
    logits_from_hidden,
    transformer_hidden,
)
from painlessinferenceacceleration_tpu_torch.models.linear_attn import commit_linear_states
from painlessinferenceacceleration_tpu_torch.ops.cp_attention import cp_compact_tail
from painlessinferenceacceleration_tpu_torch.ops.paged_attention import window_qmask
from painlessinferenceacceleration_tpu_torch.ops.sample import sample_tokens_at
from painlessinferenceacceleration_tpu_torch.parallel import comm


def prefill_step(
    params: dict,
    kv: dict,
    cfg: ModelConfig,
    tokens: torch.Tensor,  # [B, C] padded chunk
    start_lens: torch.Tensor,  # [B] committed length before this chunk
    chunk_lens: torch.Tensor,  # [B] valid tokens in this chunk
    page_tables: torch.Tensor,  # [B, P]
    spec: Optional[QuantSpec] = None,
    slot_ids: Optional[torch.Tensor] = None,  # [B] engine slots (linear-attn state)
    mm_embeds: Optional[torch.Tensor] = None,  # [B, M, E] multimodal embeddings
    mm_pos: Optional[torch.Tensor] = None,  # [B, M] their prompt positions (-1 pad)
    glm_ids: Optional[torch.Tensor] = None,  # [B, 2] (prompt_len_eff, mask_pos)
) -> Tuple[dict, torch.Tensor, torch.Tensor]:
    """One prompt chunk per request; returns (kv, next_tokens [B],
    last_logits [B, V]). next_tokens is meaningful on the final chunk.

    ``mm_embeds`` / ``mm_pos`` splice precomputed (image) embeddings over
    the token embeddings at those prompt positions, as each chunk reaches
    them. ``glm_ids`` gives AntGLM's 2D positions and, with
    ``cfg.prefix_lm``, the prefix-LM window: a query also sees the chunk's
    keys inside the prompt, so the chunk is not purely causal (a chunk past
    128 rows runs the prefill rule with the window, ``glm_ids[:, 0]``)."""
    B, C = tokens.shape
    dev = tokens.device
    i = torch.arange(C, device=dev)
    pos = start_lens.long()[:, None] + i[None, :]
    window = None  # AntGLM's prefix-LM window: every row sees the prompt's keys
    if cfg.prefix_lm and glm_ids is not None:
        window = glm_ids[:, 0].to(torch.int32).contiguous()
    qmask = window_qmask(B, C, start_lens, window, dev)
    causal_window = window is None
    valid = i[None, :] < chunk_lens[:, None]
    embed_override = None
    if mm_embeds is not None:
        local = mm_pos.long() - start_lens.long()[:, None]
        ok = (local >= 0) & (local < C) & (mm_pos >= 0)
        embed_override = (torch.where(ok, local, C), mm_embeds)
    h, kv = transformer_hidden(params, cfg, kv, tokens, pos, page_tables,
                               start_lens, qmask, valid, spec, causal_window=causal_window,
                               slot_ids=slot_ids, embed_override=embed_override,
                               glm_ids=glm_ids, prefix_window=window)
    last = (chunk_lens.long() - 1).clamp(0, C - 1)
    h_last = h[torch.arange(B, device=dev), last][:, None]  # [B, 1, E]
    logits = logits_from_hidden(params, cfg, h_last, spec)[:, 0]
    return kv, torch.argmax(logits, dim=-1).to(torch.int32), logits


def score_step(
    params: dict,
    kv: dict,
    cfg: ModelConfig,
    tokens: torch.Tensor,  # [B, C] padded chunk (prompt + target tokens)
    start_lens: torch.Tensor,  # [B]
    chunk_lens: torch.Tensor,  # [B]
    page_tables: torch.Tensor,  # [B, P]
    spec: Optional[QuantSpec] = None,
    boundary_next: Optional[torch.Tensor] = None,  # [B] first token of the next chunk
    slot_ids: Optional[torch.Tensor] = None,  # [B] engine slots (linear-attn state)
) -> Tuple[dict, torch.Tensor]:
    """A prefill chunk that also returns every position's next-token
    logprob, ``lp[b, t] = log P(tokens[b, t + 1] | ...)`` (PPL scoring,
    option ranking). The last valid position scores ``boundary_next`` (the
    next chunk's first token; 0 when absent), so chunked scoring reads the
    same logprobs as one chunk would. Returns (kv, lp [B, C] fp32)."""
    B, C = tokens.shape
    dev = tokens.device
    i = torch.arange(C, device=dev)
    pos = start_lens.long()[:, None] + i[None, :]
    qmask = (i[:, None] >= i[None, :])[None].expand(B, C, C)
    valid = i[None, :] < chunk_lens[:, None]
    h, kv = transformer_hidden(params, cfg, kv, tokens, pos, page_tables,
                               start_lens, qmask, valid, spec, causal_window=True,
                               slot_ids=slot_ids)
    logp = torch.log_softmax(logits_from_hidden(params, cfg, h, spec), dim=-1)  # [B, C, V]
    if boundary_next is None:
        boundary_next = torch.zeros(B, dtype=torch.int64, device=dev)
    nxt = torch.cat([tokens[:, 1:].long(), torch.zeros(B, 1, dtype=torch.int64, device=dev)],
                    dim=1)
    last = (chunk_lens.long() - 1).clamp(0, C - 1)
    nxt[torch.arange(B, device=dev), last] = boundary_next.long()
    return kv, torch.gather(logp, 2, nxt[..., None])[..., 0]


def _accept_walk(greedy: torch.Tensor, tokens: torch.Tensor, parents: torch.Tensor):
    """Greedy acceptance walk along each request's draft tree, batched.

    greedy/tokens/parents: [B, Q]. Node 0 is the root (last committed
    token); node s > 0 is a draft token whose parent is ``parents[:, s]``
    (pad nodes have -2 and never match). From the root, the walk moves to
    the first child whose token equals the greedy continuation of the
    current node, until none does. Returns (out [B, Q] emitted tokens, zero
    past n_out; n_out [B]; path [B, Q] accepted node indices, zero past
    n_out - 1). A matched child's index exceeds its parent's (DFS order),
    so Q - 1 steps end every walk: the loop runs them all on the device,
    with no host synchronisation.
    """
    B, Q = greedy.shape
    dev = greedy.device
    ar = torch.arange(Q, device=dev)
    # child[b, p, s]: node s continues node p greedily
    child = (parents.long()[:, None, :] == ar[None, :, None]) & (
        tokens[:, None, :] == greedy[:, :, None])
    nxt = torch.where(child.any(-1), child.to(torch.int8).argmax(-1),
                      torch.full((B, Q), -1, dtype=torch.long, device=dev))
    cur = torch.zeros(B, dtype=torch.long, device=dev)
    nodes = []
    for _ in range(Q - 1):
        cur = torch.where(cur >= 0, torch.gather(nxt, 1, cur.clamp(min=0)[:, None])[:, 0], cur)
        nodes.append(cur)
    steps = torch.stack(nodes, 1) if nodes else torch.zeros(B, 0, dtype=torch.long,
                                                            device=dev)
    on = steps >= 0
    n_edges = on.sum(1)
    path = torch.zeros(B, Q, dtype=torch.int32, device=dev)
    path[:, : Q - 1] = torch.where(on, steps, 0).to(torch.int32)
    out = torch.zeros(B, Q, dtype=torch.int32, device=dev)
    out[:, 0] = greedy[:, 0]
    out[:, 1:] = torch.where(on, torch.gather(greedy, 1, steps.clamp(min=0)), 0)
    return out, (n_edges + 1).to(torch.int32), path


def _verify_forward(params, kv, cfg, tokens, positions, qmask, parents, page_tables,
                    ctx_lens, active, spec, slot_ids, glm_ids=None, record=None):
    """The verify forward over the draft window; a hybrid stashes the
    window's k, v for the commit; ``record``, when a list, gets each layer's
    (KV layer, K rows, V rows). Returns (kv, logits [B, Q, V], node_valid)."""
    node_valid = parents > -2
    valid = node_valid & active[:, None]
    h, kv = transformer_hidden(params, cfg, kv, tokens, positions, page_tables,
                               ctx_lens, qmask, valid, spec, slot_ids=slot_ids,
                               defer_state=cfg.linear_attention, glm_ids=glm_ids,
                               record=record)
    return kv, logits_from_hidden(params, cfg, h, spec), node_valid


def _cp_rank(Q: int) -> Optional[int]:
    """This rank's index on the model axis when a verify of width ``Q`` runs
    under context parallelism (the rank state ``DistLLM`` sets), else None:
    that step compacts from its own K / V rows (``cp_compact_tail``)."""
    st = comm.current()
    return st.model_rank if st is not None and st.cp > 1 and Q > 1 else None


def _commit_and_compact(kv, cfg, page_tables, ctx_lens, active, slot_ids, chain, n_acc,
                        path, n_edges, Q, cp_rows=None, cp_rank=None):
    """After acceptance: a hybrid commits the accepted chain (window columns
    ``chain[:, :n_acc]``, root first; inactive rows nothing) into its slots'
    states (under data parallelism its data group's rows, then the groups'
    committed states are shared: ``commit_linear_states``); then, unless
    ``path`` is None (Q = 1), the accepted rows move,
    node ``path[:, i]`` to slot ctx + 1 + i for i < n_edges, in K, V and the
    fp8_tok scale arenas. Under context parallelism (``cp_rank`` set) they
    are written again from the step's recorded rows ``cp_rows``, on this
    rank's pages."""
    if cfg.linear_attention:
        n_eff = torch.where(active, n_acc, torch.zeros_like(n_acc))
        if slot_ids is None:
            slot_ids = torch.arange(chain.shape[0], dtype=torch.int32, device=chain.device)
        kv = commit_linear_states(kv, chain, n_eff, slot_ids, comm.current())
    if path is None:
        return kv
    if cp_rank is not None:
        cp_compact_tail(kv, cp_rows, page_tables, ctx_lens, path, n_edges, active, cp_rank)
        return kv
    # K, V and (fp8_tok) their per-token scales together: one launch
    arenas = (kv["k"], kv["v"])
    if "k_tok_scale" in kv:
        arenas += (kv["k_tok_scale"], kv["v_tok_scale"])
    compact_kv_tail(arenas, page_tables, ctx_lens, path, n_edges, Q, active)
    return kv


def verify_core(
    params: dict,
    kv: dict,
    cfg: ModelConfig,
    tokens: torch.Tensor,  # [B, Q]: col 0 = last committed token, cols 1.. = draft
    positions: torch.Tensor,  # [B, Q]: ctx + node depth
    qmask: torch.Tensor,  # [B, Q, Q] bool ancestor matrix (row t = visible nodes)
    parents: torch.Tensor,  # [B, Q] int32 (-1 root, -2 pad), DFS order
    page_tables: torch.Tensor,  # [B, P]
    ctx_lens: torch.Tensor,  # [B] committed length (the root is written here)
    active: torch.Tensor,  # [B] bool
    spec: Optional[QuantSpec] = None,
    slot_ids: Optional[torch.Tensor] = None,  # [B] engine slots (linear-attn state)
    glm_ids: Optional[torch.Tensor] = None,  # [B, 2] AntGLM 2D positions
) -> Tuple[dict, torch.Tensor, torch.Tensor]:
    """Forward over a general draft tree, greedy acceptance walk, the
    hybrid commit of the accepted chain and KV compaction of the accepted
    rows. Returns (kv, out_tokens [B, Q], n_accepted [B], 0 for inactive
    rows). Plain decode is Q = 1 with a trivial mask."""
    B, Q = tokens.shape
    cp_rank = _cp_rank(Q)
    cp_rows = [] if cp_rank is not None else None
    kv, logits, _ = _verify_forward(params, kv, cfg, tokens, positions, qmask, parents,
                                    page_tables, ctx_lens, active, spec, slot_ids, glm_ids,
                                    cp_rows)
    greedy = torch.argmax(logits, dim=-1).to(torch.int32)
    out_tokens, n_acc, path = _accept_walk(greedy, tokens.to(torch.int32), parents)
    # the committed chain's window columns: the root, then the accepted path
    chain = torch.cat([torch.zeros_like(path[:, :1]), path[:, : Q - 1]], dim=1)
    n_edges = torch.where(active, n_acc - 1, torch.zeros_like(n_acc))
    kv = _commit_and_compact(kv, cfg, page_tables, ctx_lens, active, slot_ids, chain, n_acc,
                             path[:, : Q - 1] if Q > 1 else None, n_edges, Q, cp_rows,
                             cp_rank)
    n_acc = torch.where(active, n_acc, torch.zeros_like(n_acc))
    return kv, out_tokens, n_acc


# One verify step. JAX jits ``verify_core`` under this name; here it runs eagerly.
verify_step = verify_core


def verify_parallel_core(
    params: dict,
    kv: dict,
    cfg: ModelConfig,
    tokens: torch.Tensor,  # [B, Q] (Q = 1 + R*L, block layout of device tables)
    positions: torch.Tensor,
    qmask: torch.Tensor,
    parents: torch.Tensor,
    page_tables: torch.Tensor,
    ctx_lens: torch.Tensor,
    active: torch.Tensor,
    R: int,
    L: int,
    spec: Optional[QuantSpec] = None,
    teacher: Optional[torch.Tensor] = None,  # [B, W] teacher-forced stream
    slot_ids: Optional[torch.Tensor] = None,  # [B] engine slots (linear-attn state)
    sampling: Optional[tuple] = None,  # (temperature, top_k, top_p, min_p, seeds), [B] each
    glm_ids: Optional[torch.Tensor] = None,  # [B, 2] AntGLM 2D positions
) -> Tuple[dict, torch.Tensor, torch.Tensor]:
    """Tree-verify forward, greedy (or teacher-forced, or sampled)
    acceptance along the best branch, and KV compaction of the accepted
    rows. Returns (kv, out_tokens [B, Q], n_accepted [B]). A
    linear-attention hybrid verifies without writing its states and then
    commits the accepted chain (root first) into the states of
    ``slot_ids``; inactive rows commit nothing.

    With ``sampling`` each node's target is the token sampled from its
    filtered row at the node's stream position + 1 (``sample_tokens_at``),
    which is what the AR loop draws there; rows with temperature 0 take the
    argmax. The teacher, when given, takes precedence."""
    B, Q = tokens.shape
    assert Q == 1 + R * L, (Q, R, L)
    dev = tokens.device
    cp_rank = _cp_rank(Q)
    cp_rows = [] if cp_rank is not None else None
    kv, logits, node_valid = _verify_forward(params, kv, cfg, tokens, positions, qmask,
                                             parents, page_tables, ctx_lens, active, spec,
                                             slot_ids, glm_ids, cp_rows)
    if teacher is not None:
        # the target of the node at stream position p is the teacher's p+1
        W = teacher.shape[1]
        tgt = (positions.long() + 1).clamp(0, W - 1)
        greedy = torch.gather(teacher.long(), 1, tgt).to(torch.int32)
    elif sampling is None:
        greedy = torch.argmax(logits, dim=-1).to(torch.int32)
    else:
        temperature, top_k, top_p, min_p, seeds = sampling

        def rep(a):  # [B] -> [B*Q], one value a node
            return a.repeat_interleave(Q, dim=0)

        greedy = sample_tokens_at(
            logits.reshape(B * Q, -1), rep(seeds), (positions.long() + 1).reshape(B * Q),
            rep(temperature), rep(top_k), rep(top_p),
            rep(min_p) if min_p is not None else None).reshape(B, Q)

    par = parents.long().clamp(0, Q - 1)
    g_par = torch.gather(greedy, 1, par)
    match = (tokens == g_par) & node_valid
    mb = match[:, 1:].reshape(B, R, L).to(torch.int32)
    edges_per_branch = torch.cumprod(mb, dim=2).sum(dim=2)  # [B, R]
    best = torch.argmax(edges_per_branch, dim=1)  # first max, as jnp.argmax
    n_edges = torch.gather(edges_per_branch, 1, best[:, None])[:, 0]
    n_acc = (n_edges + 1).to(torch.int32)

    ar = torch.arange(L, device=dev)[None, :]
    node_ids = 1 + best[:, None] * L + ar  # [B, L]
    out_tokens = torch.cat([greedy[:, :1], torch.gather(greedy, 1, node_ids)], dim=1)
    if out_tokens.shape[1] < Q:
        out_tokens = torch.nn.functional.pad(out_tokens, (0, Q - out_tokens.shape[1]))
    # the committed chain's window columns: the root, then the branch; the
    # accepted node(best, i) at slot ctx+1+best*L+i moves to ctx+1+i
    chain = torch.cat([torch.zeros_like(node_ids[:, :1]), node_ids], dim=1)
    eff_edges = torch.where(active & (best > 0), n_edges, torch.zeros_like(n_edges))
    kv = _commit_and_compact(kv, cfg, page_tables, ctx_lens, active, slot_ids, chain, n_acc,
                             node_ids, eff_edges, Q, cp_rows, cp_rank)
    n_acc = torch.where(active, n_acc, torch.zeros_like(n_acc))
    return kv, out_tokens, n_acc


def decode_inputs(last_tokens: torch.Tensor, ctx_lens: torch.Tensor):
    """Trivial verify inputs for plain decode (Q = 1)."""
    B = last_tokens.shape[0]
    dev = last_tokens.device
    tokens = last_tokens[:, None]
    positions = ctx_lens[:, None]
    qmask = torch.ones((B, 1, 1), dtype=torch.bool, device=dev)
    parents = torch.full((B, 1), -1, dtype=torch.int32, device=dev)
    return tokens, positions, qmask, parents
