"""Multi-step decode loops (AR and lookahead), as Python loops.

Port of ``multistep_decode`` and ``multistep_spec_decode`` from
``painlessinferenceacceleration_tpu/engine/multistep.py``. JAX runs each
loop as one ``lax.scan`` on the device (its host relay made every sync
expensive) and donates the arena; here each step is an eager call, the KV
arena and the draft tables are updated in place, and the spec loop reads
the accepted counts back once per step to bound the table update.

Both loops take greedy, teacher-forced or sampled targets (per-row
temperature / top-k / top-p / min-p and seeds; counter-mode draws at each
token's stream position, ``ops/sample.py``), ``eos``, a per-row
``budget``, every arena kind (an e4m3 arena's scales ride in ``kv``) and
the linear-attention hybrids' recurrent states, one per engine slot
(``slot_ids``). The AR loop also takes the repetition penalty over a
seen-token mask that it extends with each emitted token. The spec loop
takes frozen tables (``update_tables=False``), reports the ``wide_mask``
probe (a step whose drafts were retrievable) and, with
``DraftTableConfig.adaptive``, runs a width-1 AR step instead of the wide
verify on a step where no active row retrieved a draft: a host branch on
the probe, read back once a step with the accepted counts. Both take
AntGLM's per-row (prompt_len_eff, mask_pos) pair (``glm_ids``) for the 2D
positions.
"""

from __future__ import annotations

from typing import Optional

import torch

from painlessinferenceacceleration_tpu_torch.config import ModelConfig
from painlessinferenceacceleration_tpu_torch.engine.step import verify_parallel_core
from painlessinferenceacceleration_tpu_torch.layers.linear import QuantSpec
from painlessinferenceacceleration_tpu_torch.lookahead.device_tables import (
    DraftTableConfig,
    build_tree_inputs,
    retrieve_drafts,
    update_tables_seq,
)
from painlessinferenceacceleration_tpu_torch.models.base import (
    logits_from_hidden,
    transformer_hidden,
)
from painlessinferenceacceleration_tpu_torch.ops.sample import (
    apply_repetition_penalty,
    sample_tokens_at,
)

_NO_LIMIT = torch.iinfo(torch.int32).max


def _defaults(B, dev, eos, budget):
    if eos is None:
        eos = torch.full((B,), -2, dtype=torch.int32, device=dev)
    if budget is None:
        budget = torch.full((B,), _NO_LIMIT, dtype=torch.int32, device=dev)
    return eos, budget


def _sampling(B, dev, temperature, top_k, top_p, min_p, seeds):
    """The per-row sampling arrays as a tuple, or None for greedy."""
    if temperature is None:
        return None
    if seeds is None:
        seeds = torch.zeros(B, dtype=torch.int32, device=dev)
    return (temperature, top_k, top_p, min_p, seeds)


def _ar_logits(params, cfg, kv, last, ctx, act, page_tables, qmask1, spec, slot_ids,
               glm_ids=None):
    """One width-1 step's forward: (kv, logits [B, V])."""
    h, kv = transformer_hidden(params, cfg, kv, last[:, None], ctx[:, None], page_tables,
                               ctx, qmask1, act[:, None], spec, slot_ids=slot_ids,
                               glm_ids=glm_ids)
    return kv, logits_from_hidden(params, cfg, h, spec)[:, 0]


def _ar_tokens(logits, ctx, teacher, sampling):
    """The token a width-1 step emits after ``logits`` [B, V] at context
    ``ctx``: the teacher's ctx + 1, the draw at stream position ctx + 1, or
    the argmax."""
    if teacher is not None:
        tgt = (ctx.long() + 1).clamp(0, teacher.shape[1] - 1)
        return torch.gather(teacher.long(), 1, tgt[:, None])[:, 0].to(torch.int32)
    if sampling is not None:
        temperature, top_k, top_p, min_p, seeds = sampling
        return sample_tokens_at(logits, seeds, ctx + 1, temperature, top_k, top_p, min_p)
    return torch.argmax(logits, dim=-1).to(torch.int32)


def multistep_decode(
    params: dict,
    kv: dict,
    cfg: ModelConfig,
    last_tokens: torch.Tensor,  # [B]
    ctx_lens: torch.Tensor,  # [B]
    active: torch.Tensor,  # [B] bool
    page_tables: torch.Tensor,  # [B, P]
    n_steps: int,
    eos: Optional[torch.Tensor] = None,  # [B] per-request eos id (-2 = none)
    spec: Optional[QuantSpec] = None,
    teacher: Optional[torch.Tensor] = None,  # [B, W] teacher-forced stream
    budget: Optional[torch.Tensor] = None,  # [B] max tokens to emit per row
    slot_ids: Optional[torch.Tensor] = None,  # [B] engine slots (linear-attn state)
    temperature: Optional[torch.Tensor] = None,  # [B]; None => greedy
    top_k: Optional[torch.Tensor] = None,  # [B]
    top_p: Optional[torch.Tensor] = None,  # [B]
    min_p: Optional[torch.Tensor] = None,  # [B]
    seeds: Optional[torch.Tensor] = None,  # [B] per-request seeds
    rep_penalty: Optional[torch.Tensor] = None,  # [B]; None => off
    seen_mask: Optional[torch.Tensor] = None,  # [B, V] bool: prompt + output tokens
    glm_ids: Optional[torch.Tensor] = None,  # [B, 2] AntGLM 2D positions
):
    """``n_steps`` AR steps, greedy, teacher-forced or sampled (the token at
    stream position p drawn from the noise of (seed, p), as the spec loop
    draws it), with the repetition penalty applied before the choice when
    ``rep_penalty`` is given; each emitted token joins the seen mask (a
    copy: the caller's stays as it was). Returns (kv, tokens [B, K], last,
    ctx, active, budget_left); inactive rows emit -1."""
    B = last_tokens.shape[0]
    dev = last_tokens.device
    eos, budget = _defaults(B, dev, eos, budget)
    sampling = _sampling(B, dev, temperature, top_k, top_p, min_p, seeds)
    if rep_penalty is not None:
        seen = (seen_mask.clone() if seen_mask is not None else
                torch.zeros((B, cfg.vocab_size), dtype=torch.bool, device=dev))
    rows = torch.arange(B, device=dev)
    last, ctx, act = last_tokens.to(torch.int32), ctx_lens.to(torch.int32), active
    cnt = torch.zeros(B, dtype=torch.int32, device=dev)
    qmask = torch.ones((B, 1, 1), dtype=torch.bool, device=dev)
    toks = []
    for _ in range(n_steps):
        kv, logits = _ar_logits(params, cfg, kv, last, ctx, act, page_tables, qmask, spec,
                                slot_ids, glm_ids)
        if rep_penalty is not None:
            logits = apply_repetition_penalty(logits, seen, rep_penalty)
        nxt = _ar_tokens(logits, ctx, teacher, sampling)
        if rep_penalty is not None:
            seen[rows, nxt.long()] = True
        toks.append(torch.where(act, nxt, -1))
        step = act.to(torch.int32)
        ctx = ctx + step
        cnt = cnt + step
        act = act & (nxt != eos) & (cnt < budget)
        last = torch.where(act, nxt, last)
    return kv, torch.stack(toks, dim=1), last, ctx, act, budget - cnt


def multistep_spec_decode(
    params: dict,
    kv: dict,
    tables: dict,
    cfg: ModelConfig,
    tcfg: DraftTableConfig,
    last_tokens: torch.Tensor,  # [B]
    ctx_lens: torch.Tensor,  # [B]
    active: torch.Tensor,  # [B] bool
    tail: torch.Tensor,  # [B, TAIL] rolling recent-token window (ends with last)
    page_tables: torch.Tensor,  # [B, P]
    n_steps: int,
    eos: Optional[torch.Tensor] = None,
    spec: Optional[QuantSpec] = None,
    teacher: Optional[torch.Tensor] = None,
    update_tables: bool = True,  # False: frozen tables (strict-lossless replay)
    budget: Optional[torch.Tensor] = None,
    slot_ids: Optional[torch.Tensor] = None,  # [B] engine slots (linear-attn state)
    temperature: Optional[torch.Tensor] = None,  # [B]; None => greedy verify
    top_k: Optional[torch.Tensor] = None,  # [B]
    top_p: Optional[torch.Tensor] = None,  # [B]
    min_p: Optional[torch.Tensor] = None,  # [B]
    seeds: Optional[torch.Tensor] = None,  # [B]
    glm_ids: Optional[torch.Tensor] = None,  # [B, 2] AntGLM 2D positions
):
    """``n_steps`` lookahead verify steps with the draft tables on the card.

    Per step and active row: retrieve the top-R branches for the last
    2-gram, tree-verify (width Q = 1 + R*L) with KV compaction, insert the
    windows completed by the accepted tokens, roll the tail. Sampled rows
    verify against the tokens drawn at each node's stream position, so the
    stream equals the sampled AR stream. With ``tcfg.adaptive`` a step on
    which no active row retrieved a draft above ``tcfg.gate_min_freq`` is a
    width-1 AR step (``out[:, s, 0]`` only). Returns (kv, tables,
    out_tokens [B, K, Q] (-1 padded), n_acc [B, K], last, ctx, active,
    tail, wide_mask [K]): ``wide_mask[s]`` is the probe, whether some active
    row retrieved a draft on step s (with ``adaptive``, whether the wide
    verify ran)."""
    B = last_tokens.shape[0]
    dev = last_tokens.device
    eos, budget = _defaults(B, dev, eos, budget)
    sampling = _sampling(B, dev, temperature, top_k, top_p, min_p, seeds)
    qmask1 = torch.ones((B, 1, 1), dtype=torch.bool, device=dev)
    L, R, Q = tcfg.branch_length, tcfg.retrieve_count, tcfg.verify_width
    TAIL = tail.shape[1]
    last, ctx, act = last_tokens.to(torch.int32), ctx_lens.to(torch.int32), active
    tail = tail.to(torch.int32)
    cnt = torch.zeros(B, dtype=torch.int32, device=dev)
    k = torch.arange(Q, device=dev)[None, :]
    outs, accs, wides = [], [], []
    for _ in range(n_steps):
        branches, freqs = retrieve_drafts(tables, tcfg, tail[:, -2], last)
        any_draft = ((freqs[:, 0] > tcfg.gate_min_freq) & act).any()
        wides.append(any_draft)
        if tcfg.adaptive and not bool(any_draft):
            # no draft anywhere: a plain width-1 AR step, whose token is the
            # wide verify's root token (the rows are width-invariant)
            kv, logits = _ar_logits(params, cfg, kv, last, ctx, act, page_tables, qmask1,
                                    spec, slot_ids, glm_ids)
            out = torch.zeros((B, Q), dtype=torch.int32, device=dev)
            out[:, 0] = _ar_tokens(logits, ctx, teacher, sampling)
            n_acc = act.to(torch.int32)
        else:
            tokens, parents, qmask, depth = build_tree_inputs(last, branches)
            kv, out, n_acc = verify_parallel_core(
                params, kv, cfg, tokens, ctx[:, None] + depth, qmask, parents,
                page_tables, ctx, act, R, L, spec, teacher, slot_ids, sampling, glm_ids)
        # eos clamp: truncate the emitted run at its first eos
        is_eos = (out == eos[:, None]) & (k < n_acc[:, None])
        any_eos = is_eos.any(dim=1)
        eos_pos = torch.argmax(is_eos.to(torch.int32), dim=1).to(torch.int32)
        n_acc = torch.where(any_eos, eos_pos + 1, n_acc)
        # budget clamp; an eos inside the clamped run still ends the row
        n_acc = torch.minimum(n_acc, (budget - cnt).clamp(min=0))
        any_eos = any_eos & (eos_pos < n_acc)
        emitted = torch.where((k < n_acc[:, None]) & act[:, None], out, -1)
        outs.append(emitted)

        # roll the tail: the TAIL tokens ending at the new stream head
        n_emit = n_acc * act.to(torch.int32)
        full = torch.cat([tail, emitted], dim=1)
        end = TAIL + n_emit
        tail = torch.gather(full, 1, (end[:, None] - TAIL + torch.arange(TAIL, device=dev)).long())

        if update_tables:
            for b, n in enumerate(n_emit.tolist()):
                if n > 0:
                    update_tables_seq(tables, tcfg, full[b], TAIL + n,
                                      win_lo=TAIL, win_hi=TAIL + n)

        nxt_last = torch.gather(out, 1, (n_acc.long() - 1).clamp(0, Q - 1)[:, None])[:, 0]
        ctx = ctx + n_emit
        cnt = cnt + n_emit
        accs.append(n_emit)
        act = act & ~any_eos & (cnt < budget)
        last = torch.where(act, nxt_last, last)
    return (kv, tables, torch.stack(outs, dim=1), torch.stack(accs, dim=1),
            last, ctx, act, tail, torch.stack(wides))
