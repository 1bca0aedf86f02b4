"""Latency-oriented lookahead generation (single sequence and small batch).

Port of ``painlessinferenceacceleration_tpu/lookahead/generate.py``, the
system's original LOOKAHEAD entry point. Reference:
lookahead/common/pretrained_model.py ``lookahead_generation`` drives the loop
{trie query -> draft forward under a tree mask -> verify -> KV rollback ->
trie update} and records per-step stats dls/edls/fts/qts (documented in
lookahead/README.md:217-233).

Here the draft forward, the acceptance walk and the KV compaction are one
eager ``verify_step`` (engine/step.py) over a verify width padded to a fixed
Q; the host work is the trie query (the native C++ trie when it builds) and
the readback of the accepted tokens. Losslessness is by construction: decode
is verify with Q = 1, through the same kernels, whose rows do not depend on
the width.
"""

from __future__ import annotations

import dataclasses
import time
from typing import List, Optional, Sequence

import numpy as np
import torch

from painlessinferenceacceleration_tpu_torch._build import resolve_device
from painlessinferenceacceleration_tpu_torch.config import EngineConfig, ModelConfig
from painlessinferenceacceleration_tpu_torch.engine.cache import init_kv_cache
from painlessinferenceacceleration_tpu_torch.engine.step import prefill_step, verify_step
from painlessinferenceacceleration_tpu_torch.layers.linear import QuantSpec
from painlessinferenceacceleration_tpu_torch.ops.quant_matmul import (
    check_int4_params,
    check_int8_params,
)
from painlessinferenceacceleration_tpu_torch.layers.embedding import pad_vocab_rows
from painlessinferenceacceleration_tpu_torch.models.base import check_model_on_card
from painlessinferenceacceleration_tpu_torch.ops.w8a8 import check_w8a8_params
from painlessinferenceacceleration_tpu_torch.lookahead.trie import DraftCache


def make_draft_cache(**kw):
    """The native C++ trie when it builds (``csrc/trie.cpp``, ~10-30x faster
    put), else the pure-Python one (the same semantics, held equal by
    tests/test_torch_generate.py)."""
    from painlessinferenceacceleration_tpu_torch.lookahead.native import (
        NativeDraftCache,
        load_native,
    )

    if load_native() is not None:
        return NativeDraftCache(**kw)
    return DraftCache(**kw)


@dataclasses.dataclass
class GenerationOutput:
    """Mirrors the reference's LookaheadDecoderOnlyOutput ``kwargs`` stats
    contract (lookahead/common/lookahead_generation_utils.py:50)."""

    sequences: List[int]  # generated token ids (prompt excluded)
    dls: List[int]  # draft tokens offered per step
    edls: List[int]  # tokens emitted (accepted + 1) per step
    fts: List[float]  # forward time per step, seconds (after a device sync)
    qts: List[float]  # trie query time per step, seconds

    @property
    def mean_edl(self) -> float:
        return float(np.mean(self.edls)) if self.edls else 0.0


def _pad_draft(ids, mask, parents, Q: int, ctx: int):
    """Pad a trie draft to the fixed verify width Q."""
    n = min(len(ids), Q)
    toks = np.zeros((Q,), np.int32)
    toks[:n] = ids[:n]
    par = np.full((Q,), -2, np.int32)
    par[:n] = parents[:n]
    qm = np.zeros((Q, Q), bool)
    qm[:n, :n] = mask[:n, :n].astype(bool)
    depth = qm.sum(-1).astype(np.int32) - 1
    pos = ctx + np.clip(depth, 0, None)
    return toks, par, qm, pos.astype(np.int32), n


class LookaheadGenerator:
    """Greedy (and lookahead) generation over one model instance.

    Equivalent of the reference's LookaheadPreTrainedModel.generate with
    ``decoding_kwargs={'use_lookahead': True, 'decoding_length': ...,
    'branch_length': ..., 'decoding_mode': 'hier'}``
    (lookahead/common/pretrained_model.py:109-120). Each call allocates a
    fresh KV arena of ``ecfg``'s size on ``device`` (default cuda); the trie
    lives as long as the generator, so later requests draft from earlier
    outputs.
    """

    def __init__(self, params: dict, cfg: ModelConfig, ecfg: Optional[EngineConfig] = None,
                 quant: Optional[QuantSpec] = None, dtype=torch.bfloat16, device=None):
        if cfg.position_embedding_type == "glm_2d":
            # as in the JAX package, whose generator passes no GLM positions
            raise NotImplementedError("AntGLM's 2D positions are served by LLM, not "
                                      "LookaheadGenerator")
        self.params = pad_vocab_rows(params)
        self.cfg = cfg
        self.ecfg = ecfg or EngineConfig()
        self.quant = quant
        self.dtype = dtype
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            check_int4_params(params)
            check_int8_params(params)
            check_w8a8_params(params)
            check_model_on_card(cfg, self.params, self.ecfg.page_size)
        self.trie = make_draft_cache(eos_ids=(self.ecfg.eos_token_id,))

    def _fresh_kv(self):
        return init_kv_cache(self.cfg, self.ecfg, dtype=self.dtype, device=self.device)

    def _tensor(self, a) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def _prefill(self, kv, prompt: List[int], pt: torch.Tensor,
                 slot: Optional[int] = None):
        """Chunked prefill of one request (a fixed chunk width); returns
        (kv, first generated token)."""
        C = min(self.ecfg.prefill_chunk, self.ecfg.max_seq_len)
        sid = None if slot is None else self._tensor(np.array([slot], np.int32))
        done, nxt = 0, None
        while done < len(prompt):
            chunk = prompt[done: done + C]
            buf = np.zeros((1, C), np.int32)
            buf[0, : len(chunk)] = chunk
            kv, nxt, _ = prefill_step(
                self.params, kv, self.cfg, self._tensor(buf),
                self._tensor(np.array([done], np.int32)),
                self._tensor(np.array([len(chunk)], np.int32)), pt, self.quant, sid)
            done += len(chunk)
        return kv, int(nxt[0])

    def generate(self, prompt_ids: Sequence[int], **kw) -> GenerationOutput:
        g = self._steps(prompt_ids, **kw)
        while True:
            try:
                next(g)
            except StopIteration as e:
                return e.value

    def stream_generate(self, prompt_ids, **kw):
        """Yield tokens incrementally as they are accepted: the first token
        right after prefill, then each verify step's accepted run."""
        g = self._steps(prompt_ids, **kw)
        while True:
            try:
                for t in next(g):
                    yield t
            except StopIteration:
                return

    def _steps(
        self,
        prompt_ids: Sequence[int],
        max_new_tokens: Optional[int] = None,
        use_lookahead: Optional[bool] = None,
        decoding_length: Optional[int] = None,
        branch_length: Optional[int] = None,
        decoding_mode: Optional[str] = None,
        eos_token_id: Optional[int] = None,
        request_idx: int = 0,
    ):
        ecfg = self.ecfg
        max_new = max_new_tokens or ecfg.max_new_tokens
        use_la = ecfg.use_lookahead if use_lookahead is None else use_lookahead
        dl = decoding_length or ecfg.decoding_length
        bl = branch_length or ecfg.branch_length
        mode = decoding_mode or ecfg.decoding_mode
        eos = ecfg.eos_token_id if eos_token_id is None else eos_token_id
        # draft budget gate — reference pretrained_model.py:72-86
        use_la = use_la and dl > 1 and bl > 0

        prompt = list(prompt_ids)
        if len(prompt) + max_new + dl + 1 > ecfg.max_seq_len:
            raise ValueError(f"prompt ({len(prompt)}) + max_new_tokens ({max_new}) + "
                             f"decoding_length ({dl}) + 1 exceeds max_seq_len "
                             f"({ecfg.max_seq_len})")
        kv = self._fresh_kv()
        P = ecfg.pages_per_req
        pt = torch.arange(1, 1 + P, dtype=torch.int32, device=self.device)[None]

        t0 = time.perf_counter()
        kv, next_token = self._prefill(kv, prompt, pt)
        t_fts: List[float] = [time.perf_counter() - t0]

        if use_la:
            # seed the trie with prompt n-grams (reference: cache.put(...,
            # mode='input') pretrained_model.py:1156)
            self.trie.put(prompt, branch_length=bl, mode="input", idx=request_idx)

        out: List[int] = [next_token]
        yield [next_token]
        ctx = len(prompt)
        dls: List[int] = [1]
        edls: List[int] = [1]
        qts: List[float] = [0.0]
        Q = 1 + dl if use_la else 1
        active = torch.ones((1,), dtype=torch.bool, device=self.device)

        while len(out) < max_new and out[-1] != eos:
            tq0 = time.perf_counter()
            if use_la:
                query = (prompt + out)[-2:]
                getter = {
                    "hier": self.trie.hier_get,
                    "par": self.trie.par_get,
                    "one": self.trie.one_get,
                }[mode]
                ids, mask, parents, _sizes = getter(
                    query, decoding_length=Q, branch_length=bl, idx=request_idx
                )
                if ids[0] != out[-1]:  # no trie entry: fall back to the bare token
                    ids, mask, parents = [out[-1]], np.ones((1, 1), np.int64), [-1]
            else:
                ids, mask, parents = [out[-1]], np.ones((1, 1), np.int64), [-1]
            toks, par, qm, pos, n = _pad_draft(ids, mask, parents, Q, ctx)
            qts.append(time.perf_counter() - tq0)

            tf0 = time.perf_counter()
            kv, ot, na = verify_step(
                self.params, kv, self.cfg, self._tensor(toks[None]), self._tensor(pos[None]),
                self._tensor(qm[None]), self._tensor(par[None]), pt,
                self._tensor(np.array([ctx], np.int32)), active, self.quant)
            k = int(na[0])
            emitted = ot[0, :k].tolist()
            if self.device.type == "cuda":  # fts times the device's work
                torch.cuda.synchronize(self.device)
            t_fts.append(time.perf_counter() - tf0)

            # truncate at eos / budget
            if eos in emitted:
                emitted = emitted[: emitted.index(eos) + 1]
            room = max_new - len(out)
            emitted = emitted[:room]
            out.extend(emitted)
            yield list(emitted)
            ctx += k
            dls.append(n)
            edls.append(len(emitted))
            if use_la and emitted:
                self.trie.stream_put(
                    emitted, branch_length=bl, idx=request_idx,
                    final=(out[-1] == eos or len(out) >= max_new),
                )

        return GenerationOutput(sequences=out, dls=dls, edls=edls, fts=t_fts, qts=qts)

    def batch_generate(
        self,
        prompt_lists: Sequence[Sequence[int]],
        max_new_tokens: Optional[int] = None,
        decoding_length: Optional[int] = None,
        branch_length: Optional[int] = None,
        eos_token_id: Optional[int] = None,
    ) -> List[GenerationOutput]:
        """Batched lookahead generation over the host trie.

        The reference's BatchLookaheadGeneration (pretrained_model_batch.py:
        bat_get retrieval with the per-request sub-budget, one tree-masked
        forward for the whole batch). One padded ``verify_step`` serves all
        rows, each with its own trie-drafted tree; rows finish independently
        (``active``). Lossless: every row's tokens equal its solo greedy
        stream."""
        ecfg = self.ecfg
        B = len(prompt_lists)
        max_new = max_new_tokens or ecfg.max_new_tokens
        dl = decoding_length or ecfg.decoding_length
        bl = branch_length or ecfg.branch_length
        eos = ecfg.eos_token_id if eos_token_id is None else eos_token_id
        if B > ecfg.max_concurrency:
            raise ValueError(f"{B} prompts exceed max_concurrency {ecfg.max_concurrency}")
        Q = 1 + dl
        kv = self._fresh_kv()
        P = ecfg.pages_per_req
        pt = torch.arange(1, 1 + B * P, dtype=torch.int32, device=self.device).reshape(B, P)

        prompts = [list(p) for p in prompt_lists]
        outs: List[List[int]] = [[] for _ in range(B)]
        dls = [[1] for _ in range(B)]
        edls = [[1] for _ in range(B)]
        # chunked prefill row by row (the batched spec loop below is the
        # point of this path); row r takes slot r
        for r, prompt in enumerate(prompts):
            kv, first = self._prefill(kv, prompt, pt[r: r + 1], slot=r)
            outs[r].append(first)
            self.trie.put(prompt, branch_length=bl, mode="input", idx=r)

        ctxs = np.array([len(p) for p in prompts], np.int32)
        finished = np.zeros((B,), bool)
        while not finished.all():
            act_rows = [r for r in range(B) if not finished[r]]
            queries = [(prompts[r] + outs[r])[-2:] for r in act_rows]
            drafts = self.trie.bat_get(
                queries, decoding_length=Q, branch_length=bl, indices=act_rows,
            )
            toks = np.zeros((B, Q), np.int32)
            par = np.full((B, Q), -2, np.int32)
            qm = np.zeros((B, Q, Q), bool)
            pos = np.zeros((B, Q), np.int32)
            ns = np.zeros((B,), np.int32)
            for r, (ids, mask, parents, _sizes) in zip(act_rows, drafts):
                if not ids or ids[0] != outs[r][-1]:
                    ids, mask, parents = [outs[r][-1]], np.ones((1, 1), np.int64), [-1]
                t, p_, q_, po, n = _pad_draft(ids, mask, parents, Q, int(ctxs[r]))
                toks[r], par[r], qm[r], pos[r] = t, p_, q_, po
                ns[r] = n
            kv, ot, na = verify_step(
                self.params, kv, self.cfg, self._tensor(toks), self._tensor(pos),
                self._tensor(qm), self._tensor(par), pt, self._tensor(ctxs),
                self._tensor(~finished), self.quant)
            na_np = na.cpu().numpy()
            ot_np = ot.cpu().numpy()
            for r in act_rows:
                k = int(na_np[r])
                emitted = [int(x) for x in ot_np[r][:k]]
                if eos in emitted:
                    emitted = emitted[: emitted.index(eos) + 1]
                room = max_new - len(outs[r])
                emitted = emitted[:room]
                outs[r].extend(emitted)
                ctxs[r] += k
                dls[r].append(int(ns[r]))
                edls[r].append(len(emitted))
                if emitted:
                    self.trie.stream_put(
                        emitted, branch_length=bl, idx=r,
                        final=(outs[r][-1] == eos or len(outs[r]) >= max_new),
                    )
                if outs[r] and (outs[r][-1] == eos or len(outs[r]) >= max_new):
                    finished[r] = True
        return [
            GenerationOutput(sequences=outs[r], dls=dls[r], edls=edls[r], fts=[], qts=[])
            for r in range(B)
        ]
