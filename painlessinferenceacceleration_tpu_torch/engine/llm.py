"""LLM facade: the continuous-batching serving engine.

Port of ``painlessinferenceacceleration_tpu/engine/llm.py`` (``LLM``):

- one scheduler (inline in ``generate``, or a thread after ``launch``) runs
  a scoring phase (requests with ``target_ids``: one forward over prompt +
  targets in ``prefill_chunk`` slices, per-target logprobs, no decode), then
  a prefill phase (admission with the prefix cache, chunked prefill of
  several requests at once) and a decode phase (AR bursts, or lookahead
  bursts while the batch is at most ``use_spec_min_batch_size``, with the
  spec gate and cooldown) in the order ``schedule_policy`` sets: pingpong
  (prefill, then decode), timely (decode first) or mix (width-1 decode rows
  ride in the prefill batches);
- greedy and sampled requests (temperature, top-k, top-p, min-p, a seed a
  request): the token at stream position p draws from the noise of (seed,
  p) on every route (the prefill's first token, mix rows, AR bursts and the
  lookahead verify), so a sampled stream is the same under every policy,
  with lookahead or without; the repetition penalty on AR bursts, over a
  seen mask of the prompt and outputs (such a request keeps the batch off
  lookahead and out of mix batches);
- paged admission, page growth, parking and preemption on the host page
  allocator, LRU eviction of prefix-cache entries under pressure;
- pipelined AR bursts: burst N+1 is dispatched from burst N's device
  tensors before N's tokens are read back, so the host's readback overlaps
  the card's work (CUDA's stream order stands in for JAX's dispatch order);
- static fp8 KV calibration (``calibrate_kv_scales``);
- the linear-attention hybrids' recurrent states: each batch row carries
  its engine slot (``slot_ids``; padding rows borrow slot 0 and write no
  state), and a request that takes a slot starts from a zeroed state, both
  when it is admitted and when a preempted request re-prefills. The JAX
  engine does neither reset, so a reused slot there adds the new prompt
  onto the last request's state. For the same reason a hybrid serves
  without the prefix cache: a matched prefix would leave its tokens out of
  the states, which live outside the pages. A preempted hybrid request
  re-prefills its prompt only and regenerates its committed outputs by
  decode (``Request.replay``): the chunk form sums in another order than
  the per-token step that decode and the commit use, so replaying the
  outputs through prefill would leave other bits in the states than the
  unpreempted stream's.

- loading: ``LLM(model_path=...)`` reads a local HF checkpoint directory
  through ``models/hf_loader.py`` (the port's own safetensors reader; no
  download), quantized to ``EngineConfig.quant`` on the card leaf by leaf;
  the tokenizer is the caller's (any object with ``encode`` / ``decode``),
  or HF's ``AutoTokenizer`` for the directory when ``transformers`` is
  importable;
- multimodal requests: precomputed embeddings spliced over prompt positions
  during chunked prefill (such a request takes no part in the prefix
  cache); AntGLM's 2D positions (each slot's prompt length and first mask
  token) on every route, with the prefix-LM window in prefill.

On a linear-attention hybrid, mix batches carry no decode rows (a row's
chunk-form bits differ from its decode step's) and a scoring request
borrows a free slot's state (zeroed first).

Host arrays are numpy mirrors of the per-slot state, as in the JAX engine;
they go to the card through pinned buffers (``non_blocking``), so that an
upload does not wait for the burst in flight.
"""

from __future__ import annotations

import dataclasses
import itertools
import threading
import time
from collections import deque
from typing import List, Optional, Sequence

import numpy as np
import torch

from painlessinferenceacceleration_tpu_torch import _build
from painlessinferenceacceleration_tpu_torch.config import EngineConfig, ModelConfig
from painlessinferenceacceleration_tpu_torch.engine.cache import (
    auto_size_pages,
    init_kv_cache,
    reset_linear_states,
)
from painlessinferenceacceleration_tpu_torch.engine.multistep import (
    multistep_decode,
    multistep_spec_decode,
)
from painlessinferenceacceleration_tpu_torch.engine.pages import PageAllocator
from painlessinferenceacceleration_tpu_torch.engine.prefix_cache import PrefixCache
from painlessinferenceacceleration_tpu_torch.engine.request import (
    Request,
    SamplingParams,
)
from painlessinferenceacceleration_tpu_torch.engine.step import prefill_step, score_step
from painlessinferenceacceleration_tpu_torch.models.base import check_model_on_card
from painlessinferenceacceleration_tpu_torch.layers.embedding import (
    make_embedding,
    pad_vocab_rows,
)
from painlessinferenceacceleration_tpu_torch.layers.linear import QuantSpec
from painlessinferenceacceleration_tpu_torch.ops.quant_matmul import (
    check_int4_params,
    check_int8_params,
)
from painlessinferenceacceleration_tpu_torch.ops.sample import sample_tokens_at
from painlessinferenceacceleration_tpu_torch.ops.w8a8 import check_w8a8_params
from painlessinferenceacceleration_tpu_torch.lookahead.device_tables import (
    DraftTableConfig,
    init_draft_tables,
    update_tables_batch,
    update_tables_seq,
)
from painlessinferenceacceleration_tpu_torch.utils.metrics import EngineMetrics


def _auto_tokenizer(model_path: str):
    """HF's AutoTokenizer for a checkpoint directory, when ``transformers``
    is importable and the directory holds one; else None."""
    try:
        from transformers import AutoTokenizer
    except ImportError:
        return None
    try:
        return AutoTokenizer.from_pretrained(model_path, local_files_only=True)
    except Exception:  # no tokenizer files in the directory
        return None


def _first_tensor(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            t = _first_tensor(v)
            if t is not None:
                return t
        return None
    return tree if isinstance(tree, torch.Tensor) else None


class LLM:
    """Serving engine over one model instance."""

    rank = 0  # the process that takes requests (a DistLLM's rank 0)

    def __init__(
        self,
        model_path: Optional[str] = None,
        cfg: Optional[ModelConfig] = None,
        params: Optional[dict] = None,
        ecfg: Optional[EngineConfig] = None,
        tokenizer=None,
        dtype=torch.bfloat16,
        device=None,
    ):
        self.device = _build.resolve_device(device)
        self.ecfg = ecfg or EngineConfig()
        self.quant = QuantSpec.from_mode(self.ecfg.quant, self.ecfg.quant_group)
        if model_path is not None:
            from painlessinferenceacceleration_tpu_torch.models.hf_loader import load_model

            cfg, params, self.quant = load_model(model_path, dtype=dtype, quant=self.quant,
                                                 device=self.device)
            if tokenizer is None:
                tokenizer = _auto_tokenizer(model_path)
        if cfg is None or params is None:
            raise ValueError("LLM needs model_path, or cfg and params")
        leaf = _first_tensor(params)
        if leaf is None or leaf.device.type != self.device.type:
            raise ValueError(f"params live on {None if leaf is None else leaf.device}, "
                             f"the engine runs on {self.device}")
        if self.device.type == "cuda":
            _build.build_all()  # never on the scheduler thread
            for name in _build.SOURCES:
                _build.library(name)
        self.dtype = dtype
        if self.ecfg.quant_embed and "embed" in params:
            params = dict(params)
            params["embed"] = make_embedding(params["embed"],
                                             QuantSpec.from_mode("w8a8_fp8"))
        # a tied table's rows padded to a multiple of 8 (the head's logits are
        # cut back to the vocabulary in logits_from_hidden)
        params = pad_vocab_rows(params)
        if self.device.type == "cuda":
            check_int4_params(params)
            check_int8_params(params)
            check_w8a8_params(params)
            check_model_on_card(cfg, params, self.ecfg.page_size)
        self.cfg = cfg
        self.params = params
        self.tokenizer = tokenizer

        if self.ecfg.cache_memory_fraction > 0:
            self.ecfg = dataclasses.replace(
                self.ecfg,
                num_pages=auto_size_pages(cfg, self.ecfg, dtype, self.device),
                cache_memory_fraction=0.0,
            )
        self.kv = init_kv_cache(cfg, self.ecfg, dtype=dtype, device=self.device)
        self.allocator = PageAllocator(self.ecfg.num_pages, self.ecfg.page_size)
        # a hybrid's states live outside the pages: no shared prefixes
        self.prefix_cache = (PrefixCache(self.allocator, self.ecfg.page_size)
                             if self.ecfg.prefix_cache and not cfg.linear_attention
                             else None)

        # decode-slot state (numpy mirrors of the device tensors)
        B = self.ecfg.max_concurrency
        P = self.ecfg.pages_per_req
        self._page_np = np.zeros((B, P), np.int32)
        self._last_np = np.zeros((B,), np.int32)
        self._ctx_np = np.zeros((B,), np.int32)
        self._slots: List[Optional[Request]] = [None] * B
        # AntGLM 2D positions: each slot's (prompt_len_eff, mask_pos), from
        # the prompt's first mask token
        self._glm = cfg.position_embedding_type == "glm_2d"
        self._glm_np = np.zeros((B, 2), np.int32) if self._glm else None

        # lookahead draft tables on the card, shared across requests
        self.tcfg = DraftTableConfig(
            buckets=16384,
            ways=8,
            branch_length=self.ecfg.branch_length,
            retrieve_count=max(1, self.ecfg.decoding_length // self.ecfg.branch_length),
        )
        self.tables = (init_draft_tables(self.tcfg, self.device)
                       if self.ecfg.use_lookahead else None)
        self._tails = np.full((B, self.tcfg.branch_length + 2), -1, np.int32)

        self._queue: deque = deque()
        self._rid = itertools.count()
        self._lock = threading.Lock()
        self._running = False
        self._thread: Optional[threading.Thread] = None
        self.metrics = EngineMetrics()
        self._decode_burst = self.ecfg.decode_burst
        self._spec_cooldown = 0
        # the last dispatched-but-undrained AR burst (device tensors)
        self._pending = None

    def _dev(self, a: np.ndarray) -> torch.Tensor:
        """Host array -> tensor on the engine's device (a copy)."""
        t = torch.from_numpy(np.ascontiguousarray(a))
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t.clone()

    # ------------------------------------------------------------------
    # public API
    # ------------------------------------------------------------------

    def add_request(
        self,
        input_ids: Sequence[int],
        sampling: Optional[SamplingParams] = None,
        stream: bool = False,
        target_ids: Optional[Sequence[int]] = None,
        mm_embeds=None,
        mm_positions: Optional[Sequence[int]] = None,
    ) -> Request:
        """Queue a request. ``mm_embeds`` [M, E] replace the embeddings of
        the prompt tokens at ``mm_positions`` (M of them)."""
        if mm_embeds is not None and (self.cfg.linear_attention or mm_positions is None
                                      or len(mm_positions) != len(mm_embeds)):
            raise ValueError("mm_embeds need one prompt position each (mm_positions), and "
                             "a model that is not a linear-attention hybrid")
        req = Request(next(self._rid), list(input_ids), sampling, stream,
                      list(target_ids) if target_ids else None, mm_embeds,
                      list(mm_positions) if mm_positions is not None else None)
        req.arrival_t = time.perf_counter()
        # an oversized prompt would overflow the per-request page table
        limit = self.ecfg.max_seq_len - 1
        total = req.prompt_len + len(req.target_ids or ())
        if total > limit:
            req.finish(f"error: prompt length {total} exceeds max_seq_len-1 ({limit})")
            return req
        self._enqueue(req)
        return req

    def _enqueue(self, req: Request) -> None:
        """A new request joins the queue (``DistLLM`` holds it for the next
        step's broadcast while its scheduler runs)."""
        with self._lock:
            self._queue.append(req)

    def generate(self, prompts, sampling: Optional[SamplingParams] = None
                 ) -> List[Request]:
        """Blocking batch generation; drives the scheduler inline unless the
        background loop runs (``launch``)."""
        reqs = []
        for p in prompts:
            ids = self.encode(p) if isinstance(p, str) else p
            reqs.append(self.add_request(ids, sampling))
        if self._running:
            while any(r.state != "finished" for r in reqs):
                time.sleep(0.001)
        else:
            while any(r.state != "finished" for r in reqs):
                self.step()
        return reqs

    def stream_generate(self, prompt, sampling: Optional[SamplingParams] = None):
        """Yield one request's tokens as they are produced."""
        ids = self.encode(prompt) if isinstance(prompt, str) else prompt
        req = self.add_request(ids, sampling, stream=True)
        if not self._running:
            while req.state != "finished" or not req.stream_queue.empty():
                self.step()
                while not req.stream_queue.empty():
                    t = req.stream_queue.get_nowait()
                    if t is None:
                        return
                    yield t
            return
        while True:
            t = req.stream_queue.get()
            if t is None:
                return
            yield t

    async def async_stream_generate(self, prompt, sampling: Optional[SamplingParams] = None):
        """Async token stream of one request; needs the background loop
        (``launch``)."""
        import asyncio
        import queue

        if not self._running:
            raise RuntimeError("call launch() before async streaming")
        ids = self.encode(prompt) if isinstance(prompt, str) else prompt
        req = self.add_request(ids, sampling, stream=True)
        while True:
            try:
                t = req.stream_queue.get_nowait()
            except queue.Empty:
                await asyncio.sleep(0.001)
                continue
            if t is None:
                return
            yield t

    def launch(self) -> None:
        """Start the background scheduler thread."""
        if self._running:
            return
        self._running = True
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def shutdown(self) -> None:
        self._running = False
        if self._thread is not None:
            self._thread.join(timeout=30)
            self._thread = None

    def encode(self, text: str) -> List[int]:
        if self.tokenizer is None:
            raise ValueError("text prompts need a tokenizer: pass tokenizer= (any object "
                             "with encode / decode)")
        return list(self.tokenizer.encode(text))

    def decode_text(self, ids: Sequence[int]) -> str:
        if self.tokenizer is None:
            raise ValueError("decoding text needs a tokenizer: pass tokenizer= (any object "
                             "with encode / decode)")
        return self.tokenizer.decode(list(ids))

    # ------------------------------------------------------------------
    # scheduler
    # ------------------------------------------------------------------

    def _loop(self):
        while self._running:
            if not self.step():
                time.sleep(0.0005)

    def step(self) -> bool:
        """One scheduler iteration: the scoring phase, then prefill and
        decode in the order of ``schedule_policy``. Returns True if any work
        was done."""
        pol = self.ecfg.schedule_policy
        worked = self._score_phase()
        if pol == "timely":  # decode first: inter-token latency over TTFT
            worked = self._decode_phase() or worked
            worked = self._prefill_phase() or worked
        elif pol == "mix":  # decode rows ride in the prefill batches
            mixed = self._prefill_phase(mix=True)
            worked = mixed or worked
            # no prefill work, or rows that mix does not carry: decode bursts
            if not mixed or any(r is not None and r.state == "decode" and not self._mixable(r)
                                for r in self._slots):
                worked = self._decode_phase() or worked
        else:
            worked = self._prefill_phase() or worked
            worked = self._decode_phase() or worked
        return worked

    def _mixable(self, req: Request) -> bool:
        """A decode row that a mix prefill batch may carry: not under a
        repetition penalty (its seen mask lives on the burst path), and not
        a hybrid's (the chunk form's bits are not its decode step's)."""
        return req.sampling.repetition_penalty == 1.0 and not self.cfg.linear_attention

    def _score_phase(self) -> bool:
        """Score the queued requests with ``target_ids``: one forward over
        prompt + targets in ``prefill_chunk`` slices, the logprob of each
        target, no decode. A request that can never fit the arena finishes
        with an error; one that cannot fit now waits in the queue."""
        with self._lock:
            cand = [r for r in self._queue if r.target_ids]
            for r in cand:
                self._queue.remove(r)
        if not cand:
            return False
        self._drain_pending()  # scoring takes pages from the shared pool
        C = self.ecfg.prefill_chunk
        for req in cand:
            full = req.input_ids + req.target_ids
            need = self.allocator.pages_for_tokens(len(full))
            if need > self.ecfg.num_pages - 1:  # page 0 is the null page
                req.finish(f"error: scoring needs {need} pages, arena has "
                           f"{self.ecfg.num_pages - 1}")
                continue
            # a hybrid's states live in the slots: borrow a free one, zeroed
            slot = next((i for i, r in enumerate(self._slots) if r is None), None)
            if self.cfg.linear_attention and slot is None:
                pages = None
            else:
                self._reserve(need)
                pages = self.allocator.allocate(need)
            if pages is None:
                with self._lock:
                    self._queue.append(req)
                continue
            sid = None
            if self.cfg.linear_attention:
                reset_linear_states(self.kv, [slot])
                sid = self._dev(np.array([slot], np.int32))
            pt = np.zeros((1, self.ecfg.pages_per_req), np.int32)
            pt[0, : len(pages)] = pages
            pt_t = self._dev(pt)
            # chunked scoring: each slice scores its last token against the
            # next slice's first
            tlps = []
            for off in range(0, len(full), C):
                chunk = full[off: off + C]
                buf = np.zeros((1, C), np.int32)
                buf[0, : len(chunk)] = chunk
                boundary = full[off + len(chunk)] if off + len(chunk) < len(full) else 0
                self.kv, tlp = score_step(
                    self.params, self.kv, self.cfg, self._dev(buf),
                    self._dev(np.array([off], np.int32)),
                    self._dev(np.array([len(chunk)], np.int32)), pt_t, self.quant,
                    self._dev(np.array([boundary], np.int32)), slot_ids=sid)
                tlps.append(tlp[0, : len(chunk)].cpu().numpy())
            tlp = np.concatenate(tlps)
            p0 = len(req.input_ids) - 1
            req.target_logprobs = [float(tlp[p0 + i]) for i in range(len(req.target_ids))]
            self.allocator.free(pages)
            self.metrics.finished += 1
            req.finish("score")
        return True

    # ---- prefill ----

    def _admit(self) -> Optional[Request]:
        with self._lock:
            if not self._queue:
                return None
            req = self._queue.popleft()
            if req.target_ids:  # queued after this step's scoring phase: the next one's
                self._queue.appendleft(req)
                return None
        slot = next((i for i, r in enumerate(self._slots) if r is None), None)
        source = req.prefill_source
        shared: List[int] = []
        matched = 0
        if self.prefix_cache is not None and req.mm_embeds is None:
            shared, matched = self.prefix_cache.match(source)
            # retain before any eviction or allocation: _reserve could evict
            # the matched entries and allocate() hand their pages back out
            self.prefix_cache.retain_matched(shared)
        # a replaying request takes the pages of its regenerated outputs now,
        # as a prefill of them would
        need = self.allocator.pages_for_tokens(len(source) + 1 + req.replay) - len(shared)
        if slot is None or not self._reserve(need + 1):
            if shared:
                self.allocator.free(shared)  # release the early retain
            with self._lock:
                self._queue.appendleft(req)  # backpressure: retry later
            return None
        fresh = self.allocator.allocate(need)
        if shared:
            self.metrics.prefix_hit_tokens += matched
        req.pages = shared + fresh
        req.done = matched  # prefill resumes after the shared prefix
        req.slot = slot
        req.state = "prefill"
        if self._glm:
            src = req.input_ids
            p_eff = max(len(src) - 1, 1)  # the prompt ends with <sop>
            mids = self.cfg.mask_token_ids
            mpos = next((j for j, t in enumerate(src) if t in mids), p_eff - 1)
            self._glm_np[slot] = (p_eff, max(mpos, 0))
        self._slots[slot] = req
        # the slot's recurrent state (a hybrid's) still holds its last request's
        reset_linear_states(self.kv, [slot])
        self._page_np[slot] = 0
        self._page_np[slot, : len(req.pages)] = req.pages
        self._ctx_np[slot] = 0
        return req

    def page_stats(self) -> dict:
        """KV-arena state histogram plus the prefix-cache entry count."""
        st = self.allocator.page_stats()
        st["prefix_entries"] = len(self.prefix_cache) if self.prefix_cache is not None else 0
        return st

    def _reserve(self, n_pages: int) -> bool:
        """True once ``n_pages`` are free, evicting LRU prefix-cache entries
        as needed (an evicted page frees only when no request holds it)."""
        while (
            self.allocator.free_pages < n_pages
            and self.prefix_cache is not None
            and len(self.prefix_cache)
        ):
            self.prefix_cache.evict(n_pages - self.allocator.free_pages)
        return self.allocator.free_pages >= n_pages

    def _ensure_capacity(self, pages: List[int], n_tokens: int) -> bool:
        """allocator.ensure_capacity with prefix-cache eviction on pressure."""
        need = self.allocator.pages_for_tokens(n_tokens) - len(pages)
        if need > 0:
            self._reserve(need)
        return self.allocator.ensure_capacity(pages, n_tokens)

    def _prefill_phase(self, mix: bool = False) -> bool:
        # only drain the pipelined burst when there is prefill work: a full
        # batch cannot admit, and draining every iteration would stop chaining
        # (under mix too: with no prefill work the decode phase runs instead)
        with self._lock:
            queued = len(self._queue)
        has_mid = any(r is not None and r.state == "prefill" for r in self._slots)
        free_slots = sum(r is None for r in self._slots)
        want = min(max(1, self.ecfg.admit_min_free), max(queued, 1), len(self._slots))
        can_admit = queued > 0 and free_slots >= want
        if not (can_admit or has_mid):
            return False
        self._drain_pending()
        C = self.ecfg.prefill_chunk
        did = False
        while self._admit() is not None:
            pass
        while True:
            cand = [r for r in self._slots if r is not None and r.state == "prefill"]
            if not cand:
                return did
            if mix:  # width-1 decode rows share the forward
                for r in list(self._slots):
                    if r is None or r.state != "decode" or not self._mixable(r):
                        continue
                    need = int(self._ctx_np[r.slot]) + 2
                    if need > self.ecfg.max_seq_len:
                        self._finish(r, "length")
                        continue
                    if not self._ensure_capacity(r.pages, need):
                        continue
                    self._page_np[r.slot, : len(r.pages)] = r.pages
                    cand.append(r)
            cand = cand[: self._bucket(len(cand))]
            t0 = time.perf_counter()
            B = self._bucket(len(cand))
            buf = np.zeros((B, C), np.int32)
            starts = np.zeros((B,), np.int32)
            lens = np.zeros((B,), np.int32)
            idx = np.zeros((B,), np.int32)  # padding rows borrow slot 0's table
            for k, req in enumerate(cand):
                if req.state == "decode":
                    buf[k, 0] = self._last_np[req.slot]
                    starts[k] = self._ctx_np[req.slot]
                    lens[k] = 1
                    idx[k] = req.slot
                    continue
                chunk = req.prefill_source[req.done: req.done + C]
                buf[k, : len(chunk)] = chunk
                starts[k] = req.done
                lens[k] = len(chunk)
                idx[k] = req.slot
            self.kv, nxt, logits = prefill_step(
                self.params, self.kv, self.cfg, self._dev(buf), self._dev(starts),
                self._dev(lens), self._dev(self._page_np[idx]), self.quant,
                slot_ids=self._dev(idx), **self._prefill_extras(cand, B, idx),
            )
            if any(r.sampling.temperature > 0 for r in cand):
                # a prefill row's first token sits at stream position
                # len(prefill_source), a mix row's next at ctx + 1: the
                # positions the decode loops draw them at
                tarr, karr, parr, marr, sarr = self._pack_sampling(cand, B)
                posn = np.zeros((B,), np.int32)
                for k, r in enumerate(cand):
                    posn[k] = (starts[k] + 1 if r.state == "decode"
                               else len(r.prefill_source))
                nxt = sample_tokens_at(logits, self._dev(sarr), self._dev(posn),
                                       self._dev(tarr), self._dev(karr), self._dev(parr),
                                       self._dev(marr))
            nxt_np = nxt.cpu().numpy()
            did = True
            for k, req in enumerate(cand):
                if req.state == "decode":  # a mix row: one AR token
                    tok = int(nxt_np[k])
                    self._commit_tokens(req, [tok], tok, int(starts[k]) + 1)
                    if self.tables is not None and req.state != "finished":
                        self._roll_tail(req.slot, [tok])
                    self.metrics.decode_steps += 1
                    self.metrics.mixed_rows += 1
                    continue
                req.done += int(lens[k])
                if req.done >= len(req.prefill_source):
                    self._finish_prefill(req, int(nxt_np[k]))
            self.metrics.prefill_time += time.perf_counter() - t0

    def _prefill_extras(self, cand, B: int, idx) -> dict:
        """The batch's multimodal embeddings and positions (when a row has
        them) and GLM ids, as prefill_step takes them."""
        out = {}
        mm = [r for r in cand if r.state == "prefill" and r.mm_embeds is not None]
        if mm:
            M = max(len(r.mm_positions) for r in mm)
            me = np.zeros((B, M, self.cfg.hidden_size), np.float32)
            mp = np.full((B, M), -1, np.int32)
            for k, r in enumerate(cand):
                if r.state == "prefill" and r.mm_embeds is not None:
                    e = r.mm_embeds
                    e = e.float().cpu().numpy() if isinstance(e, torch.Tensor) else e
                    me[k, : len(r.mm_positions)] = e
                    mp[k, : len(r.mm_positions)] = r.mm_positions
            out.update(mm_embeds=self._dev(me), mm_pos=self._dev(mp))
        if self._glm:
            out["glm_ids"] = self._dev(self._glm_np[idx])
        return out

    def _finish_prefill(self, req: Request, first: int) -> None:
        resumed = bool(req.output_ids)  # a preempted request replaying its KV
        if resumed:
            # already committed; re-seed decode
            first = req.output_ids[len(req.output_ids) - 1 - req.replay]
        else:
            req.last_token = first
            req.first_token_t = time.perf_counter()
            req.emit([first])
            self.metrics.ttft.append(req.first_token_t - req.arrival_t)
        req.state = "decode"
        self._last_np[req.slot] = first
        self._ctx_np[req.slot] = len(req.prefill_source)
        if self.prefix_cache is not None and req.mm_embeds is None:
            # publish this prompt's full pages for later shared-prefix hits
            self.prefix_cache.register(req.prefill_source, req.pages)
        if self.tables is not None:
            seed = req.prefill_source + [first]
            if not resumed:  # a resume replays tokens the tables already saw
                # the exact seed: the JAX package pads it to a power of two
                # only to reuse compiled programs (same windows either way)
                n = min(len(seed), self.ecfg.max_seq_len + 1)
                update_tables_seq(self.tables, self.tcfg,
                                  self._dev(np.asarray(seed[:n], np.int32)), n)
            TAIL = self._tails.shape[1]
            self._tails[req.slot] = -1
            tail = seed[-TAIL:]
            self._tails[req.slot, -len(tail):] = tail
        self._maybe_finish(req)

    # ---- decode ----

    def _bucket(self, n: int) -> int:
        for b in self.ecfg.decode_buckets:
            if b >= n:
                return min(b, self.ecfg.max_concurrency)
        return self.ecfg.max_concurrency

    def calibrate_kv_scales(self, prompts: Sequence[Sequence[int]]) -> None:
        """Amax-calibrate the static fp8 KV scales (kv_quant='fp8').

        Prefill the calibration prompts into a throwaway bf16 arena, take
        the per-(layer, kv head) K/V amax over the written pages, and
        rebuild the e4m3 arena with scale = 1.25 * amax / 448 (headroom:
        later activations may exceed the calibration amax; anything past it
        saturates at the write)."""
        if self.ecfg.kv_quant != "fp8" or self.cfg.is_mla:
            raise ValueError("calibration is for the static fp8 arena (kv_quant='fp8'; "
                             "an MLA model's arena has no fp8 form)")
        cal_ecfg = dataclasses.replace(self.ecfg, kv_quant="none")
        kv = init_kv_cache(self.cfg, cal_ecfg, dtype=torch.bfloat16, device=self.device)
        P = self.ecfg.pages_per_req
        ps = self.ecfg.page_size
        C = min(self.ecfg.prefill_chunk, self.ecfg.max_seq_len)
        used = 1  # page 0 is the null page
        for p in prompts:
            p = list(p)[: self.ecfg.max_seq_len - 1]
            need = -(-len(p) // ps)
            if used + need > self.ecfg.num_pages:
                break  # arena full: calibrate on what fits (no page reuse)
            pt_np = np.zeros((1, P), np.int32)
            pt_np[0, :need] = np.arange(used, used + need, dtype=np.int32)
            used += need
            done = 0
            while done < len(p):
                chunk = p[done: done + C]
                buf = np.zeros((1, C), np.int32)
                buf[0, : len(chunk)] = chunk
                kv, _, _ = prefill_step(
                    self.params, kv, self.cfg, self._dev(buf),
                    self._dev(np.array([done], np.int32)),
                    self._dev(np.array([len(chunk)], np.int32)),
                    self._dev(pt_np), self.quant,
                )
                done += len(chunk)
        Hk, D = self.cfg.num_key_value_heads, self.cfg.head_dim

        def amax(pages):  # [L, np, ps, Hk*D] -> [L, Hk] f32, one layer at a time
            # only the prompts' pages: the null page holds whatever padding
            # rows wrote last, which on the card is not even deterministic
            return np.stack([
                pages[li, 1:used].abs().reshape(-1, Hk, D).amax(dim=(0, 2))
                .float().cpu().numpy() for li in range(pages.shape[0])])

        k_amax, v_amax = amax(kv["k"]), amax(kv["v"])
        del kv
        self.kv = init_kv_cache(self.cfg, self.ecfg, dtype=self.dtype, device=self.device)
        self.kv["k_scale"] = self._dev(np.maximum(k_amax * 1.25 / 448.0, 1e-8)
                                       .astype(np.float32))
        self.kv["v_scale"] = self._dev(np.maximum(v_amax * 1.25 / 448.0, 1e-8)
                                       .astype(np.float32))

    def _drain_pending(self) -> None:
        """Read back and commit the in-flight AR burst (if any)."""
        p, self._pending = self._pending, None
        if p is None:
            return
        t0 = time.perf_counter()
        toks_np = p["toks"].cpu().numpy()  # waits for the burst
        last_np = p["last"].cpu().numpy()
        ctx_np = p["ctx"].cpu().numpy()
        feeds = []
        for k, (i, req) in enumerate(zip(p["rows"], p["reqs"])):
            if req.state == "finished" or req.slot != i:
                continue  # finished (or slot reused) while in flight
            emitted = [int(t) for t in toks_np[k] if t >= 0]
            self._commit_tokens(req, emitted, last_np[k], ctx_np[k])
            if self.tables is not None and emitted:
                feeds.append((i, emitted))
        if feeds:
            t1 = time.perf_counter()
            self._feed_tables_batch(feeds)
            self.metrics.table_update_time += time.perf_counter() - t1
            self.metrics.table_updates += 1
        self.metrics.decode_steps += p["K"]
        dt = time.perf_counter() - t0
        self.metrics.decode_time += dt
        self.metrics.drain_time += dt

    def _roll_tail(self, slot: int, toks: List[int]) -> List[int]:
        """Append ``toks`` to the slot's recent-token window (the draft
        retrieval key); returns the valid window before them."""
        TAIL = self._tails.shape[1]
        prev = [t for t in self._tails[slot] if t >= 0]
        tail = (prev + toks)[-TAIL:]
        self._tails[slot] = -1
        self._tails[slot, -len(tail):] = tail
        return prev

    def _pack_sampling(self, reqs, B: int):
        """Per-row sampling arrays (temperature, top_k, top_p, min_p, seed)
        for the prefill's first tokens, mix rows and decode bursts alike."""
        tarr = np.zeros((B,), np.float32)
        karr = np.zeros((B,), np.int32)
        parr = np.ones((B,), np.float32)
        marr = np.zeros((B,), np.float32)
        sarr = np.zeros((B,), np.int32)
        for k, r in enumerate(reqs):
            sp = r.sampling
            tarr[k], karr[k], parr[k] = sp.temperature, sp.top_k, sp.top_p
            marr[k], sarr[k] = sp.min_p, sp.seed
        return tarr, karr, parr, marr, sarr

    def _feed_tables_batch(self, feeds) -> None:
        """AR bursts feed the draft tables too: one streamed update over
        every row of the drained burst."""
        TAIL = self._tails.shape[1]
        W = TAIL + max(self.ecfg.decode_burst, self.ecfg.decode_burst_idle)
        B = self.ecfg.max_concurrency
        bufs = np.full((B, W), -1, np.int32)
        n_valid = np.zeros((B,), np.int32)
        lo = np.zeros((B,), np.int32)
        hi = np.zeros((B,), np.int32)
        for k, (i, emitted) in enumerate(feeds):
            prev = self._roll_tail(i, emitted)
            seq = prev + emitted
            n = min(len(seq), W)
            bufs[k, :n] = seq[:W]
            n_valid[k] = n
            lo[k] = len(prev)
            hi[k] = n
        update_tables_batch(self.tables, self.tcfg, self._dev(bufs), n_valid, lo, hi)

    def _try_chain(self) -> bool:
        """Dispatch the next AR burst straight from the pending burst's
        device tensors, then drain the pending one. False (nothing drained)
        when the batch changed and the normal rebuild path must run."""
        p = self._pending
        if p is None:
            return False
        rows = [i for i, r in enumerate(self._slots)
                if r is not None and r.state == "decode"]
        Kp = p["K"]  # the pending burst's length (its ctx advance bound)
        K = Kp
        with self._lock:
            idle = not self._queue
        if idle or all(r is not None for r in self._slots):
            K = max(K, self.ecfg.decode_burst_idle)
            K = 1 << (max(K, 1).bit_length() - 1)
        msl = self.ecfg.max_seq_len
        # subset chaining: rows that finished since the pending burst was
        # built stay in the batch as deactivated lanes; rebuild once half of
        # the lanes are dead
        live = set(rows)
        prev_rows = list(p["rows"])
        idx_of = {r: k for k, r in enumerate(prev_rows)}
        subset_ok = (
            len(rows) > 0
            and live <= set(prev_rows)
            # identity, not just the slot: a freed slot may hold a new request
            and all(self._slots[i] is p["reqs"][idx_of[i]] for i in rows)
        )
        ok = (
            subset_ok
            and 2 * len(rows) >= len(prev_rows)
            and (self.tables is None or len(rows) > self.ecfg.use_spec_min_batch_size)
            and p["chain_ok"]
            # conservative: the pending burst advances <= Kp, the new one <= K
            and all(int(self._ctx_np[i]) + Kp + K + 2 <= msl for i in rows)
        )
        if not ok:
            return False
        act_in = p["act"]
        if len(rows) != len(prev_rows):
            keep = np.ones((int(act_in.shape[0]),), bool)
            for k, r in enumerate(prev_rows):
                keep[k] = r in live
            act_in = act_in & self._dev(keep)
        # page headroom with the stale committed ctx (covers both bursts)
        pts_dirty = False
        for i in rows:
            req = self._slots[i]
            held = len(req.pages)
            if not self._ensure_capacity(req.pages, int(self._ctx_np[i]) + Kp + K + 2):
                return False
            if len(req.pages) != held:
                self._page_np[i, : len(req.pages)] = req.pages
                pts_dirty = True
        t0 = time.perf_counter()
        pts = self._dev(self._page_np[list(p["idx"])]) if pts_dirty else p["pts"]
        # the budget left rides on the card from the pending burst
        self.kv, toks, last2, ctx2, act2, bleft2 = multistep_decode(
            self.params, self.kv, self.cfg, p["last"], p["ctx"], act_in, pts,
            n_steps=K, eos=p["eos"], spec=self.quant,
            budget=p["bleft"], slot_ids=p["sid"], **p["samp"],
        )
        newp = dict(p, K=K, toks=toks, last=last2, ctx=ctx2, act=act2, pts=pts,
                    bleft=bleft2)
        self.metrics.chained_bursts += 1
        self.metrics.decode_time += time.perf_counter() - t0
        self._drain_pending()
        self._pending = newp
        return True

    def _decode_phase(self) -> bool:
        if self._try_chain():
            return True
        self._drain_pending()
        rows = [i for i, r in enumerate(self._slots)
                if r is not None and r.state == "decode"]
        if not rows:
            return False
        t0 = time.perf_counter()
        K = self._decode_burst
        use_spec = (
            self.tables is not None
            and len(rows) <= self.ecfg.use_spec_min_batch_size
            # chunk-level gate: after a burst whose drafts ran dry, decode
            # stays on AR bursts for spec_cooldown_bursts before retrying
            and self._spec_cooldown == 0
            # the penalty depends on the accepted history inside a step:
            # such rows decode by AR bursts
            and all(self._slots[i].sampling.repetition_penalty == 1.0 for i in rows)
        )
        if self._spec_cooldown and self.tables is not None:
            self._spec_cooldown -= 1
        Q = self.tcfg.verify_width if use_spec else 1
        # rows that cannot fit one AR step (ctx + 2) have reached
        # max_seq_len; for the rest a spec width that would overrun it falls
        # back to AR instead of finishing the request as "length"
        msl = self.ecfg.max_seq_len
        for i in list(rows):
            if int(self._ctx_np[i]) + 2 > msl:
                self._finish(self._slots[i], "length")
                rows.remove(i)
        if not rows:
            return True
        if use_spec and any(int(self._ctx_np[i]) + 2 * Q > msl for i in rows):
            use_spec = False
            Q = 1
        # a longer burst delays no admission when the queue is empty or the
        # batch is full
        with self._lock:
            idle = not self._queue
        slots_full = all(r is not None for r in self._slots)
        if idle or slots_full:
            K = max(K, self.ecfg.decode_burst_idle)
        kept, parked, K_fit = self._fit_burst(rows, K, Q)
        if not kept and use_spec:
            # the verify window outgrows the free pages for every row: this
            # burst decodes by AR, which gives the same tokens (preempting
            # instead re-admits the victim into the same state without end)
            use_spec, Q = False, 1
            kept, parked, K_fit = self._fit_burst(rows, K, Q)
        rows, K = kept, K_fit
        if not rows:
            if parked:
                # nothing can run and pages are exhausted: preempt the
                # youngest starved request (recomputed later); a lone
                # request that still cannot fit has outgrown the arena
                victim = self._slots[max(parked, key=lambda i: self._slots[i].arrival_t)]
                if sum(1 for r in self._slots if r is not None) > 1:
                    self._preempt(victim)
                else:
                    self._finish(victim, "length")
            return True

        B = self._bucket(len(rows))
        rows = rows[:B]
        idx = np.zeros((B,), np.int32)
        idx[: len(rows)] = rows
        last = self._dev(self._last_np[idx])
        ctx = self._dev(self._ctx_np[idx])
        active = self._dev(np.arange(B) < len(rows))
        pts = self._dev(self._page_np[idx])
        eos_np = np.full((B,), -2, np.int32)
        # per-row emission budget: rows stop on the card at max_new_tokens
        rem_np = np.ones((B,), np.int32)
        for k, i in enumerate(rows):
            r = self._slots[i]
            e = r.sampling.eos_token_id
            eos_np[k] = self.ecfg.eos_token_id if e is None else e
            rem_np[k] = max(1, r.sampling.max_new_tokens - len(r.output_ids) + r.replay)
        eos = self._dev(eos_np)
        budget = self._dev(rem_np)
        sid = self._dev(idx)  # padding rows borrow slot 0 (inactive: no state)
        # per-row sampling arrays on both routes (counter-mode draws make the
        # sampled spec stream the AR stream)
        samp = {}
        if any(self._slots[i].sampling.temperature > 0 for i in rows):
            arrs = self._pack_sampling([self._slots[i] for i in rows], B)
            samp = dict(zip(("temperature", "top_k", "top_p", "min_p", "seeds"),
                            map(self._dev, arrs)))
        if self._glm:  # rides with the burst, as chained bursts reuse samp
            samp["glm_ids"] = self._dev(self._glm_np[idx])

        if use_spec:
            tails = self._dev(self._tails[idx])
            (self.kv, self.tables, out_toks, n_acc, last2, ctx2, _, tails2,
             wides) = multistep_spec_decode(
                self.params, self.kv, self.tables, self.cfg, self.tcfg, last, ctx,
                active, tails, pts, n_steps=K, eos=eos, spec=self.quant,
                budget=budget, slot_ids=sid, **samp,
            )
            out_np = out_toks.cpu().numpy()
            acc_np = n_acc.cpu().numpy()
            last_np, ctx_np = last2.cpu().numpy(), ctx2.cpu().numpy()
            self._tails[idx] = tails2.cpu().numpy()
            for k, i in enumerate(rows):
                req = self._slots[i]
                toks: List[int] = []
                for s in range(out_np.shape[1]):
                    toks.extend(int(x) for x in out_np[k, s, : int(acc_np[k, s])])
                self._commit_tokens(req, toks, last_np[k], ctx_np[k])
                self.metrics.spec_steps += out_np.shape[1]
                self.metrics.spec_accepted += len(toks)
            wides_np = wides.cpu().numpy()
            self.metrics.spec_wide_steps += int(wides_np.sum())
            if (self.ecfg.spec_cooldown_bursts
                    and wides_np.mean() < self.ecfg.spec_gate_threshold):
                self._spec_cooldown = self.ecfg.spec_cooldown_bursts
        else:
            pen = {}
            if any(self._slots[i].sampling.repetition_penalty != 1.0 for i in rows):
                rp = np.ones((B,), np.float32)
                seen = np.zeros((B, self.cfg.vocab_size), bool)
                for k, i in enumerate(rows):
                    req = self._slots[i]
                    rp[k] = req.sampling.repetition_penalty
                    seen[k, req.input_ids] = True
                    # a replaying hybrid regenerates its last outputs: they
                    # join the mask as the burst emits them again
                    seen[k, req.output_ids[: len(req.output_ids) - req.replay]] = True
                pen = dict(rep_penalty=self._dev(rp), seen_mask=self._dev(seen))
            self.kv, toks, last2, ctx2, act2, bleft = multistep_decode(
                self.params, self.kv, self.cfg, last, ctx, active, pts,
                n_steps=K, eos=eos, spec=self.quant, budget=budget, slot_ids=sid,
                **samp, **pen,
            )
            # no readback here: the next decode phase chains off this
            # burst's tensors while the readback of this one waits
            self._pending = dict(
                rows=tuple(rows), reqs=[self._slots[i] for i in rows], K=K,
                toks=toks, last=last2, ctx=ctx2, act=act2, pts=pts, eos=eos,
                idx=tuple(int(x) for x in idx), bleft=bleft, sid=sid, samp=samp,
                # the seen mask takes the drained outputs: no chaining
                chain_ok=not pen,
            )  # decode_steps are counted at drain time
        self.metrics.decode_time += time.perf_counter() - t0
        return True

    def _fit_burst(self, rows: List[int], K: int, Q: int):
        """Shrink a burst of K steps of width Q so that every row's ctx + K*Q
        + Q fits max_seq_len, then give each row the pages it needs (+Q:
        drafts are written before verify). A row whose pages cannot cover
        the burst shrinks it to what fits, else is parked for this step.
        Returns (rows kept, rows parked, K)."""
        msl, ps = self.ecfg.max_seq_len, self.ecfg.page_size
        K = min(K, min((msl - int(self._ctx_np[i]) - Q) // Q for i in rows))
        K = 1 << (max(K, 1).bit_length() - 1)
        kept, parked = [], []
        for i in rows:
            req = self._slots[i]
            ctx = int(self._ctx_np[i])
            if self._ensure_capacity(req.pages, ctx + K * Q + Q):
                kept.append(i)
                self._page_np[i, : len(req.pages)] = req.pages
                continue
            cap = len(req.pages) * ps + self.allocator.free_pages * ps
            k_fit = min(K, (cap - ctx - Q) // Q)
            if k_fit >= 1:
                k_fit = 1 << (int(k_fit).bit_length() - 1)
            if k_fit >= 1 and self._ensure_capacity(req.pages, ctx + k_fit * Q + Q):
                K = k_fit  # the burst shrinks for the whole batch
                kept.append(i)
                self._page_np[i, : len(req.pages)] = req.pages
            else:
                parked.append(i)
        return kept, parked, K

    def _preempt(self, req: Request) -> None:
        """Reclaim a starved request's pages and requeue it for recompute:
        prompt + outputs replay through chunked prefill, or for a hybrid the
        prompt alone, decode regenerating the outputs."""
        if self.cfg.linear_attention and req.output_ids:
            req.replay = len(req.output_ids) - 1
        self.allocator.free(req.pages)
        req.pages = []
        self._slots[req.slot] = None
        req.slot = None
        req.state = "queued"
        req.done = 0
        self.metrics.preempted += 1
        with self._lock:
            self._queue.appendleft(req)

    def _commit_tokens(self, req: Request, toks: List[int], last, ctx):
        i = req.slot
        self._last_np[i] = last
        self._ctx_np[i] = ctx
        if req.replay and toks:
            # regenerated outputs of a resumed request: the same bits give
            # the same tokens, so a difference is a broken invariant
            n = min(req.replay, len(toks))
            start = len(req.output_ids) - req.replay
            if toks[:n] != req.output_ids[start: start + n]:
                raise RuntimeError(f"request {req.rid}: the replay after preemption "
                                   f"regenerated other tokens than it committed")
            req.replay -= n
            toks = toks[n:]
        eos = req.sampling.eos_token_id
        if eos is None:
            eos = self.ecfg.eos_token_id
        # the budget cut first: an eos or stop past max_new_tokens must not
        # set a finish reason whose tokens are then dropped
        room = req.sampling.max_new_tokens - len(req.output_ids)
        toks = toks[:room]
        if eos in toks:
            toks = toks[: toks.index(eos) + 1]
        if req.sampling.stop_sequences and toks:
            # truncate at the first completed stop sequence; only a bounded
            # tail of the history can take part
            max_stop = max(len(s) for s in req.sampling.stop_sequences)
            tail = list(req.output_ids[-(max_stop - 1):]) if max_stop > 1 else []
            for j, t in enumerate(toks):
                tail.append(t)
                for seq in req.sampling.stop_sequences:
                    if len(seq) <= len(tail) and tail[-len(seq):] == list(seq):
                        toks = toks[: j + 1]
                        req.finish_reason = "stop_sequence"
                        break
                if req.finish_reason == "stop_sequence":
                    break
        if toks:
            req.emit(toks)
            req.last_token = toks[-1]
        self._maybe_finish(req)

    def _maybe_finish(self, req: Request):
        eos = req.sampling.eos_token_id
        if eos is None:
            eos = self.ecfg.eos_token_id
        if req.finish_reason == "stop_sequence":
            self._finish(req, "stop_sequence")
        elif req.output_ids and req.output_ids[-1] == eos:
            self._finish(req, "stop")
        elif len(req.output_ids) >= req.sampling.max_new_tokens:
            self._finish(req, "length")

    def _finish(self, req: Request, reason: str):
        req.finish_t = time.perf_counter()
        self.metrics.finished += 1
        self.metrics.generated_tokens += len(req.output_ids)
        self.allocator.free(req.pages)
        req.pages = []
        self._slots[req.slot] = None
        req.finish(reason)
