"""Request objects.

Port (a copy) of ``painlessinferenceacceleration_tpu/engine/request.py``.
One class is both the scheduling record (the chunked-prefill cursor
``done``) and the user-facing handle (output tokens, finish reason, stream
queue, and for a scoring request the logprobs of its ``target_ids``). A
multimodal request carries precomputed embeddings (``mm_embeds`` [M, E])
and the prompt positions they replace (``mm_positions``).
"""

from __future__ import annotations

import dataclasses
import queue
from typing import List, Optional


@dataclasses.dataclass
class SamplingParams:
    temperature: float = 0.0  # 0 => greedy
    top_k: int = 0
    top_p: float = 1.0
    min_p: float = 0.0
    repetition_penalty: float = 1.0
    max_new_tokens: int = 256
    eos_token_id: Optional[int] = None  # None: the engine's eos_token_id
    # per-request seed: the token at stream position p draws from the noise
    # of (seed, p) (ops/sample.py), so runs repeat and sampled lookahead
    # reproduces the sampled AR stream
    seed: int = 0
    # generation finishes when the output ends with any of these
    stop_sequences: Optional[List[List[int]]] = None


class Request:
    """One generation request moving through the engine.

    States: queued -> prefill (chunk cursor ``done`` advances) -> decode ->
    finished. A request with ``target_ids`` is scored instead (PPL
    scoring, option ranking): one forward over prompt + targets fills
    ``target_logprobs`` and finishes it with reason ``"score"``, no decode.
    """

    __slots__ = (
        "rid", "input_ids", "sampling", "output_ids", "state", "done",
        "pages", "slot", "last_token", "stream_queue", "target_ids",
        "target_logprobs", "finish_reason", "arrival_t", "first_token_t", "finish_t", "replay",
        "mm_embeds", "mm_positions",
    )

    def __init__(
        self,
        rid: int,
        input_ids: List[int],
        sampling: Optional[SamplingParams] = None,
        stream: bool = False,
        target_ids: Optional[List[int]] = None,
        mm_embeds=None,  # [M, E] precomputed multimodal embeddings (numpy or torch)
        mm_positions: Optional[List[int]] = None,  # the prompt positions they take
    ):
        self.rid = rid
        self.input_ids = list(input_ids)
        self.sampling = sampling or SamplingParams()
        self.output_ids: List[int] = []
        self.state = "queued"
        self.done = 0  # prefill chunk cursor
        # committed outputs that decode regenerates after a resume (a
        # hybrid's), checked against output_ids instead of emitted again
        self.replay = 0
        self.pages: List[int] = []
        self.slot: Optional[int] = None  # decode-batch slot index
        self.last_token: Optional[int] = None
        self.stream_queue: Optional[queue.Queue] = queue.Queue() if stream else None
        self.target_ids = target_ids
        self.target_logprobs: List[float] = []
        self.finish_reason: Optional[str] = None
        self.arrival_t: float = 0.0
        self.first_token_t: float = 0.0
        self.finish_t: float = 0.0
        self.mm_embeds = mm_embeds
        self.mm_positions = mm_positions

    @property
    def prompt_len(self) -> int:
        return len(self.input_ids)

    @property
    def prefill_source(self) -> List[int]:
        """Tokens to (re)prefill. A preempted request replays prompt +
        committed outputs except the last ``replay + 1``, the first of which
        seeds decode again."""
        if self.output_ids:
            return self.input_ids + self.output_ids[: len(self.output_ids) - 1 - self.replay]
        return self.input_ids

    @property
    def ctx_len(self) -> int:
        return self.done + len(self.output_ids)

    def emit(self, tokens: List[int]) -> None:
        self.output_ids.extend(tokens)
        if self.stream_queue is not None:
            for t in tokens:
                self.stream_queue.put(t)

    def finish(self, reason: str) -> None:
        self.state = "finished"
        self.finish_reason = reason
        if self.stream_queue is not None:
            self.stream_queue.put(None)  # sentinel
