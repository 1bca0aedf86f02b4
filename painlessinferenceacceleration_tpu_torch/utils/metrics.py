"""Engine metrics.

Port (a copy) of ``painlessinferenceacceleration_tpu/utils/metrics.py``,
plus ``table_update_time``/``table_updates``: the host-clock cost of the
eager draft-table updates at each burst drain, and ``mixed_rows``: decode
rows that rode in mix prefill batches (each also counts in
``decode_steps``, as in the JAX package). The times are host clocks
around work that ends in a device sync (a drain reads the burst's tokens
back), so they include the device time they wait for.
"""

from __future__ import annotations

import dataclasses
import time
from typing import List


@dataclasses.dataclass
class EngineMetrics:
    start_t: float = dataclasses.field(default_factory=time.perf_counter)
    finished: int = 0
    generated_tokens: int = 0
    prefill_time: float = 0.0
    decode_time: float = 0.0
    drain_time: float = 0.0  # burst drains (inside decode_time)
    table_update_time: float = 0.0  # draft-table updates at drains (inside drain_time)
    table_updates: int = 0  # drains that updated the tables
    decode_steps: int = 0
    spec_steps: int = 0
    spec_accepted: int = 0
    # verify steps whose drafts were retrievable (the probe, not a count of
    # steps that ran wide: the non-adaptive loop always runs wide)
    spec_wide_steps: int = 0
    preempted: int = 0
    prefix_hit_tokens: int = 0  # prompt tokens served from the prefix cache
    chained_bursts: int = 0  # bursts dispatched off the previous burst's tensors
    mixed_rows: int = 0  # decode rows carried by mix prefill batches
    ttft: List[float] = dataclasses.field(default_factory=list)

    @property
    def mean_accepted_per_step(self) -> float:
        return self.spec_accepted / self.spec_steps if self.spec_steps else 0.0

    @property
    def throughput(self) -> float:
        dt = time.perf_counter() - self.start_t
        return self.generated_tokens / dt if dt > 0 else 0.0

    @property
    def p50_ttft(self) -> float:
        if not self.ttft:
            return 0.0
        s = sorted(self.ttft)
        return s[len(s) // 2]

    def summary(self) -> dict:
        return {
            "finished": self.finished,
            "generated_tokens": self.generated_tokens,
            "throughput_tok_s": round(self.throughput, 2),
            "p50_ttft_s": round(self.p50_ttft, 4),
            "prefill_time_s": round(self.prefill_time, 3),
            "decode_time_s": round(self.decode_time, 3),
            "drain_time_s": round(self.drain_time, 3),
            "table_update_time_s": round(self.table_update_time, 3),
            "table_updates": self.table_updates,
            "decode_steps": self.decode_steps,
            "spec_steps": self.spec_steps,
            "mean_accepted_per_step": round(self.mean_accepted_per_step, 2),
            "preempted": self.preempted,
            "prefix_hit_tokens": self.prefix_hit_tokens,
            "chained_bursts": self.chained_bursts,
            "mixed_rows": self.mixed_rows,
        }
