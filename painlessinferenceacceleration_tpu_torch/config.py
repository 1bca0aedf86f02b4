"""Model / engine configuration for the PyTorch port.

A copy of the llama-family part of ``painlessinferenceacceleration_tpu.config``
(the port imports nothing from the JAX package). Field names follow HF
``config.json`` keys, as in the JAX package, so one set of keyword arguments
builds the same model in both packages.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Architecture of a llama-family decoder-only transformer."""

    model_type: str = "llama"
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    num_key_value_heads: int = 32
    head_dim: int = 0  # 0 -> hidden_size // num_attention_heads
    rms_norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    tie_word_embeddings: bool = False
    hidden_act: str = "silu"
    # HF rope_scaling dict; only the default rope type is ported so far
    rope_scaling: Optional[tuple] = None

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(
                self, "head_dim", self.hidden_size // self.num_attention_heads
            )
        if isinstance(self.rope_scaling, dict):
            object.__setattr__(
                self, "rope_scaling", tuple(sorted(self.rope_scaling.items()))
            )

    def rope_scaling_dict(self) -> Optional[dict]:
        return dict(self.rope_scaling) if self.rope_scaling else None

    @classmethod
    def tiny(cls, **over) -> "ModelConfig":
        """A tiny random-weight llama for CPU tests (same as the JAX preset)."""
        kw = dict(
            vocab_size=512,
            hidden_size=64,
            intermediate_size=128,
            num_hidden_layers=3,
            num_attention_heads=4,
            num_key_value_heads=2,
        )
        kw.update(over)
        return cls(**kw)

    @classmethod
    def llama2_7b(cls) -> "ModelConfig":
        return cls()


@dataclasses.dataclass
class EngineConfig:
    """KV-arena sizing (the part of the JAX ``EngineConfig`` this path reads)."""

    page_size: int = 64  # tokens per KV page
    max_seq_len: int = 2048  # max context per request
    max_concurrency: int = 64  # max resident requests
    num_pages: int = 0  # 0 -> sized from max_concurrency * max_seq_len

    def __post_init__(self):
        if self.num_pages == 0:
            # +1: page 0 is the reserved null page (padding page-table entries)
            self.num_pages = self.max_concurrency * self.pages_per_req + 1

    @property
    def pages_per_req(self) -> int:
        return -(-self.max_seq_len // self.page_size)
