"""Dataset readers: jsonl, shareGPT and seeded synthetic traffic.

Port (a copy) of ``painlessinferenceacceleration_tpu/utils/reader.py``;
``dummy_requests`` draws the same requests for a seed (numpy's generator).
"""

from __future__ import annotations

import json
from typing import List, Optional, Tuple

import numpy as np


def read_jsonl(path: str, prompt_key: str = "prompt",
               output_key: Optional[str] = None, limit: int = 0):
    """Yield (prompt, output|None) pairs from a jsonl file."""
    n = 0
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            obj = json.loads(line)
            yield obj.get(prompt_key), obj.get(output_key) if output_key else None
            n += 1
            if limit and n >= limit:
                return


def read_sharegpt(path: str, limit: int = 0) -> List[Tuple[str, str]]:
    """shareGPT-format conversations -> (human prompt, gpt reply) pairs:
    the first human / gpt exchange of each conversation."""
    with open(path) as f:
        data = json.load(f)
    out = []
    for conv in data:
        turns = conv.get("conversations", [])
        prompt = reply = None
        for t in turns:
            if t.get("from") == "human" and prompt is None:
                prompt = t.get("value", "")
            elif t.get("from") == "gpt" and prompt is not None:
                reply = t.get("value", "")
                break
        if prompt and reply:
            out.append((prompt, reply))
        if limit and len(out) >= limit:
            break
    return out


def dummy_requests(n: int, vocab: int, prompt_len=(16, 512),
                   output_len=(16, 512), seed: int = 0):
    """Synthetic shareGPT-shaped traffic: log-normal prompt and output
    lengths, uniform token ids; returns (prompts, output lengths)."""
    rng = np.random.default_rng(seed)
    plens = np.clip(rng.lognormal(5.0, 1.0, n), *prompt_len).astype(int)
    olens = np.clip(rng.lognormal(5.3, 0.9, n), *output_len).astype(int)
    prompts = [rng.integers(10, vocab - 10, p).tolist() for p in plens]
    return prompts, olens.tolist()
