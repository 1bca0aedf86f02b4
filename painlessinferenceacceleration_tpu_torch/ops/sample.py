"""Token sampling: greedy, temperature / top-k / top-p / min-p, the
repetition penalty and target scoring.

Port of ``painlessinferenceacceleration_tpu/ops/sample.py``. The JAX package
needs no kernel here (its sampler is a few fused vector ops) and neither
does the port: every function is torch ops on the logits' device.

Two things differ from the JAX package, both for lossless sampled
lookahead, where the verify step must draw at each node what the AR loop
draws at that stream position:

- **Counter-mode randomness of our own.** JAX draws the token at stream
  position p from ``fold_in(PRNGKey(seed), p)`` (threefry), which torch
  cannot reproduce. Here the uniform of vocabulary entry i is an integer
  hash of (seed, position, i) in int64 torch ops (two rounds of a 32-bit
  multiply-xorshift mixer, multipliers below 2**31 so no product
  overflows), the same bits on the CPU and on the card. The draw is
  Gumbel-max in fp64, ``argmax(x + -log(-log(u)))`` with the first index
  on ties, the form ``jax.random.categorical`` takes.
- **Row results that do not depend on the batch.** torch's CUDA ``cumsum``
  and sums choose their order by the number of rows (a one-row cumsum even
  goes through another algorithm), so a row filtered alone could differ in
  its last bits from the same row inside a 17-wide verify. The nucleus
  therefore sums in fixed point: each kept probability, ``exp(x - max)``,
  becomes ``floor(e * 2**32) + 1`` int64 units, whose prefix sums are exact
  in any order, and the cutoff test ``cum - p < top_p`` compares integers.
  Min-p compares ``exp(x - max)`` with ``min_p`` (``p / pmax`` in exact
  arithmetic), with no sum at all. Everything else is elementwise, a sort,
  a gather or an argmax, whose results are exact. The fixed point moves the
  cumulative probability by at most V * 2**-32 (7.5e-6 at V = 32000);
  the JAX package's fp32 cumsum rounds as far.
"""

from __future__ import annotations

from typing import Optional

import torch

NEG = -1e30
_M32 = 0xFFFFFFFF
_UNITS = float(2**32)  # fixed-point units of the nucleus per unit of exp(x - max)


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """A 32-bit multiply-xorshift mixer (a bijection of [0, 2**32)) on
    int64 tensors holding 32-bit values; shifts act on non-negative values
    only, and every product stays below 2**63."""
    x = x ^ (x >> 16)
    x = (x * 0x7FEB352D) & _M32
    x = x ^ (x >> 15)
    x = (x * 0x5BD1E995) & _M32
    return x ^ (x >> 16)


def uniform_at(seeds: torch.Tensor, positions: torch.Tensor, V: int) -> torch.Tensor:
    """[N, V] fp64 uniforms in (0, 1): entry (n, i) is a pure function of
    (seeds[n], positions[n], i)."""
    dev = seeds.device
    key = _mix32(_mix32((seeds.long() & _M32) ^ 0x9E3779B9) ^ (positions.long() & _M32))
    col = torch.arange(V, dtype=torch.int64, device=dev) * 0x9E3779B1  # < 2**49
    h = _mix32(_mix32((key[:, None] + col[None, :]) & _M32) ^ 0x2545F491)
    return (h.to(torch.float64) + 0.5) * (1.0 / _UNITS)


def filtered_logits(
    logits: torch.Tensor,  # [B, V] fp32
    temperature: torch.Tensor,  # [B] (0 => greedy; clamped for the scale)
    top_k: torch.Tensor,  # [B] int (0 => off)
    top_p: torch.Tensor,  # [B] (1.0 => off)
    min_p: Optional[torch.Tensor] = None,  # [B] (0 => off)
) -> torch.Tensor:
    """Temperature-scaled logits with the HF warper chain applied in turn:
    top-k, then top-p over the top-k-filtered distribution (by column rank
    of the sorted copy, as the JAX package masks it), then min-p. Filtered
    entries are ``NEG``. A row's bits do not depend on the other rows."""
    B, V = logits.shape
    dev = logits.device
    t = temperature.to(device=dev, dtype=torch.float32).clamp(min=1e-6)[:, None]
    x = logits.to(torch.float32) / t

    # top-k: mask everything below the k-th largest
    sorted_x = torch.sort(x, dim=-1, descending=True).values
    top_k = top_k.to(device=dev, dtype=torch.int64)
    k_eff = torch.where(top_k > 0, top_k, V)
    kth = torch.gather(sorted_x, 1, (k_eff - 1).clamp(0, V - 1)[:, None])
    x = torch.where(x < kth, NEG, x)

    # top-p over the top-k-filtered distribution, in exact integer sums
    keep = torch.arange(V, device=dev)[None, :] < k_eff[:, None]
    sorted_masked = torch.where(keep, sorted_x, NEG)
    e = torch.exp(sorted_x - sorted_x[:, :1])  # in (0, 1]
    units = torch.where(keep, (e * _UNITS).to(torch.int64) + 1, 0)
    cum = torch.cumsum(units, dim=-1)
    total = cum[:, -1:].to(torch.float64)
    p = top_p.to(device=dev, dtype=torch.float64)[:, None]
    thresh = torch.ceil(p * total).to(torch.int64)
    # inside the nucleus: cum - p < top_p, a prefix of the sorted row
    n_in = ((cum - units) < thresh).sum(dim=-1, keepdim=True)
    cutoff = torch.where(n_in > 0, torch.gather(sorted_masked, 1, (n_in - 1).clamp(min=0)),
                         -NEG)
    x = torch.where(x < cutoff, NEG, x)

    if min_p is not None:
        # p < min_p * pmax  <=>  exp(x - max) < min_p
        mp = min_p.to(device=dev, dtype=torch.float32)[:, None]
        x = torch.where(torch.exp(x - sorted_x[:, :1]) < mp, NEG, x)
    return x


def sample_tokens(
    logits: torch.Tensor,  # [B, V] fp32
    generator: torch.Generator,
    temperature: torch.Tensor,  # [B] (0 => greedy)
    top_k: torch.Tensor,  # [B] (0 => off)
    top_p: torch.Tensor,  # [B] (1.0 => off)
    min_p: Optional[torch.Tensor] = None,  # [B] (0 => off)
) -> torch.Tensor:
    """Per-row parameterized sampling from ``generator`` (where JAX takes a
    key); rows with temperature 0 take the argmax. Every row runs the same
    ops, so any mix of greedy and sampled rows shares one call."""
    B, V = logits.shape
    greedy = torch.argmax(logits, dim=-1).to(torch.int32)
    x = filtered_logits(logits, temperature, top_k, top_p, min_p)
    u = torch.rand((B, V), generator=generator, dtype=torch.float64,
                   device=generator.device).to(logits.device)
    u = u.clamp(min=torch.finfo(torch.float64).tiny)
    sampled = torch.argmax(x.to(torch.float64) - torch.log(-torch.log(u)), dim=-1)
    temp = temperature.to(logits.device)
    return torch.where(temp <= 0, greedy, sampled.to(torch.int32))


def sample_tokens_at(
    logits: torch.Tensor,  # [B, V] fp32
    seeds: torch.Tensor,  # [B] per-request seeds
    positions: torch.Tensor,  # [B] stream position of the sampled token
    temperature: torch.Tensor,  # [B] (0 => greedy)
    top_k: torch.Tensor,  # [B]
    top_p: torch.Tensor,  # [B]
    min_p: Optional[torch.Tensor] = None,  # [B]
) -> torch.Tensor:
    """Counter-mode sampling: the noise of the token at stream position p
    of a request is a pure function of (seed, p), so the AR loop and the
    lookahead verify step draw the same token wherever their logits rows
    agree, and sampled lookahead reproduces the AR stream."""
    V = logits.shape[1]
    dev = logits.device
    greedy = torch.argmax(logits, dim=-1).to(torch.int32)
    x = filtered_logits(logits, temperature, top_k, top_p, min_p)
    u = uniform_at(seeds.to(dev), positions.to(dev), V)
    sampled = torch.argmax(x.to(torch.float64) - torch.log(-torch.log(u)), dim=-1)
    sampled = sampled.to(torch.int32)
    return torch.where(temperature.to(dev) <= 0, greedy, sampled)


def apply_repetition_penalty(
    logits: torch.Tensor,  # [B, V]
    seen_mask: torch.Tensor,  # [B, V] bool: token appeared in prompt / output
    penalty: torch.Tensor,  # [B] (1.0 => off)
) -> torch.Tensor:
    """HF repetition penalty: a seen token's logit is divided by the
    penalty when positive, multiplied when negative."""
    p = penalty.to(device=logits.device, dtype=logits.dtype)[:, None]
    pen = torch.where(logits > 0, logits / p, logits * p)
    return torch.where(seen_mask, pen, logits)


def target_logprobs(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """log P(target | context) per position (PPL scoring, option ranking).

    logits: [T, V] for the positions preceding each target; targets: [T]."""
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    return torch.gather(logp, 1, targets.long()[:, None])[:, 0]
