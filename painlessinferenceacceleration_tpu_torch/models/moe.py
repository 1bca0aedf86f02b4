"""Mixture-of-Experts decoder layers (mixtral / qwen3-moe / deepseek-lite
class): the router, and the expert MLP by three routes.

Port of ``painlessinferenceacceleration_tpu/models/moe.py``. Experts are
stacked tensors ``[n_exp, in, out]`` (or weight-only quantized dicts with
that lead axis). The default route *scans over experts*: every expert's
weights are read once and the router-weighted contribution of every token
is accumulated,

    out = sum_x route_w[:, x] * mlp_x(tokens)

which suits decode, where a batch touches about every expert anyway.
Prefill-size batches of native experts on the card take the grouped route
(``ops/moe_matmul.py``): tokens sorted by expert, block-padded, two grouped
GEMMs, exact (no capacity dropping), top_k / n_exp of the scan's
multiply-adds. With ``cfg.expert_parallel`` and more than one expert shard
(``expert_shards``) each shard runs the grouped route over its own experts
(activation-quantized experts: the scan over them) and the shards'
contributions are added; under a ``DistLLM`` each rank holds its own
experts (expert parallelism) or its columns of every expert (tensor
parallelism), and the ranks' parts are added in rank order. Under tensor
parallelism a dynamic W8A8 ``wdown`` quantizes a rank's slice of each
expert's intermediate row with the whole row's amax (``_scan_experts``:
every expert's slice amaxes gathered in one collective a layer), so a
rank's int8 / e4m3 activations are the columns one process makes.

On the card a token's expert output has the same bits by every route and at
every batch width (one GEMM arithmetic, a fixed order of the k terms), so
lookahead decoding reproduces greedy decoding.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch
import torch.nn.functional as F

from painlessinferenceacceleration_tpu_torch.config import ModelConfig
from painlessinferenceacceleration_tpu_torch.layers.linear import (
    QuantSpec,
    linear,
    make_linear,
    quantize,
)
from painlessinferenceacceleration_tpu_torch.ops.moe_matmul import (
    moe_block_grouped,
    routed_expert_mlp,
    stable_topk,
    use_grouped_moe,
)
from painlessinferenceacceleration_tpu_torch.parallel import comm

_EXPERT_SHARDS = 1


@contextlib.contextmanager
def expert_shards(n: int):
    """Ambient number of expert shards for ``cfg.expert_parallel`` models
    (default 1): the port's counterpart of the JAX package's ambient mesh,
    whose ``model`` axis shards the expert axis of the stacked weights."""
    global _EXPERT_SHARDS
    if n < 1:
        raise ValueError(f"expert_shards({n})")
    old, _EXPERT_SHARDS = _EXPERT_SHARDS, int(n)
    try:
        yield
    finally:
        _EXPERT_SHARDS = old


def _make_expert(w3: torch.Tensor, spec: Optional[QuantSpec]):
    """Quantize a stacked [X, in, out] expert tensor, expert by expert."""
    if spec is None:
        return w3
    leaves = [quantize(w, spec) for w in w3]
    return {k: torch.stack([p[k] for p in leaves]) for k in leaves[0]}


def init_moe_layer(cfg: ModelConfig, generator: torch.Generator, dtype,
                   spec: Optional[QuantSpec], device=None) -> dict:
    """Extra params for one MoE layer (added to the attention params)."""
    E = cfg.hidden_size
    I = cfg.moe_intermediate_size or cfg.intermediate_size
    X = cfg.num_experts
    dev = generator.device if device is None else device

    def w(*shape):
        return (torch.randn(*shape, generator=generator, device=generator.device)
                * 0.02).to(device=dev, dtype=dtype)

    p = {
        "router": w(E, X),  # kept native: tiny, precision-critical
        "moe_wgu": _make_expert(w(X, E, 2 * I), spec),
        "moe_wdown": _make_expert(w(X, I, E), spec),
    }
    if cfg.scoring_func == "sigmoid":
        p["router_bias"] = torch.zeros(X, dtype=torch.float32, device=dev)
    if cfg.num_shared_experts:
        Ish = I * cfg.num_shared_experts
        p["shared_wgu"] = make_linear(w(E, 2 * Ish), spec)
        p["shared_wdown"] = make_linear(w(Ish, E), spec)
    return p


def route_topk(cfg: ModelConfig, router_logits: torch.Tensor,
               bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[T, X] logits -> [T, X] fp32 routing weights (zeros off the top-k).

    Softmax-then-top-k with renormalization (mixtral, qwen3-moe), and the
    deepseek-v3 routing: sigmoid scores, a correction bias for the selection
    only, group-limited top-k. Every top-k breaks ties towards the lowest
    index, so a token picks the same experts at every batch width."""
    k = cfg.num_experts_per_tok
    T, X = router_logits.shape
    lf = router_logits.to(torch.float32)
    if cfg.scoring_func == "sigmoid":
        scores = torch.sigmoid(lf)
        choice = scores + bias if bias is not None else scores
    else:
        scores = torch.softmax(lf, dim=-1)
        choice = scores
    if cfg.n_group > 1 and cfg.topk_group > 0:
        G = cfg.n_group
        cg = choice.reshape(T, G, X // G)
        if cfg.scoring_func == "sigmoid":
            # v3 rule: a group's score is the sum of its top-2 expert scores
            gscore = stable_topk(cg, min(2, X // G))[0].sum(dim=-1)  # [T, G]
        else:
            # v2 grouped top-k scores a group by its best expert
            gscore = cg.amax(dim=-1)
        _, gi = stable_topk(gscore, cfg.topk_group)
        gmask = torch.zeros((T, G), dtype=torch.bool, device=lf.device)
        gmask.scatter_(1, gi, True)
        choice = torch.where(gmask.repeat_interleave(X // G, dim=1), choice,
                             torch.full_like(choice, float("-inf")))
    _, topi = stable_topk(choice, k)
    topv = torch.gather(scores, 1, topi)  # the weights carry no bias
    if cfg.norm_topk_prob:
        topv = topv / (topv.sum(dim=-1, keepdim=True) + 1e-20)
    topv = topv * cfg.routed_scaling_factor
    w = torch.zeros((T, X), dtype=torch.float32, device=lf.device)
    return w.scatter_(1, topi, topv)


def _expert_act(wgu, x: torch.Tensor, spec) -> torch.Tensor:
    """A gated MLP's intermediate rows: gate and up halves of one GEMM."""
    gu = linear(wgu, x, spec)
    I = gu.shape[-1] // 2
    return F.silu(gu[..., :I].to(torch.float32)).to(x.dtype) * gu[..., I:]


def _expert_mlp(wgu, wdown, x: torch.Tensor, spec, par=None) -> torch.Tensor:
    """One gated MLP over every row of x; with a rank state ``par`` the down
    product is row-parallel (``parallel.comm.linear_rows``)."""
    return comm.linear_rows(wdown, _expert_act(wgu, x, spec), spec, par)


def _down(wdown, act: torch.Tensor, spec, amax: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``act @ wdown`` in act's type; ``amax`` [T]: the whole rows' amax
    with which a rank quantizes its slice of dynamic W8A8 rows under tensor
    parallelism (``comm.quantizes_slices``), None otherwise."""
    if amax is None:
        return linear(wdown, act, spec)
    from painlessinferenceacceleration_tpu_torch.ops.w8a8 import w8a8_matmul

    return w8a8_matmul(act, wdown, spec, None, amax)


def _experts(w, idx):
    """Expert ``idx`` (an int or a slice) of a stacked leaf: views, no copy."""
    if isinstance(w, dict):
        return {k: v[idx] for k, v in w.items()}
    return w[idx]


def expert_shard_mlp(x: torch.Tensor, route_w: torch.Tensor, wgu_l, wdown_l,
                     base: int, n_local: int, k: int, inter_size: int,
                     spec: Optional[QuantSpec]) -> torch.Tensor:
    """One shard's routed contribution [T, E] in fp32: the top-k of the
    (replicated) routing weights, the pairs owned by other shards marked with
    the dropped-expert sentinel ``n_local``, and the grouped two-GEMM expert
    MLP over the local experts ``[base, base + n_local)`` only."""
    topv, topi = stable_topk(route_w, k)
    valid = (topi >= base) & (topi < base + n_local) & (topv > 0.0)
    ex = torch.where(valid, topi - base, torch.full_like(topi, n_local))
    tw = torch.where(valid, topv, torch.zeros_like(topv))
    return routed_expert_mlp(x, ex, tw, wgu_l, wdown_l, n_local, inter_size, spec)


def _ep_part(lp: dict, cfg: ModelConfig, spec: Optional[QuantSpec], x: torch.Tensor,
             route_w: torch.Tensor, wgu, wdown, base: int, n_local: int) -> torch.Tensor:
    """One expert shard's routed contribution [T, E] in fp32, over its
    experts ``[base, base + n_local)`` (``wgu`` / ``wdown``: their stacked
    weights). Native and weight-only int8 / int4 experts take the grouped
    route over the pairs they own (``expert_shard_mlp``); activation-quantized
    ones (W8A8 int8 / e4m3, block fp8) the scan over those experts, as
    ``_moe_local`` scans all of them (K8 / K9): a token's weight is 0 for
    an expert it did not pick."""
    k = cfg.num_experts_per_tok
    I = cfg.moe_intermediate_size or cfg.intermediate_size
    if _ep_routed(spec, lp):
        return expert_shard_mlp(x, route_w, wgu, wdown, base, n_local, k, I, spec)
    return _scan_experts(wgu, wdown, x, spec, route_w, base, n_local)


def _scan_experts(wgu, wdown, x: torch.Tensor, spec: Optional[QuantSpec],
                  route_w: torch.Tensor, base: int, n: int, par=None) -> torch.Tensor:
    """The scan route over the experts ``[base, base + n)`` (``wgu`` /
    ``wdown``: their stacked weights): every token through every expert, the
    fp32 sum of the outputs weighted by ``route_w``'s columns, in expert
    order. [T, E] fp32. Under tensor parallelism (``par``) each output is
    this rank's partial of its expert's down product; dynamic W8A8 experts
    quantize a rank's slices with the whole rows' amax, every expert's
    activations made first and their slice amaxes gathered in one
    collective (``comm.row_amax``)."""
    acc = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    acts = amax = None
    if comm.quantizes_slices(wdown, spec, par):
        acts = torch.stack([_expert_act(_experts(wgu, e), x, spec) for e in range(n)])
        amax = comm.row_amax(acts, par)
    for e in range(n):
        act = _expert_act(_experts(wgu, e), x, spec) if acts is None else acts[e]
        out = _down(_experts(wdown, e), act, spec, None if amax is None else amax[e])
        acc = acc + out.to(torch.float32) * route_w[:, base + e][:, None]
    return acc


def _moe_expert_parallel(lp: dict, cfg: ModelConfig, spec: Optional[QuantSpec],
                         x: torch.Tensor, route_w: torch.Tensor):
    """Expert parallelism in one process: the expert axis of the stacked
    weights is split into ``expert_shards`` shards.

    Each shard computes only its own experts' part (``_ep_part``: the
    (token, choice) pairs they own by the grouped route, or the scan over
    them for activation-quantized experts) and the shards' fp32
    contributions are added in rank order; every pair is computed by
    exactly one shard. This is the JAX package's arithmetic under a mesh
    whose ``model`` axis has that many devices: there each device holds one
    shard and a ``psum`` adds them (its activation-quantized experts take
    the scan over the sharded weights). Here one process that holds all
    experts runs the shards in rank order, over views of the stacked
    weights: the CPU parity path and the oracle of ``_moe_ep``, where each
    rank of a ``DistLLM`` holds its own shard.

    With one shard or a shard count that does not divide the experts:
    native experts fall back to the dense all-experts product and quantized
    experts return None (the caller's scan path), as in the JAX package."""
    X = cfg.num_experts
    I = cfg.moe_intermediate_size or cfg.intermediate_size
    tp = _EXPERT_SHARDS
    if _ep_divides(cfg, tp):
        Xl = X // tp
        out = None
        for rank in range(tp):
            local = slice(rank * Xl, (rank + 1) * Xl)
            part = _ep_part(lp, cfg, spec, x, route_w, _experts(lp["moe_wgu"], local),
                            _experts(lp["moe_wdown"], local), rank * Xl, Xl)
            out = part if out is None else out + part
        return out
    if isinstance(lp["moe_wgu"], dict):
        return None
    # dense all-experts fallback: exact, X / k times the routed multiply-adds;
    # the gate stays in fp32 up to the activation, as in the JAX einsum
    acc = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for e in range(X):
        gu = linear(lp["moe_wgu"][e].to(x.dtype), x, None, out_dtype=torch.float32)
        act = (F.silu(gu[..., :I]) * gu[..., I:]).to(x.dtype)
        out = linear(lp["moe_wdown"][e].to(x.dtype), act, None, out_dtype=torch.float32)
        acc = acc + out * route_w[:, e].to(x.dtype).to(torch.float32)[:, None]
    return acc


def _ep_divides(cfg: ModelConfig, n: int) -> bool:
    """Whether the experts split over ``n`` > 1 shards."""
    return n > 1 and cfg.num_experts % n == 0


def _ep_routed(spec: Optional[QuantSpec], lp: dict) -> bool:
    """Whether a shard's experts take the grouped route over its pairs
    (native or weight-only int8 / int4), not the scan over its experts
    (activation-quantized: W8A8 and block fp8)."""
    return not isinstance(lp["moe_wgu"], dict) or (
        spec is not None and spec.act is None and not spec.block)


def _moe_ep(lp: dict, cfg: ModelConfig, spec: Optional[QuantSpec], x: torch.Tensor,
            route_w: torch.Tensor, st) -> torch.Tensor:
    """Expert parallelism over the model ranks of a ``DistLLM`` (the rank
    state ``st``): rank r holds experts [r Xl, (r + 1) Xl) and computes
    their part (``_ep_part``); the ranks' fp32 parts are gathered and added
    in rank order, the order of ``_moe_expert_parallel``'s loop, so the sum
    [T, E] has the bits of the one-process ``expert_shards(n)``."""
    X = cfg.num_experts
    if not _ep_divides(cfg, st.model_size):
        raise NotImplementedError(
            f"expert parallelism over {st.model_size} ranks needs the experts ({X}) to "
            "divide")
    Xl = X // st.model_size
    part = _ep_part(lp, cfg, spec, x, route_w, lp["moe_wgu"], lp["moe_wdown"],
                    st.model_rank * Xl, Xl)
    return comm.reduce_partial(part, st)


def _moe_local(lp: dict, cfg: ModelConfig, spec: Optional[QuantSpec], x: torch.Tensor,
               route_w: torch.Tensor, par=None) -> torch.Tensor:
    """The routed experts over this process's weights by the grouped or the
    scan route, [T, E] (fp32 from the scan); ``par``: the rank state when
    these are a rank's columns of every expert (tensor parallelism)."""
    T, E = x.shape
    if use_grouped_moe(cfg, spec, lp, T):
        return moe_block_grouped(lp, cfg, x[None], route_w).reshape(T, E)
    return _scan_experts(lp["moe_wgu"], lp["moe_wdown"], x, spec, route_w, 0,
                         cfg.num_experts, par)


def router_logits(lp: dict, x: torch.Tensor) -> torch.Tensor:
    """fp32 logits [T, X] from x [T, E] and the native router weight."""
    return linear(lp["router"].to(x.dtype), x, None, out_dtype=torch.float32)


def moe_block(lp: dict, cfg: ModelConfig, spec: Optional[QuantSpec],
              h: torch.Tensor, par=None) -> torch.Tensor:
    """MoE MLP over h [B, Q, E]. Under a ``DistLLM``'s expert parallelism
    (the rank state ``par``) the routed part comes from ``_moe_ep``; under
    its tensor parallelism the routed part and split shared experts are this
    rank's partials, added in rank order."""
    B, Q, E = h.shape
    x = h.reshape(B * Q, E)
    route_w = route_topk(cfg, router_logits(lp, x), lp.get("router_bias"))  # [T, X]
    st = par
    ranks = st is not None and st.tp > 1
    shared = "shared_wgu" in lp  # deepseek / bailing shared experts (always on)
    split_shared = ranks and st.shared_split
    if ranks and st.mode == "tp" and st.moe_split:
        # tensor parallelism: each expert's widths split; the routed output as
        # one process rounds it, plus a split shared MLP, summed in rank order
        part = _moe_local(lp, cfg, spec, x, route_w, st).to(h.dtype).to(torch.float32)
        if shared and split_shared:
            act = _expert_act(lp["shared_wgu"], x, spec)
            amax = (comm.row_amax(act, st) if comm.quantizes_slices(lp["shared_wdown"], spec, st)
                    else None)
            part = part + _down(lp["shared_wdown"], act, spec, amax).to(torch.float32)
        out = comm.reduce_partial(part, st).to(h.dtype)
        if shared and not split_shared:
            out = out + _expert_mlp(lp["shared_wgu"], lp["shared_wdown"], x, spec)
        return out.reshape(B, Q, E)
    if ranks and st.mode == "ep":
        out = _moe_ep(lp, cfg, spec, x, route_w, st).to(h.dtype)
    else:
        ep_out = (_moe_expert_parallel(lp, cfg, spec, x, route_w)
                  if cfg.expert_parallel else None)
        out = (ep_out if ep_out is not None
               else _moe_local(lp, cfg, spec, x, route_w)).to(h.dtype)
    if shared:
        out = out + _expert_mlp(lp["shared_wgu"], lp["shared_wdown"], x, spec,
                                st if split_shared else None)
    return out.reshape(B, Q, E)

