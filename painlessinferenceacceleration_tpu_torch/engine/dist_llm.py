"""DistLLM: the serving engine over several ranks.

Port of ``painlessinferenceacceleration_tpu/engine/dist_llm.py``. Every
rank is one process that runs the same scheduler loop as ``LLM``, in
lockstep: nothing that decides the schedule depends on time, threads or
arrival order, so every rank builds the same batches. The ranks form a
(data, model) grid (``parallel/mesh.py``):

- the model axis splits the parameters (tensor parallelism: heads and
  intermediate widths; expert parallelism with ``cfg.expert_parallel``:
  the experts) or, with ``EngineConfig.context_parallel``, the KV pages
  (the parameters replicated, ``ops/cp_attention.py``);
- the data axis splits each step's rows in contiguous blocks
  (``models/base.py transformer_hidden``; multimodal embeddings with their
  rows, a hybrid's rows over their slots' recurrent states), and the arena
  and the states stay the same on every data group; beside context
  parallelism each data group holds the whole arena split over its model
  ranks' pages.

Every family takes every layout the JAX package serves: TP, EP (native,
weight-only and activation-quantized experts), DP (hybrids and multimodal
rows included) and CP (dense, MoE, MLA in latent and expanded mode, the
linear-attention hybrids, beside a data axis too).

Each rank serves its shard with a rank-local ``ModelConfig``; the forward
reads the ambient ``parallel.comm.RankState`` that ``generate`` and
``step`` set. Sums over ranks run in rank order, so a rank's tokens are
those of every other rank, and lookahead stays bit-equal to AR. After each
scheduler step the ranks compare their requests' progress, and a
disagreement raises.

Ranks join through ``parallel/multihost.py`` (``multihost=True``, the
``PIA_*`` environment) or a process group the caller has joined. On the
card, ranks run on ``cuda:rank`` (modulo the cards: ranks beyond them share
a card, over gloo); ``device="cpu"`` runs them on the CPU.

The background scheduler (``launch``; and with it ``stream_generate``,
``async_stream_generate`` and the HTTP server, ``service/server.py``):
rank 0 owns the arrivals. ``add_request`` there holds a new request until
the next scheduler step; at one fixed point of each step (before it) rank 0
broadcasts that step's arrivals in arrival order (request id, prompt ids,
sampling parameters, scoring targets and multimodal embeddings) and a stop
flag, and every rank, rank 0 included, queues exactly those, so the queues
stay the same and the schedule does not depend on any rank's clock
(``_check_lockstep`` still compares every step). ``launch`` on rank 0
starts that loop in a thread and returns; on the other ranks it runs their
follower loop in the calling thread and returns when rank 0's ``shutdown``
has been broadcast. A rank 0 with no work waits for an arrival at most
``HEARTBEAT_S`` seconds before it broadcasts anyway (an empty step): no
collective then waits longer than that and a step, far inside gloo's 30
and NCCL's 10 minute timeouts over any idle spell. The HTTP server binds
on rank 0 only (``launch_server``). No request is cancelled once queued
(``LLM`` has no cancellation).

Refused, under context parallelism, as in the JAX package: fp8 arenas,
ALiBi and prefix-LM attention.
"""

from __future__ import annotations

import dataclasses
import itertools
import threading
import time
from typing import Optional, Sequence, Tuple

import torch

from painlessinferenceacceleration_tpu_torch.config import (
    EngineConfig,
    ModelConfig,
    cp_page_unit,
)
from painlessinferenceacceleration_tpu_torch.engine.llm import LLM
from painlessinferenceacceleration_tpu_torch.engine.pages import PageAllocator
from painlessinferenceacceleration_tpu_torch.engine.prefix_cache import PrefixCache
from painlessinferenceacceleration_tpu_torch.engine.request import Request, SamplingParams
from painlessinferenceacceleration_tpu_torch.parallel import comm
from painlessinferenceacceleration_tpu_torch.parallel.mesh import (
    make_mesh,
    plan_shards,
    rank_config,
    shard_params,
)
from painlessinferenceacceleration_tpu_torch.parallel.multihost import (
    initialize_multihost,
    local_device,
)


def check_context_parallel(cfg: ModelConfig, ecfg: EngineConfig) -> None:
    """Raise on what context parallelism does not serve, as the JAX package
    (``engine/llm.py:98-118``): fp8 arenas, ALiBi and prefix-LM attention.
    Every other family (MLA and the linear-attention hybrids too) and a data
    axis beside it are served."""
    bad = []
    if ecfg.kv_quant.startswith("fp8"):
        bad.append(f"kv_quant={ecfg.kv_quant!r}")
    if cfg.position_embedding_type == "alibi":
        bad.append("alibi positions")
    if cfg.prefix_lm:
        bad.append("prefix-LM attention")
    if bad:
        raise ValueError("context_parallel does not support " + ", ".join(bad))


def _world() -> Tuple[int, int]:
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


class DistLLM(LLM):
    """``LLM`` over a (data, model) grid of ranks.

    ``mesh_shape`` (data, model) defaults to ``EngineConfig.mesh_shape``,
    else (1, world): pure tensor parallelism. ``multihost`` first joins the
    process group (``initialize_multihost``: ``PIA_COORDINATOR``,
    ``PIA_NUM_PROCESSES``, ``PIA_PROCESS_ID``). ``cfg`` and ``params`` are
    the whole model, the same on every rank (or ``model_path``); each rank
    keeps its shard."""

    def __init__(self, model_path: Optional[str] = None, cfg: Optional[ModelConfig] = None,
                 params: Optional[dict] = None, ecfg: Optional[EngineConfig] = None,
                 tokenizer=None, dtype=torch.bfloat16, device=None,
                 mesh_shape: Optional[Sequence[int]] = None, multihost: bool = False):
        asked = torch.device(device if device is not None else "cuda")
        if multihost:
            initialize_multihost(device=asked.type)
        world, rank = _world()
        self.rank = rank
        dev = asked if asked.index is not None else local_device(asked.type, rank, world)
        ecfg = ecfg or EngineConfig()
        quant = None
        if model_path is not None:
            from painlessinferenceacceleration_tpu_torch.engine.llm import _auto_tokenizer
            from painlessinferenceacceleration_tpu_torch.layers.linear import QuantSpec
            from painlessinferenceacceleration_tpu_torch.models.hf_loader import load_model

            cfg, params, quant = load_model(
                model_path, dtype=dtype,
                quant=QuantSpec.from_mode(ecfg.quant, ecfg.quant_group), device=dev)
            tokenizer = tokenizer if tokenizer is not None else _auto_tokenizer(model_path)
        if cfg is None or params is None:
            raise ValueError("DistLLM needs model_path, or cfg and params")
        shape = tuple(mesh_shape or ecfg.mesh_shape or (1, world))
        self.mesh = make_mesh(shape, ecfg.mesh_axes)
        tp, dp = self.mesh.tp, self.mesh.dp
        cp = ecfg.context_parallel or cfg.context_parallel
        if cp:
            check_context_parallel(cfg, ecfg)
            cfg = dataclasses.replace(cfg, context_parallel=True)
            unit = cp_page_unit(tp)
            if ecfg.num_pages % unit:
                ecfg = dataclasses.replace(ecfg, num_pages=-(-ecfg.num_pages // unit) * unit)
            if ecfg.cache_memory_fraction > 0:
                raise ValueError("context_parallel sizes its arena from num_pages")
        plan = plan_shards(cfg, tp, params)
        r = self.mesh.model_index
        rank_params = shard_params(params, cfg, self.mesh)
        del params
        rank_cfg = rank_config(cfg, plan, r)
        self.rank_state = comm.RankState(
            model_group=self.mesh.model_group, model_rank=r, model_size=tp,
            data_group=self.mesh.data_group, data_rank=self.mesh.data_index, data_size=dp,
            mode=plan.mode, attn_split=plan.attn != "replicated",
            mlp_split=plan.mlp is not None,
            moe_split=plan.moe is not None, shared_split=plan.shared is not None,
            head_widths=(tuple(b - a for a, b in plan.head) if plan.head else None))
        # under context parallelism the engine's arena is this rank's pages
        # behind a local null page; the allocator hands out the global pages
        local = (dataclasses.replace(ecfg, num_pages=ecfg.num_pages // tp + 1,
                                     context_parallel=False) if cp else ecfg)
        super().__init__(cfg=rank_cfg, params=rank_params, ecfg=local, tokenizer=tokenizer,
                         dtype=dtype, device=dev)
        if quant is not None:
            self.quant = quant
        if cp:
            self.ecfg = ecfg
            self.allocator = PageAllocator(ecfg.num_pages, ecfg.page_size)
            if self.prefix_cache is not None:
                self.prefix_cache = PrefixCache(self.allocator, ecfg.page_size)

    # every entry point that runs the model runs under the rank state

    def step(self) -> bool:
        with comm.using(self.rank_state):
            worked = super().step()
        self._check_lockstep()
        return worked

    def calibrate_kv_scales(self, prompts) -> None:
        with comm.using(self.rank_state):
            super().calibrate_kv_scales(prompts)

    # ---- the background scheduler over the ranks ----

    HEARTBEAT_S = 5.0  # the longest rank 0 waits for an arrival before a step

    def launch(self) -> None:
        """Rank 0: start the scheduler thread (requests then arrive through
        ``add_request``, the streams and the server) and return. Any other
        rank: run the follower loop here, until rank 0 shuts down."""
        if self._running:
            return
        world, rank = _world()
        if world == 1:
            super().launch()
            return
        self._arrivals, self._stop = [], False
        self._arrival_cv = threading.Condition()
        self._running = True
        if rank == 0:
            self._thread = threading.Thread(target=self._serve, daemon=True)
            self._thread.start()
        else:
            self._serve()

    def shutdown(self) -> None:
        """Rank 0: broadcast the stop at the next step and wait for the loop
        (every rank's loop then ends). Any other rank: nothing to stop."""
        if self._running and self.rank == 0 and self._thread is not None:
            with self._arrival_cv:
                self._stop = True
                self._arrival_cv.notify()
            self._thread.join()
            self._thread = None
            return
        super().shutdown()

    def _enqueue(self, req: Request) -> None:
        if not self._running or _world()[0] == 1:
            super()._enqueue(req)
            return
        if self.rank != 0:
            raise RuntimeError("requests to a launched DistLLM arrive at rank 0")
        with self._arrival_cv:
            self._arrivals.append(req)
            self._arrival_cv.notify()

    def _busy(self) -> bool:
        return bool(self._queue) or self._pending is not None or any(
            r is not None for r in self._slots)

    def _step_arrivals(self) -> dict:
        """The broadcast before a step: rank 0 takes the requests that
        arrived since the last one (waiting up to ``HEARTBEAT_S`` when it has
        no work) and sends them, in arrival order, with the stop flag; every
        rank returns the message, and rank 0 queues its own handles."""
        import torch.distributed as dist

        msg = None
        if self.rank == 0:
            with self._arrival_cv:
                if not (self._arrivals or self._stop or self._busy()):
                    self._arrival_cv.wait(timeout=self.HEARTBEAT_S)
                reqs, self._arrivals = self._arrivals, []
                stop = self._stop
            with self._lock:
                self._queue.extend(reqs)
            msg = {"stop": stop, "arrivals": [
                (r.rid, r.input_ids, dataclasses.asdict(r.sampling), r.target_ids,
                 r.mm_embeds, r.mm_positions) for r in reqs]}
        box = [msg]
        dist.broadcast_object_list(box, src=0)
        return box[0]

    def _serve(self) -> None:
        """Every rank's scheduler loop while launched: the step's arrivals,
        then the step, until rank 0's stop arrives."""
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)
        try:
            while True:
                msg = self._step_arrivals()
                if self.rank != 0:
                    for rid, ids, sp, targets, mm, mm_pos in msg["arrivals"]:
                        req = Request(rid, ids, SamplingParams(**sp), False, targets, mm,
                                      mm_pos)
                        req.arrival_t = time.perf_counter()
                        with self._lock:
                            self._queue.append(req)
                        # later requests (generate after the loop) take rank 0's ids
                        self._rid = itertools.count(rid + 1)
                if msg["stop"]:
                    return
                self.step()
        finally:
            self._running = False

    def _check_lockstep(self) -> None:
        """Raise unless every rank holds the same requests with the same
        tokens after this step (one fixed-size fingerprint a slot)."""
        world, rank = _world()
        if world == 1:
            return
        fp = [len(self._queue)]
        for req in self._slots:
            out = req.output_ids if req is not None else []
            fp += ([-1] * 4 if req is None else
                   [req.rid, len(out), out[-1] if out else -1, sum(out) % (1 << 31)])
        comm.check_same(torch.tensor(fp, dtype=torch.int64, device=self.device), None, rank,
                        world, "the requests' tokens")
