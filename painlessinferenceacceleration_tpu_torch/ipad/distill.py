"""Iterative pruning and distillation: masks, staging, reparam, save/load,
evaluation.

Port of ``painlessinferenceacceleration_tpu/ipad/distill.py``
(``DistillConfig``, ``init_masks``, ``Distiller``, ``DistillStage``,
``DistillPipe``). A train step is the student's fp32 forward under the
channel masks (``train_forward.forward_logits``), the KL / CE / hidden-MSE
loss against the teacher, autograd, the trainable-set mask on the
gradients, AdamW in optax's order (``optim.py``), the same mask on the
update, and the unit saliency |grad| * |weight| of the updated weights.
Where JAX rebuilds the student and the optimizer's moments as new arrays
each step, the port updates them in place with the same arithmetic (a
frozen leaf's update is an exact zero), so one step holds the weights, two
moments, the gradients and the updates.

The ``Distiller`` runs on the device of the teacher's tensors: the card,
unless the caller passes CPU tensors. Masks are picked on the host from a
host copy of the saliency (``np.argsort``, as JAX), so the same saliency
gives the same masks in both packages. ``reparam`` slices the weights to
the kept units and returns a smaller ``ModelConfig``: the pruned model then
serves through ``engine/llm.py`` and the kernels like any other.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
from typing import Iterator, Optional, Tuple

import numpy as np
import torch

from painlessinferenceacceleration_tpu_torch.config import ModelConfig
from painlessinferenceacceleration_tpu_torch.models.convert import params_from_jax
from painlessinferenceacceleration_tpu_torch.ipad.optim import (
    AdamState,
    AdamW,
    tree_leaves,
    tree_map,
)
from painlessinferenceacceleration_tpu_torch.ipad.train_forward import (
    check_trainable,
    forward_logits,
)


@dataclasses.dataclass
class DistillConfig:
    lr: float = 1e-4
    weight_decay: float = 0.01
    kl_weight: float = 1.0  # KL(teacher || student) on logits
    ce_weight: float = 0.1  # CE vs data labels
    temperature: float = 2.0
    # pruning schedule: the fraction of each unit class to remove, ramped
    # over prune_steps. Heads prune at kv-group granularity (a kv head and
    # its G query heads); depth removes whole layers; dim one hidden-width
    # mask shared by every layer (the residual stream keeps one width)
    target_mlp_sparsity: float = 0.5
    target_head_sparsity: float = 0.0  # fraction of kv groups to remove
    target_depth_sparsity: float = 0.0  # fraction of layers to remove
    target_dim_sparsity: float = 0.0  # fraction of the hidden width to remove
    hidden_weight: float = 0.0  # MSE(teacher_hidden, student_hidden) weight
    prune_steps: int = 100  # steps to reach target sparsity
    total_steps: int = 200


def init_masks(cfg: ModelConfig, device=None) -> dict:
    L = cfg.num_hidden_layers

    def ones(*shape):
        return torch.ones(shape, dtype=torch.float32, device=device)

    return {"mlp": ones(L, cfg.intermediate_size), "head": ones(L, cfg.num_attention_heads),
            "layer": ones(L), "dim": ones(cfg.hidden_size)}


class Distiller:
    """Prune-and-distill trainer over a teacher and an fp32 student."""

    def __init__(self, cfg: ModelConfig, teacher_params: dict,
                 dcfg: Optional[DistillConfig] = None, student_params: Optional[dict] = None):
        check_trainable(cfg)
        self.cfg = cfg
        self.dcfg = dcfg or DistillConfig()
        self.teacher = teacher_params
        self.device = tree_leaves(teacher_params)[0].device
        src = teacher_params if student_params is None else student_params
        # a copy: the student is updated in place
        self.student = tree_map(lambda x: x.detach().to(torch.float32, copy=True), src)
        self.masks = init_masks(cfg, self.device)
        self.opt = AdamW(self.dcfg.lr, weight_decay=self.dcfg.weight_decay)
        self.opt_state = self.opt.init(self.student)
        self.tmask = self.finetune_mask("full")  # everything trains by default
        self._saliency = {k: torch.zeros_like(v) for k, v in self.masks.items()}
        self.step_idx = 0
        self.history = []

    def _tokens(self, batch) -> torch.Tensor:
        return torch.as_tensor(np.asarray(batch, dtype=np.int32), device=self.device)

    # -- the train step -----------------------------------------------------

    def _loss(self, student, tokens, teacher_logits, teacher_hidden):
        d = self.dcfg
        logits, hidden = forward_logits(student, self.cfg, tokens, self.masks,
                                        return_hidden=True)
        t = teacher_logits / d.temperature
        s = logits / d.temperature
        kl = torch.mean(torch.sum(torch.softmax(t, -1) * (torch.log_softmax(t, -1)
                                                          - torch.log_softmax(s, -1)), -1))
        labels = tokens[:, 1:].long()
        ce = torch.mean(-torch.gather(torch.log_softmax(logits[:, :-1], -1), 2,
                                      labels[..., None]))
        # the final hidden state's alignment over the KEPT dims (pruned dims
        # are zero by construction)
        dm = self.masks["dim"].float()
        diff = (hidden.float() - teacher_hidden) * dm
        hid = torch.sum(diff * diff) / (torch.clamp(dm.sum(), min=1.0)
                                        * hidden.shape[0] * hidden.shape[1])
        loss = d.kl_weight * kl * (d.temperature ** 2) + d.ce_weight * ce + d.hidden_weight * hid
        return loss, kl, ce, hid

    def _train_step(self, tokens, teacher_logits, teacher_hidden):
        """One step: (loss, kl, ce, hid, saliency); the student and the
        optimizer state move in place."""
        live = tree_map(lambda p: p.detach().requires_grad_(True), self.student)
        with torch.enable_grad():
            loss, kl, ce, hid = self._loss(live, tokens, teacher_logits, teacher_hidden)
            flat = torch.autograd.grad(loss, tree_leaves(live))
        del live
        it = iter(flat)
        grads = tree_map(lambda _: next(it), self.student)
        del flat, it
        # the trainable set multiplies the gradients (a frozen leaf's moments
        # stay zero) and the update (weight decay cannot move it either)
        tree_map(lambda g, m: g.mul_(m), grads, self.tmask)
        updates, self.opt_state = self.opt.update(grads, self.opt_state, self.student)
        tree_map(lambda p, u, m: p.add_(u.mul_(m)), self.student, updates, self.tmask)
        del updates
        # unit saliency: accumulated |grad| * |weight| over the unit's output
        # projection, at the updated weights
        lg, ls = grads["layers"], self.student["layers"]
        ad = lg["wdown"].abs() * ls["wdown"].abs()  # [L, I, E]
        ao = lg["wo"].abs() * ls["wo"].abs()  # [L, H * D, E]
        L = ao.shape[0]
        sal = {"mlp": ad.sum(dim=2),
               "head": ao.reshape(L, self.cfg.num_attention_heads, -1).sum(dim=2),
               "layer": ao.sum(dim=(1, 2)) + ad.sum(dim=(1, 2)),
               # every writer into a hidden dim, over all layers
               "dim": ao.sum(dim=(0, 1)) + ad.sum(dim=(0, 1))}
        return loss.detach(), kl.detach(), ce.detach(), hid.detach(), sal

    def _teacher_logits(self, tokens):
        with torch.no_grad():
            return forward_logits(self.teacher, self.cfg, tokens, return_hidden=True)

    # -- trainable sets -----------------------------------------------------

    def finetune_mask(self, mode: str = "full", layer_indices=None) -> dict:
        """Multiplicative trainable-set mask shaped like the student:

        - full:  lm head + final norm + embeddings + selected layers
        - block: selected layers only
        - upper: lm head + final norm + selected layers
        - lower: embeddings + selected layers

        ``layer_indices`` restricts which decoder layers train (None: all);
        a stacked [L, ...] leaf takes a per-layer 0/1 vector broadcast over
        its other axes."""
        if mode not in ("full", "block", "upper", "lower"):
            raise ValueError(f"finetune mode {mode!r} (full, block, upper or lower)")
        L = self.cfg.num_hidden_layers
        lvec = np.zeros((L,), np.float32)
        for i in (range(L) if layer_indices is None else layer_indices):
            if 0 <= i < L:
                lvec[i] = 1.0
        head_on = 1.0 if mode in ("full", "upper") else 0.0
        emb_on = 1.0 if mode in ("full", "lower") else 0.0

        def const(v, x):
            return torch.full((1,) * v.dim(), x, dtype=torch.float32, device=self.device)

        out = {}
        for k, v in self.student.items():
            if k == "layers":
                out[k] = {kk: torch.tensor(lvec.reshape((L,) + (1,) * (vv.dim() - 1)),
                                           device=self.device)
                          for kk, vv in v.items()}
            elif k == "embed":
                out[k] = const(v, emb_on)
            else:  # final_ln / lm_head
                out[k] = const(v, head_on)
        return out

    def set_finetune(self, mode: str = "full", layer_indices=None) -> None:
        """Select the trainable set for the next ``fit`` steps."""
        self.tmask = self.finetune_mask(mode, layer_indices)

    # -- pruning schedule ---------------------------------------------------

    def _scheduled_sparsity(self, target: Optional[float] = None) -> float:
        d = self.dcfg
        frac = min(1.0, self.step_idx / max(d.prune_steps, 1))
        return (d.target_mlp_sparsity if target is None else target) * frac

    def _update_masks(self) -> None:
        """Zero the lowest-saliency units up to each kind's scheduled count
        (a kind whose scheduled count is 0 keeps its mask)."""
        d, cfg = self.dcfg, self.cfg
        masks = dict(self.masks)
        sal = {k: v.cpu().numpy() for k, v in self._saliency.items()}

        def put(mask):
            return torch.as_tensor(mask, device=self.device)

        # mlp channels, per layer
        n_zero = int(self._scheduled_sparsity() * cfg.intermediate_size)
        if n_zero:
            mask = np.ones_like(sal["mlp"])
            order = np.argsort(sal["mlp"], axis=1)  # least salient first
            for li in range(mask.shape[0]):
                mask[li, order[li, :n_zero]] = 0.0
            masks["mlp"] = put(mask)

        # attention heads at kv-group granularity, per layer
        H, Hk = cfg.num_attention_heads, cfg.num_key_value_heads
        G = H // Hk
        n_zero = min(int(self._scheduled_sparsity(d.target_head_sparsity) * Hk), Hk - 1)
        if n_zero > 0:
            gsal = sal["head"].reshape(-1, Hk, G).sum(-1)
            mask = np.ones((gsal.shape[0], Hk, G), np.float32)
            order = np.argsort(gsal, axis=1)
            for li in range(gsal.shape[0]):
                mask[li, order[li, :n_zero]] = 0.0
            masks["head"] = put(mask.reshape(-1, H))

        # whole layers
        L = cfg.num_hidden_layers
        n_zero = min(int(self._scheduled_sparsity(d.target_depth_sparsity) * L), L - 1)
        if n_zero > 0:
            mask = np.ones((L,), np.float32)
            mask[np.argsort(sal["layer"])[:n_zero]] = 0.0
            masks["layer"] = put(mask)

        # the hidden width, one mask for the whole stack
        E = cfg.hidden_size
        n_zero = min(int(self._scheduled_sparsity(d.target_dim_sparsity) * E), E - 1)
        if n_zero > 0:
            mask = np.ones((E,), np.float32)
            mask[np.argsort(sal["dim"])[:n_zero]] = 0.0
            masks["dim"] = put(mask)

        self.masks = masks

    # -- training loop ------------------------------------------------------

    def _teacher_cached(self, tokens, cache_dir):
        """Teacher logits and hidden state, cached on disk by the sha1 of the
        int32 token bytes (the JAX package's key and ``npz`` layout: a cache
        either package wrote is read by both). A bf16 teacher's hidden
        state is written widened to fp32 (numpy has no bf16; the train step
        widens it anyway)."""
        if cache_dir is None:
            return self._teacher_logits(tokens)
        host = tokens.cpu().numpy().astype(np.int32)
        key = hashlib.sha1(host.tobytes()).hexdigest()[:20]
        path = os.path.join(cache_dir, f"teacher_{key}.npz")
        if os.path.exists(path):
            with np.load(path) as z:
                return (params_from_jax(z["logits"], self.device),
                        params_from_jax(z["hidden"], self.device))
        lg, hd = self._teacher_logits(tokens)
        os.makedirs(cache_dir, exist_ok=True)
        hd_np = hd.float() if hd.dtype == torch.bfloat16 else hd
        np.savez(path, logits=lg.cpu().numpy(), hidden=hd_np.cpu().numpy())
        return lg, hd

    def fit(self, data: Iterator[np.ndarray], steps: Optional[int] = None,
            cache_dir: Optional[str] = None) -> list:
        """Run the distill loop; ``data`` yields [B, T] token batches.
        ``cache_dir`` caches the teacher's outputs on disk; without it the
        teacher forward runs on every batch."""
        steps = steps or self.dcfg.total_steps
        for _ in range(steps):
            tokens = self._tokens(next(data))
            t_logits, t_hidden = self._teacher_cached(tokens, cache_dir)
            loss, kl, ce, hid, sal = self._train_step(tokens, t_logits, t_hidden.float())
            self._saliency = {k: 0.9 * self._saliency[k] + 0.1 * sal[k] for k in sal}
            self.step_idx += 1
            self._update_masks()
            self.history.append({"step": self.step_idx, "loss": float(loss),
                                 "kl": float(kl), "ce": float(ce), "hidden": float(hid),
                                 "sparsity": self._scheduled_sparsity()})
        return self.history

    # -- eval ----------------------------------------------------------------

    def evaluate(self, data: Iterator[np.ndarray], batches: int = 4) -> dict:
        """Teacher-vs-student probe: next-token perplexity of both models
        and their greedy top-1 agreement."""
        t_nll = s_nll = agree = 0.0
        for _ in range(batches):
            tokens = self._tokens(next(data))
            t_logits, _ = self._teacher_logits(tokens)
            with torch.no_grad():
                s_logits, _ = forward_logits(self.student, self.cfg, tokens, self.masks,
                                             return_hidden=True)
            labels = tokens[:, 1:].long()[..., None]
            nll = [float(-torch.gather(torch.log_softmax(lg[:, :-1], -1), 2, labels).mean())
                   for lg in (t_logits, s_logits)]
            t_nll += nll[0]
            s_nll += nll[1]
            same = t_logits[:, :-1].argmax(-1) == s_logits[:, :-1].argmax(-1)
            agree += int(same.sum()) / same.numel()
        return {"teacher_ppl": float(np.exp(t_nll / batches)),
                "student_ppl": float(np.exp(s_nll / batches)),
                "top1_agreement": agree / batches}

    # -- staging (DistillPipe) ------------------------------------------------

    def set_stage(self, dcfg: DistillConfig) -> None:
        """Swap the schedule / loss config and restart the stage clock and
        the optimizer. Masks of earlier stages stay: a kind with a zero
        target is left untouched by ``_update_masks``."""
        self.dcfg = dcfg
        self.step_idx = 0
        self.opt = AdamW(dcfg.lr, weight_decay=dcfg.weight_decay)
        self.opt_state = self.opt.init(self.student)

    # -- state and checkpoints -------------------------------------------------

    def set_state(self, student: dict, mu: dict, nu: dict, count: int, masks: dict,
                  saliency: dict, step_idx: int, history: Optional[list] = None) -> None:
        """Take a training state (trees of tensors, moved to this
        distiller's device): the student, the optimizer's moments and count,
        the masks, the saliency and the step. Every tensor is copied: the
        distiller updates its state in place."""
        def dev(t):
            return tree_map(lambda x: x.to(self.device, copy=True), t)

        self.student = tree_map(lambda x: x.to(self.device, torch.float32, copy=True), student)
        self.opt_state = AdamState(int(count), dev(mu), dev(nu))
        self.masks = dev(masks)
        self._saliency = dev(saliency)
        self.step_idx = int(step_idx)
        if history is not None:
            self.history = list(history)

    def save(self, path: str) -> None:
        """Write the student, optimizer state, masks, saliency, step and
        history for a resume (``torch.save`` of CPU tensors)."""
        def cpu(t):
            return tree_map(lambda x: x.cpu(), t)

        torch.save({"student": cpu(self.student), "mu": cpu(self.opt_state.mu),
                    "nu": cpu(self.opt_state.nu), "count": self.opt_state.count,
                    "masks": cpu(self.masks), "saliency": cpu(self._saliency),
                    "step_idx": self.step_idx, "history": self.history}, path)

    def load(self, path: str) -> None:
        self.set_state(**torch.load(path, map_location="cpu", weights_only=True))

    # -- reparam ------------------------------------------------------------

    def reparam(self) -> Tuple[ModelConfig, dict]:
        """Slice the weights to the kept units and return (smaller config,
        params). Every layer keeps the widest layer's count of units
        (dead-padded: a padded unit's output rows are zero) so the stacked
        [L, ...] layout survives. The masked student and the sliced model
        compute the same function (the kept-dims norm makes the hidden-width
        slice exact too)."""
        cfg, dev = self.cfg, self.device
        H, Hk, D, I = (cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim,
                       cfg.intermediate_size)
        G = H // Hk

        def idx(a):
            return torch.as_tensor(np.asarray(a, np.int64), device=dev)

        # 1) depth: the kept layers of every stacked leaf (copies: the
        # student trains on in place)
        keep_l = np.nonzero(self.masks["layer"].cpu().numpy())[0]
        L = len(keep_l)
        layers = {k: v[idx(keep_l)] for k, v in self.student["layers"].items()}
        mlp_mask = self.masks["mlp"].cpu().numpy()[keep_l]
        head_mask = self.masks["head"].cpu().numpy()[keep_l]

        def kept_padded(mask_row, n_units, keep_n):
            kept = np.nonzero(mask_row)[0]
            if len(kept) < keep_n:  # pad with dead units for stacking
                pad = np.setdiff1d(np.arange(n_units), kept)[: keep_n - len(kept)]
                kept = np.concatenate([kept, pad])
                dead = np.arange(len(kept) - len(pad), len(kept))
            else:
                dead = np.array([], int)
            return kept, dead

        # 2) attention: kv-group slicing (a group = a kv head + its G q heads)
        gmask = head_mask.reshape(L, Hk, G).max(-1)
        keep_g = int(gmask.sum(1).max())
        nH = keep_g * G
        if keep_g < Hk:
            wqkv, wo = layers["wqkv"], layers["wo"]
            new_wqkv = wqkv.new_zeros((L, wqkv.shape[1], (nH + 2 * keep_g) * D))
            new_wo = wo.new_zeros((L, nH * D, wo.shape[2]))
            for li in range(L):
                kept, dead = kept_padded(gmask[li], Hk, keep_g)
                qc = np.concatenate([np.arange(g * G * D, (g + 1) * G * D) for g in kept])
                kc = np.concatenate([H * D + np.arange(g * D, (g + 1) * D) for g in kept])
                vc = np.concatenate([(H + Hk) * D + np.arange(g * D, (g + 1) * D)
                                     for g in kept])
                new_wqkv[li] = wqkv[li][:, idx(np.concatenate([qc, kc, vc]))]
                new_wo[li] = wo[li][idx(qc)]
                for dg in dead:  # dead groups contribute nothing
                    new_wo[li, dg * G * D: (dg + 1) * G * D] = 0.0
            layers["wqkv"], layers["wo"] = new_wqkv, new_wo

        # 3) mlp channel slicing
        keep_n = int(mlp_mask.sum(axis=1).max())
        if keep_n < I:
            wgu, wdn = layers["wgu"], layers["wdown"]  # [L, E, 2I], [L, I, E]
            new_wgu = wgu.new_zeros((L, wgu.shape[1], 2 * keep_n))
            new_wdn = wdn.new_zeros((L, keep_n, wdn.shape[2]))
            for li in range(L):
                kept, dead = kept_padded(mlp_mask[li], I, keep_n)
                new_wgu[li, :, :keep_n] = wgu[li][:, idx(kept)]
                new_wgu[li, :, keep_n:] = wgu[li][:, idx(I + kept)]
                new_wdn[li] = wdn[li][idx(kept)]
                if len(dead):
                    new_wdn[li, idx(dead)] = 0.0
            layers["wgu"], layers["wdown"] = new_wgu, new_wdn

        # 4) the hidden width: one kept-index set slices every E-sized axis
        top = {k: v.clone() for k, v in self.student.items() if k != "layers"}
        dim_mask = self.masks["dim"].cpu().numpy()
        keep_e = int(dim_mask.sum())
        if keep_e < cfg.hidden_size:
            kd = idx(np.nonzero(dim_mask)[0])
            top["embed"] = top["embed"][:, kd]
            top["final_ln"] = top["final_ln"][kd]
            if "lm_head" in top:
                top["lm_head"] = top["lm_head"][kd]
            for k in ("input_ln", "post_ln"):
                layers[k] = layers[k][:, kd]
            layers["wqkv"] = layers["wqkv"][:, kd, :]
            layers["wo"] = layers["wo"][:, :, kd]
            layers["wgu"] = layers["wgu"][:, kd, :]
            layers["wdown"] = layers["wdown"][:, :, kd]

        new_cfg = dataclasses.replace(
            cfg, num_hidden_layers=L, num_attention_heads=nH, num_key_value_heads=keep_g,
            intermediate_size=keep_n, hidden_size=keep_e,
            head_dim=cfg.head_dim)  # unchanged: hidden_size is no longer H * D
        return new_cfg, dict(top, layers=layers)


@dataclasses.dataclass
class DistillStage:
    """One pipeline stage: a pruning mode or a finetune."""

    mode: str  # mlp | head | depth | dim | finetune
    sparsity: float = 0.0  # pruning target of this stage's mode
    steps: int = 100
    prune_steps: int = 50
    lr: float = 1e-4
    hidden_weight: float = 0.0
    # finetune stages: the trainable set (full / block / upper / lower) and
    # an optional layer restriction
    finetune_mode: str = "full"
    layer_indices: Optional[Tuple[int, ...]] = None


class DistillPipe:
    """Multi-stage prune-then-distill pipeline: masks accumulate across
    stages (a stage tightens only its own mode's mask), one reparam at the
    end."""

    def __init__(self, cfg: ModelConfig, teacher_params: dict, stages: list):
        self.stages = list(stages)
        self.distiller = Distiller(cfg, teacher_params, DistillConfig())

    @staticmethod
    def _stage_cfg(st: DistillStage) -> DistillConfig:
        kw = dict(lr=st.lr, hidden_weight=st.hidden_weight, prune_steps=st.prune_steps,
                  total_steps=st.steps, target_mlp_sparsity=0.0)
        key = {"mlp": "target_mlp_sparsity", "head": "target_head_sparsity",
               "depth": "target_depth_sparsity", "dim": "target_dim_sparsity",
               "finetune": None}[st.mode]
        if key is not None:
            kw[key] = st.sparsity
        return DistillConfig(**kw)

    def run(self, data: Iterator[np.ndarray], cache_dir=None):
        """Run every stage; returns (new_cfg, new_params, history)."""
        d = self.distiller
        for st in self.stages:
            d.set_stage(self._stage_cfg(st))
            if st.mode == "finetune":
                d.set_finetune(st.finetune_mode, st.layer_indices)
            else:
                d.set_finetune("full")  # prune stages train everything
            d.fit(data, steps=st.steps, cache_dir=cache_dir)
        new_cfg, new_params = d.reparam()
        return new_cfg, new_params, d.history
