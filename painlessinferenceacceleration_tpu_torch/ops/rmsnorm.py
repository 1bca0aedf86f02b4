"""RMSNorm with fp32 statistics, plain and grouped, with an optional sigmoid
gate: the wrappers of ``csrc/rmsnorm.cu`` (K15) and their plain versions.

Port of ``rms_norm``, ``rms_group_norm`` and ``rms_group_norm_sigmoid`` of
``painlessinferenceacceleration_tpu/ops/rmsnorm.py``; K15 replaces its
Pallas ``_rmsnorm_kernel`` (which the JAX package calls only from a
benchmark, its model path running the jnp forms). Each of the three
functions launches K15 on a CUDA tensor and takes its plain version on a
CPU tensor; ``rms_norm`` serves the hidden norms, the per-head q/k norms
(the last axis is the normalised row) and MLA's latent norms.

Batch invariance. A served request's tokens must not depend on its
neighbours (lookahead's lossless check compares streams served at other
batch widths), so a row's norm must have the same bits at every row count.
K15 gives each (row, group) one warp that sums its squares in an order
fixed by the group's width alone, so that holds by construction. The plain
versions sum the fp32 squares in fp64 and round to fp32: torch's reduction
picks its tree by the shape, but the fp64 sum of fp32 squares rounds to the
same fp32 value in any order except where the exact sum lies within ~2^-41
of an fp32 rounding boundary. They stay the CPU path and the oracle.

Each of the three wrappers' ``launches`` counts its K15 launches.
"""

from __future__ import annotations

import ctypes

import torch

from painlessinferenceacceleration_tpu_torch import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _normed(xf: torch.Tensor, eps: float) -> torch.Tensor:
    """xf [..., w] fp32 times rsqrt(mean(xf^2) + eps), the mean summed in
    fp64 and rounded to fp32."""
    var = ((xf * xf).sum(dim=-1, keepdim=True, dtype=torch.float64)
           / xf.shape[-1]).to(torch.float32)
    return xf * torch.rsqrt(var + eps)


def rms_norm_plain(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """fp32 scaling (fp64-summed variance), cast back to ``x.dtype``."""
    return (_normed(x.to(torch.float32), eps) * weight.to(torch.float32)).to(x.dtype)


def rms_group_norm_plain(x: torch.Tensor, weight: torch.Tensor, eps: float,
                         num_groups: int) -> torch.Tensor:
    """The last axis split into ``num_groups`` equal groups, each normalised
    on its own; ``weight`` spans the whole axis."""
    *lead, d = x.shape
    xf = x.to(torch.float32).reshape(*lead, num_groups, d // num_groups)
    xf = _normed(xf, eps).reshape(*lead, d)
    return (xf * weight.to(torch.float32)).to(x.dtype)


def rms_group_norm_sigmoid_plain(x: torch.Tensor, gate: torch.Tensor,
                                 weight: torch.Tensor, eps: float,
                                 num_groups: int) -> torch.Tensor:
    """``rms_group_norm(x) * sigmoid(gate)``, the product in fp32 on the
    normed value rounded to ``x.dtype`` (where the JAX form rounds)."""
    y = rms_group_norm_plain(x, weight, eps, num_groups)
    return (y.to(torch.float32) * torch.sigmoid(gate.to(torch.float32))).to(x.dtype)


def _launch(x, weight, gate, eps, groups, wrapper):
    width = x.shape[-1]
    if x.dtype not in _DTYPES or weight.dtype not in _DTYPES:
        raise TypeError(f"rms_norm takes fp32 / bf16 rows and weights, not "
                        f"{x.dtype} / {weight.dtype}")
    if width % groups or weight.shape != (width,):
        raise ValueError(f"rows of {width} in {groups} groups, weight "
                         f"{tuple(weight.shape)}")
    dev = x.device
    if weight.device != dev or (gate is not None and gate.device != dev):
        raise ValueError("rms_norm operands must be on one device")
    x2 = x.reshape(-1, width)
    if x2.stride(1) != 1:
        x2 = x2.contiguous()
    w = weight.contiguous()
    g2 = None
    if gate is not None:
        if gate.shape != x.shape:
            raise ValueError(f"gate {tuple(gate.shape)} != x {tuple(x.shape)}")
        g2 = gate.to(x.dtype).reshape(-1, width).contiguous()
    rows = x2.shape[0]
    out = torch.empty((rows, width), dtype=x.dtype, device=dev)
    if rows:
        lib = _build.library("rmsnorm")
        fn = lib.rms_norm
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [
            ctypes.c_longlong, ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        err = fn(x2.data_ptr(), w.data_ptr(), _build.ptr(g2), out.data_ptr(), rows,
                 groups, width // groups, x2.stride(0), float(eps), _DTYPES[x.dtype],
                 _DTYPES[w.dtype], _build.stream_of(x))
        _build.check(lib, err, "rms_norm")
        wrapper.launches += 1
    return out.reshape(x.shape)


def _check_cpu(x: torch.Tensor, what: str) -> None:
    if x.device.type != "cpu":
        raise NotImplementedError(f"{what} on {x.device}")


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Normalise each row (the last axis) of ``x`` with ``weight`` [w]."""
    if x.is_cuda:
        return _launch(x, weight, None, eps, 1, rms_norm)
    _check_cpu(x, "rms_norm")
    return rms_norm_plain(x, weight, eps)


def rms_group_norm(x: torch.Tensor, weight: torch.Tensor, eps: float,
                   num_groups: int) -> torch.Tensor:
    """Grouped rmsnorm over the last axis split into ``num_groups`` groups
    (the Ring / Bailing-linear RMSGroupNorm)."""
    if x.is_cuda:
        return _launch(x, weight, None, eps, num_groups, rms_group_norm)
    _check_cpu(x, "rms_group_norm")
    return rms_group_norm_plain(x, weight, eps, num_groups)


def rms_group_norm_sigmoid(x: torch.Tensor, gate: torch.Tensor, weight: torch.Tensor,
                           eps: float, num_groups: int) -> torch.Tensor:
    """Gated grouped rmsnorm, ``rms_group_norm(x) * sigmoid(gate)``: the
    output gate of the linear-attention layers."""
    if x.is_cuda:
        return _launch(x, weight, gate, eps, num_groups, rms_group_norm_sigmoid)
    _check_cpu(x, "rms_group_norm_sigmoid")
    return rms_group_norm_sigmoid_plain(x, gate, weight, eps, num_groups)


for _wrapper in (rms_norm, rms_group_norm, rms_group_norm_sigmoid):
    _wrapper.launches = 0
