"""AdamW over nested dicts of tensors, in optax 0.2.6's ``adamw`` order.

The JAX ``Distiller`` trains with ``optax.adamw(lr, weight_decay=wd)``:
``scale_by_adam`` (b1, b2, eps, eps_root 0), then ``add_decayed_weights``,
then ``scale_by_learning_rate``. Per leaf, with the count incremented
before the bias corrections::

    mu = (1 - b1) * g + b1 * mu
    nu = (1 - b2) * g * g + b2 * nu
    u = (mu / (1 - b1 ** count)) / (sqrt(nu / (1 - b2 ** count)) + eps)
    u = -lr * (u + wd * p)

``torch.optim.AdamW`` does not fit: it decays the weights before the Adam
step and would decay leaves the caller freezes (the ``Distiller`` masks the
update itself, so a frozen leaf stays bit-unchanged). The bias corrections
are fp32 values of fp32 powers, as optax computes them, and divide each
moment elementwise.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


def tree_map(fn, *trees):
    """``fn`` over the leaves of nested dicts of the same keys."""
    if isinstance(trees[0], dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def tree_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    return [tree]


@dataclasses.dataclass
class AdamState:
    """optax's ``ScaleByAdamState``: the step count and both moments."""

    count: int
    mu: dict
    nu: dict


def _bias_correction(decay: float, count: int) -> float:
    """``1 - decay ** count`` in fp32 (optax: a weak float to the power of
    the int32 count)."""
    return float(np.float32(1.0) - np.float32(decay) ** np.float32(count))


class AdamW:
    def __init__(self, lr: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                 weight_decay: float = 1e-4):
        self.lr, self.b1, self.b2, self.eps, self.wd = lr, b1, b2, eps, weight_decay

    def init(self, params: dict) -> AdamState:
        return AdamState(0, tree_map(torch.zeros_like, params),
                         tree_map(torch.zeros_like, params))

    def update(self, grads: dict, state: AdamState, params: dict):
        """(updates, state) for ``grads`` at ``params``; apply them as
        ``p + u``. The moments are updated in place (each with the bits of
        optax's out-of-place arithmetic) and the returned state holds them
        with the count incremented."""
        b1, b2, eps, wd, lr = self.b1, self.b2, self.eps, self.wd, self.lr
        count = state.count + 1
        c1, c2 = _bias_correction(b1, count), _bias_correction(b2, count)

        def leaf(g, mu, nu, p):
            mu.mul_(b1).add_(g * (1 - b1))
            nu.mul_(b2).add_((g * g).mul_(1 - b2))
            # divisors as device tensors: torch's card kernels divide by a
            # CPU scalar through its reciprocal
            mu_hat = mu / torch.full((), c1, dtype=mu.dtype, device=mu.device)
            nu_hat = nu / torch.full((), c2, dtype=nu.dtype, device=nu.device)
            u = mu_hat.div_(nu_hat.sqrt_().add_(eps))
            return u.add_(p * wd).mul_(-lr)

        return tree_map(leaf, grads, state.mu, state.nu, params), AdamState(
            count, state.mu, state.nu)
