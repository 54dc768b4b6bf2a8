"""Optimizer and LR schedule (twin of cogview_tpu/training/optim.py).

* :func:`annealing_lr` is the reference's AnnealingLR with its breakpoints:
  linear warmup ``lr * t / warmup``, then 'linear' ``lr * (N - (t - warmup))
  / N``, 'cosine' between lr and ``lr * decay_ratio``, or flat for
  'constant' / 'exponential' / None.  Computed in float32, as the JAX
  package does.
* :class:`AdamW` is a hand-written equivalent of the JAX package's optax
  chain, in its order: ``clip_by_global_norm``, ``scale_by_adam`` (bias
  correction by the incremented count, eps outside the sqrt),
  ``add_decayed_weights`` under :func:`weight_decay_mask`, then
  ``scale_by_schedule(-schedule)``.  optax evaluates the schedule at its
  count *before* incrementing it, so the first update uses ``schedule(0)``
  (0 under warmup).  ``torch.optim.AdamW`` applies decay and the learning
  rate in another order, so it is not used.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, Iterator, Optional, Sequence, Tuple

import numpy as np
import torch

Params = Dict[str, Any]


def annealing_lr(start_lr: float, warmup_iter: int, num_iters: int,
                 decay_style: Optional[str] = "cosine",
                 decay_ratio: float = 0.5) -> Callable[[int], float]:
    """-> schedule(step) -> the learning rate, evaluated in float32."""
    style = decay_style.lower() if isinstance(decay_style, str) else None
    f = np.float32
    lr, warm_n, n = f(start_lr), f(max(warmup_iter, 1)), f(num_iters)
    inv_ratio = 1.0 / decay_ratio  # the reference stores the inverse
    # Python-float subexpressions stay double, as they do in the JAX package
    cos_lo, cos_span = f(start_lr / inv_ratio), f(inv_ratio - 1.0)

    def schedule(step: int) -> float:
        t = f(step)
        warm = lr * t / warm_n
        if style == "linear":
            after = lr * ((n - (t - f(warmup_iter))) / n)
        elif style == "cosine":
            ratio = np.minimum(f(1.0), (t - f(warmup_iter)) / n)
            after = cos_lo * ((np.cos(f(math.pi) * ratio) + f(1.0)) * cos_span / f(2.0)
                              + f(1.0))
        else:  # constant / exponential (a stub upstream) / None
            after = lr
        if warmup_iter > 0 and t <= warmup_iter:
            return float(warm)
        return float(after)

    return schedule


def weight_decay_mask(params: Params) -> Params:
    """True = decayed: no decay on any path through an ``ln_*`` key or on a
    ``b`` leaf; embeddings and matrices decay."""

    def walk(tree, under_ln):
        return {k: (walk(v, under_ln or k.startswith("ln_")) if isinstance(v, dict)
                    else not (under_ln or k.startswith("ln_") or k == "b"))
                for k, v in tree.items()}

    return walk(params, False)


def tree_leaves(tree: Params) -> Iterator[torch.Tensor]:
    """Leaves in the JAX package's flattening order (sorted keys)."""
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from tree_leaves(v)
        else:
            yield v


def tree_map(fn, tree: Params, *rest: Params) -> Params:
    return {k: (tree_map(fn, v, *(r[k] for r in rest)) if isinstance(v, dict)
                else fn(v, *(r[k] for r in rest)))
            for k, v in tree.items()}


def global_norm(grads: Sequence[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of every leaf's sum of squares, float32 0-d."""
    return torch.sqrt(sum(torch.sum(torch.square(g)) for g in grads))


# the optimizer updates a leaf in slices of whole rows (whole layers of a
# stacked [L, ...] leaf) of at most this many elements: its temporaries are
# then a few slices in size, not a few leaves (a [48, 2560, 10240] float32
# leaf of cogview-base is 4.7 GiB)
UPDATE_SLICE_ELEMS = 1 << 26


def _row_slices(*ts: torch.Tensor):
    """Same-shaped tensors -> tuples of their views over the same runs of
    rows along dim 0, each at most UPDATE_SLICE_ELEMS elements (at least
    one row)."""
    t = ts[0]
    if t.dim() == 0 or t.numel() <= UPDATE_SLICE_ELEMS:
        return [ts]
    rows = max(1, UPDATE_SLICE_ELEMS // (t.numel() // t.shape[0]))
    return list(zip(*(x.split(rows) for x in ts)))


class AdamW:
    """The JAX package's optax chain, written out.  State is a dict
    ``{"count": int, "mu": tree, "nu": tree}``; :meth:`update` changes the
    params and the state in place, to keep one copy of each at 4 bytes per
    parameter, and is only called on steps whose gradients are finite.  It
    works through each leaf in slices of rows (:func:`_row_slices`): the
    arithmetic is elementwise, so the result is the same bit for bit."""

    def __init__(self, params: Params, schedule: Callable[[int], float], *,
                 weight_decay: float = 1e-2, betas: Tuple[float, float] = (0.9, 0.95),
                 eps: float = 1e-8, grad_clip: float = 1.0):
        self.schedule = schedule
        self.mask = weight_decay_mask(params)
        self.weight_decay = weight_decay
        self.b1, self.b2 = betas
        self.eps = eps
        self.grad_clip = grad_clip

    def init(self, params: Params) -> Dict[str, Any]:
        return {"count": 0, "mu": tree_map(torch.zeros_like, params),
                "nu": tree_map(torch.zeros_like, params)}

    @torch.no_grad()
    def update(self, grads: Params, state: Dict[str, Any], params: Params,
               g_norm: Optional[torch.Tensor] = None) -> None:
        """One step: params and state are updated in place.  ``g_norm`` is the
        global norm of ``grads`` when the caller already has it."""
        if g_norm is None:
            g_norm = global_norm(list(tree_leaves(grads)))
        count = state["count"]
        clip = bool(self.grad_clip) and not bool(g_norm < self.grad_clip)
        f32 = np.float32
        # 1 - b ** (count + 1) in float32, as optax's bias correction
        bc1 = f32(1) - f32(self.b1) ** f32(count + 1)
        bc2 = f32(1) - f32(self.b2) ** f32(count + 1)
        step = -f32(self.schedule(count))
        # 0-d divisors: CUDA divides by a Python scalar through its reciprocal
        dev = g_norm.device
        bc1_t, bc2_t, step_t = (torch.tensor(x, device=dev) for x in (bc1, bc2, step))

        def one(p, g, mu, nu, decay):
            if clip:
                g = g / g_norm * self.grad_clip
            mu.mul_(self.b1).add_((1 - self.b1) * g)
            nu.mul_(self.b2).add_((1 - self.b2) * torch.square(g))
            u = (mu / bc1_t) / (torch.sqrt(nu / bc2_t) + self.eps)
            if decay and self.weight_decay:
                u = u + self.weight_decay * p
            p.add_(step_t * u)

        def leaf(p, g, mu, nu, decay):
            for sl in _row_slices(p, g, mu, nu):
                one(*sl, decay)

        tree_map(leaf, params, grads, state["mu"], state["nu"], self.mask)
        state["count"] = count + 1


def make_optimizer(params: Params, *, lr: float = 4e-4, warmup_iter: int = 2000,
                   num_iters: int = 100000, decay_style: str = "cosine",
                   decay_ratio: float = 0.5, weight_decay: float = 1e-2,
                   betas: Tuple[float, float] = (0.9, 0.95), eps: float = 1e-8,
                   grad_clip: float = 1.0) -> Tuple[AdamW, Callable[[int], float]]:
    """-> (optimizer, schedule), the JAX package's defaults."""
    schedule = annealing_lr(lr, warmup_iter, num_iters, decay_style, decay_ratio)
    return AdamW(params, schedule, weight_decay=weight_decay, betas=betas, eps=eps,
                 grad_clip=grad_clip), schedule
