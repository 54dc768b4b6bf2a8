"""Training step (twin of cogview_tpu/training/train_loop.py).

One step computes the masked LM loss and its gradients, and applies the
optimizer only when the loss and the global gradient norm are finite: a
non-finite step leaves params and optimizer state as they were and adds one
to ``skipped`` (the reference's NaN-skip).  The float16 step scales the loss
and drives the dynamic loss scaler (training/loss_scaler.py).

The train state is a dict: ``params`` (leaf tensors with ``requires_grad``),
``opt_state``, ``step``, ``skipped``, ``generator`` (the ``torch.Generator``
each step draws its L + 1 uint32 dropout seeds from) and, for float16,
``loss_scale``.  Transformer-XL mems, sparse attention and the dual-segment
position ids are not ported.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from ..config import GPTConfig
from .loss_scaler import LossScaleState, init_loss_scale, update_loss_scale
from .losses import lm_loss
from .optim import AdamW, global_norm, tree_leaves, tree_map

TrainState = Dict[str, Any]


def init_train_state(params, opt: AdamW, generator: torch.Generator) -> TrainState:
    """``params`` become leaves that require grad (in place)."""
    tree_map(lambda p: p.requires_grad_(True), params)
    return {"params": params, "opt_state": opt.init(params), "step": 0, "skipped": 0,
            "generator": generator}


def init_fp16_train_state(params, opt: AdamW, generator: torch.Generator,
                          init_scale: float = 2.0 ** 32, hysteresis: int = 2) -> TrainState:
    state = init_train_state(params, opt, generator)
    state["loss_scale"] = init_loss_scale(init_scale, hysteresis)
    return state


def draw_seeds(generator: torch.Generator, n: int) -> List[int]:
    """``n`` uint32 seeds from ``generator``."""
    return torch.randint(0, 2 ** 32, (n,), generator=generator, dtype=torch.int64).tolist()


def _unflatten(tree, leaves):
    it = iter(leaves)

    def build(t):
        return {k: build(t[k]) if isinstance(t[k], dict) else next(it) for k in sorted(t)}

    return build(tree)


def _grads(cfg: GPTConfig, state: TrainState, batch, seeds, scale: Optional[float],
           img_vocab: int, txt_loss_scale: float, remat: bool):
    """-> (loss, metrics, grads as a tree, their global norm), the gradients
    divided by ``scale`` when one is given."""
    params = state["params"]
    leaves = list(tree_leaves(params))
    dev = leaves[0].device
    batch = {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}
    if seeds is None:
        seeds = draw_seeds(state["generator"], cfg.num_layers + 1)
    loss, metrics = lm_loss(params, cfg, batch, img_vocab=img_vocab,
                            txt_loss_scale=txt_loss_scale, seeds=seeds, train=True,
                            remat=remat)
    grads = torch.autograd.grad(loss if scale is None else loss * scale, leaves)
    if scale is not None:
        inv = torch.tensor(1.0 / scale, dtype=torch.float32, device=dev)
        grads = [g * inv for g in grads]
    g_norm = global_norm(grads)
    return loss.detach(), metrics, _unflatten(params, grads), g_norm


def _metrics(metrics, g_norm, skipped: bool) -> Dict[str, float]:
    out = {k: float(v.detach()) for k, v in metrics.items()}
    out.update(grad_norm=float(g_norm), skipped=int(skipped))
    return out


def make_train_step(cfg: GPTConfig, opt: AdamW, *, img_vocab: int = 8192,
                    txt_loss_scale: float = 1.0, remat: bool = True):
    """-> train_step(state, batch, seeds=None) -> (state, metrics).

    ``batch`` holds ``text`` and ``loss_mask`` (numpy or tensors).  The step
    draws its seeds from ``state["generator"]`` unless ``seeds`` (L + 1
    uint32 values) are given.  ``state`` is updated in place and returned."""

    def step(state: TrainState, batch, seeds: Optional[Sequence[int]] = None
             ) -> Tuple[TrainState, Dict[str, float]]:
        loss, metrics, grads, g_norm = _grads(cfg, state, batch, seeds, None, img_vocab,
                                              txt_loss_scale, remat)
        finite = bool(torch.isfinite(loss)) and bool(torch.isfinite(g_norm))
        if finite:
            opt.update(grads, state["opt_state"], state["params"], g_norm)
        state["step"] += int(finite)
        state["skipped"] += int(not finite)
        return state, _metrics(metrics, g_norm, not finite)

    return step


def make_fp16_train_step(cfg: GPTConfig, opt: AdamW, *, img_vocab: int = 8192,
                         txt_loss_scale: float = 1.0, remat: bool = True,
                         scale_factor: float = 2.0, scale_window: int = 1000,
                         min_scale: float = 1.0, hysteresis: int = 2):
    """float16-compute step with dynamic loss scaling: params stay float32,
    the model computes in float16, the loss is scaled before the backward,
    the gradients are unscaled in float32, and an overflow skips the update
    and drives the scaler.  State from :func:`init_fp16_train_state`."""
    cfg = cfg.replace(compute_dtype=torch.float16)

    def step(state: TrainState, batch, seeds: Optional[Sequence[int]] = None
             ) -> Tuple[TrainState, Dict[str, float]]:
        ls: LossScaleState = state["loss_scale"]
        loss, metrics, grads, g_norm = _grads(cfg, state, batch, seeds, ls.scale, img_vocab,
                                              txt_loss_scale, remat)
        overflow = not (bool(torch.isfinite(loss)) and bool(torch.isfinite(g_norm)))
        new_ls, apply = update_loss_scale(ls, overflow, scale_factor=scale_factor,
                                          scale_window=scale_window, min_scale=min_scale,
                                          hysteresis=hysteresis)
        if apply:
            opt.update(grads, state["opt_state"], state["params"], g_norm)
        state["step"] += int(apply)
        state["skipped"] += int(overflow)
        state["loss_scale"] = new_ls
        out = _metrics(metrics, g_norm, overflow)
        out["loss_scale"] = new_ls.scale
        return state, out

    return step
