"""Training step (twin of cogview_tpu/training/train_loop.py).

One step computes the masked LM loss and its gradients, and applies the
optimizer only when the loss and the global gradient norm are finite: a
non-finite step leaves params and optimizer state as they were and adds one
to ``skipped`` (the reference's NaN-skip).  The float16 step scales the loss
and drives the dynamic loss scaler (training/loss_scaler.py).

The train state is a dict: ``params`` (leaf tensors with ``requires_grad``),
``opt_state``, ``step``, ``skipped``, ``generator`` (the ``torch.Generator``
each step draws its L + 1 uint32 dropout seeds, and the sparse pivots,
from) and, for float16, ``loss_scale``.  The step factories also train with
pivot + window sparse attention, the dual-segment position ids of
super-resolution finetuning, or the transformer-XL memory; the memory
advances even on a skipped step, as the reference's does.

Under an ambient mesh (parallel/mesh.py) the step trains this rank's
shards on its rows of the global batch: the loss is the global masked
mean, the gradients of every leaf not split over 'data' are all-reduced
over 'data' (an FSDP leaf's were reduce-scattered in the backward), and
under sequence parallelism every gradient over 'seq' as well, in the same
collective; a pipeline stage's gradients are its layers' and the whole
replicated leaves' (parallel/pipeline.py); the global norm sums every
shard once, the NaN-skip decision is one flag
all-reduced over every rank, and AdamW updates the local shards.  The
generator is replicated: every rank draws the same seeds and pivots.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from ..config import GPTConfig
from ..parallel import comm
from ..parallel.mesh import DATA_AXIS, SEQ_AXIS, current_mesh
from ..parallel.sharding import spec_leaves, specs_for
from .loss_scaler import LossScaleState, init_loss_scale, update_loss_scale
from .losses import lm_loss, lm_loss_with_mems
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


def _loss_fn(cfg: GPTConfig, *, img_vocab: int, txt_loss_scale: float, remat: bool,
             is_sparse: bool, dual_positions_roi2: Optional[int], max_memory_length: int):
    """-> loss_fn(params, batch, seeds, generator, mems, pivot_idx) -> (loss,
    metrics, new mems or None)."""
    if is_sparse and max_memory_length:
        raise ValueError("sparse training attention has no mems path "
                         "(the reference trains sparse with --max-memory-length 0)")
    common = dict(img_vocab=img_vocab, txt_loss_scale=txt_loss_scale, train=True,
                  remat=remat, dual_positions_roi2=dual_positions_roi2)

    def fn(params, batch, seeds, generator, mems, pivot_idx):
        if max_memory_length > 0:
            return lm_loss_with_mems(params, cfg, batch, mems,
                                     max_memory_length=max_memory_length, seeds=seeds,
                                     **common)
        loss, metrics = lm_loss(params, cfg, batch, seeds=seeds, is_sparse=is_sparse,
                                generator=generator, pivot_idx=pivot_idx, **common)
        return loss, metrics, None

    return fn


def _grads(cfg: GPTConfig, loss_fn, state: TrainState, batch, seeds, scale: Optional[float],
           mems, pivot_idx):
    """-> (loss, metrics, grads as a tree, their global norm, new mems), the
    gradients divided by ``scale`` when one is given."""
    params = state["params"]
    leaves = list(tree_leaves(params))
    dev = leaves[0].device
    batch = {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}
    if seeds is None:
        seeds = draw_seeds(state["generator"], cfg.num_layers + 1)
    loss, metrics, new_mems = loss_fn(params, batch, seeds, state["generator"], mems,
                                      pivot_idx)
    grads = torch.autograd.grad(loss if scale is None else loss * scale, leaves)
    if scale is not None:
        inv = torch.tensor(1.0 / scale, dtype=torch.float32, device=dev)
        grads = [g * inv for g in grads]
    mesh = current_mesh()
    specs = None
    if mesh is not None:
        specs = spec_leaves(params, specs_for(params, mesh))
        grads = [comm.all_reduce(g, (SEQ_AXIS,) if DATA_AXIS in spec else (DATA_AXIS, SEQ_AXIS))
                 for g, spec in zip(grads, specs)]
    g_norm = global_norm(grads, specs)
    return metrics["lm_loss"].detach(), metrics, _unflatten(params, grads), g_norm, new_mems


def _metrics(metrics, g_norm, skipped: bool) -> Dict[str, float]:
    out = {k: float(v.detach()) for k, v in metrics.items()}
    out.update(grad_norm=float(g_norm), skipped=int(skipped))
    return out


def make_train_step(cfg: GPTConfig, opt: AdamW, *, img_vocab: int = 8192,
                    txt_loss_scale: float = 1.0, remat: bool = True, is_sparse: bool = False,
                    dual_positions_roi2: Optional[int] = None, max_memory_length: int = 0):
    """-> train_step(state, batch, seeds=None, mems=None, pivot_idx=None) ->
    (state, metrics), or (state, metrics, new_mems) when
    ``max_memory_length > 0`` (pass ``mems=None`` on the first step; the
    memory grows to its cap over the first steps).

    ``batch`` holds ``text`` and ``loss_mask`` (numpy or tensors).  The step
    draws its seeds from ``state["generator"]`` unless ``seeds`` (L + 1
    uint32 values) are given, and with ``is_sparse`` then its pivots, unless
    ``pivot_idx`` is given.  ``dual_positions_roi2`` is the [ROI2] id of
    super-resolution finetuning's dual-segment position ids.  Sparse
    attention with mems raises.  ``state`` is updated in place and
    returned."""
    loss_fn = _loss_fn(cfg, img_vocab=img_vocab, txt_loss_scale=txt_loss_scale, remat=remat,
                       is_sparse=is_sparse, dual_positions_roi2=dual_positions_roi2,
                       max_memory_length=max_memory_length)

    def step(state: TrainState, batch, seeds: Optional[Sequence[int]] = None, mems=None,
             pivot_idx=None):
        loss, metrics, grads, g_norm, new_mems = _grads(cfg, loss_fn, state, batch, seeds,
                                                        None, mems, pivot_idx)
        finite = comm.all_finite([loss, g_norm])
        if finite:
            opt.update(grads, state["opt_state"], state["params"], g_norm)
        state["step"] += int(finite)
        state["skipped"] += int(not finite)
        out = (state, _metrics(metrics, g_norm, not finite))
        return out + (new_mems,) if max_memory_length > 0 else out

    return step


def make_fp16_train_step(cfg: GPTConfig, opt: AdamW, *, img_vocab: int = 8192,
                         txt_loss_scale: float = 1.0, remat: bool = True,
                         is_sparse: bool = False, dual_positions_roi2: Optional[int] = None,
                         max_memory_length: int = 0, scale_factor: float = 2.0,
                         scale_window: int = 1000, min_scale: float = 1.0, hysteresis: int = 2):
    """float16-compute step with dynamic loss scaling: params stay float32,
    the model computes in float16, the loss is scaled before the backward,
    the gradients are unscaled in float32, and an overflow skips the update
    and drives the scaler.  State from :func:`init_fp16_train_state`; the
    other arguments and the signature as :func:`make_train_step`."""
    cfg = cfg.replace(compute_dtype=torch.float16)
    loss_fn = _loss_fn(cfg, img_vocab=img_vocab, txt_loss_scale=txt_loss_scale, remat=remat,
                       is_sparse=is_sparse, dual_positions_roi2=dual_positions_roi2,
                       max_memory_length=max_memory_length)

    def step(state: TrainState, batch, seeds: Optional[Sequence[int]] = None, mems=None,
             pivot_idx=None):
        ls: LossScaleState = state["loss_scale"]
        loss, metrics, grads, g_norm, new_mems = _grads(cfg, loss_fn, state, batch, seeds,
                                                        ls.scale, mems, pivot_idx)
        overflow = not comm.all_finite([loss, g_norm])
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
        return (state, out) + ((new_mems,) if max_memory_length > 0 else ())

    return step
