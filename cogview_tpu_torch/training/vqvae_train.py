"""VQ-VAE training steps (twin of cogview_tpu/training/vqvae_train.py).

Reconstruction MSE plus ``latent_weight`` x the commitment term, with the
straight-through estimator and the EMA codebook; or the gumbel relaxation
with ``kl_weight`` x KL(q || uniform), soft or hard (hard mode also
updates the codebook by EMA).  As in the JAX package the codebook takes no
gradient step: Adam (``optax.adam(lr)``: b1 0.9, b2 0.999, eps 1e-8 outside
the square root, bias correction; here :class:`..training.optim.AdamW` at
weight decay 0 and no clipping, which is that arithmetic) updates the
encoder and the decoder, and the codebook is then replaced by the EMA
result.  The JAX step runs Adam over the codebook too, on zeroed
gradients, which leaves it unchanged; here it is left out.

state: ``{"params", "opt_state", "step"}``; a step updates it in place and
returns its metrics as 0-d tensors (no host sync).
"""

from __future__ import annotations

from typing import Any, Callable, Dict

import torch

from ..models import vqvae
from .optim import AdamW, tree_leaves

TRAINED = ("encoder", "decoder")


def make_adam(params, lr: float) -> AdamW:
    """``optax.adam(lr)`` over the encoder and the decoder."""
    return AdamW({k: params[k] for k in TRAINED}, lambda _count: lr, weight_decay=0.0,
                 betas=(0.9, 0.999), eps=1e-8, grad_clip=0.0)


def init_vqvae_train_state(params, tx: AdamW) -> Dict[str, Any]:
    return {"params": params, "opt_state": tx.init({k: params[k] for k in TRAINED}),
            "step": 0}


def vqvae_loss(params, batch: torch.Tensor, latent_weight: float = 0.25):
    """batch: normalized images [B, H, W, 3] -> (loss, aux)."""
    z = vqvae.encode_features(params, batch)
    quant, codes, commit, _ = vqvae.quantize_st(params, z)
    recon = vqvae.decode_nhwc(params, quant)
    mse = torch.mean((recon - batch) ** 2)
    return mse + latent_weight * commit, {"recon_mse": mse, "commit": commit,
                                          "codes": codes, "z": z}


def _step(state, tx: AdamW, loss_fn: Callable, ema: bool, decay: float):
    params = state["params"]
    trained = {k: params[k] for k in TRAINED}
    leaves = list(tree_leaves(trained))
    for p in leaves:
        p.requires_grad_(True)
    loss, aux = loss_fn(params)
    grads = torch.autograd.grad(loss, leaves)
    for p in leaves:
        p.requires_grad_(False)
    q = params["quantize"]
    if ema:
        onehot_sum, embed_sum = vqvae.codebook_stats(aux["z"], aux["codes"], q["embed"].shape[1])
        q = vqvae.apply_ema(q, onehot_sum, embed_sum, decay=decay)
    tx.update(_rebuild(trained, iter(grads)), state["opt_state"], trained)
    params["quantize"] = q
    state["step"] += 1
    return loss.detach(), aux, q


def _rebuild(tree, it):
    """The tree of ``tree``'s shape whose leaves come from ``it`` in
    :func:`tree_leaves` order."""
    return {k: _rebuild(tree[k], it) if isinstance(tree[k], dict) else next(it)
            for k in sorted(tree)}


def make_vqvae_train_step(tx: AdamW, latent_weight: float = 0.25, decay: float = 0.99):
    """-> step(state, batch) -> metrics: straight-through + EMA codebook."""

    def step(state, batch):
        loss, aux, q = _step(state, tx, lambda p: vqvae_loss(p, batch, latent_weight),
                             True, decay)
        # the share of codes used, as mean(bincount > 0) without bincount's
        # host sync
        used = torch.zeros(q["embed"].shape[1], device=loss.device)
        used.scatter_(0, aux["codes"].reshape(-1), 1.0)
        return {"loss": loss, "recon_mse": aux["recon_mse"].detach(),
                "commit": aux["commit"].detach(), "codebook_usage": used.mean()}

    return step


def make_vqvae_gumbel_train_step(tx: AdamW, kl_weight: float = 0.25, hard: bool = False,
                                 decay: float = 0.99):
    """-> step(state, batch, generator, temperature, noise=None) -> metrics:
    the gumbel relaxation; ``noise`` [B*h*w, K] replaces the draw from
    ``generator``."""

    def loss_fn(params, batch, generator, temperature, noise):
        z = vqvae.encode_features(params, batch)
        quant, kl, codes = vqvae.quantize_gumbel(params, z, generator, temperature, hard, noise)
        recon = vqvae.decode_nhwc(params, quant)
        mse = torch.mean((recon - batch) ** 2)
        return mse + kl_weight * kl, {"recon_mse": mse, "kl": kl, "codes": codes, "z": z}

    def step(state, batch, generator=None, temperature: float = 1.0, noise=None):
        loss, aux, _ = _step(state, tx, lambda p: loss_fn(p, batch, generator, temperature,
                                                          noise), hard, decay)
        return {"loss": loss, "recon_mse": aux["recon_mse"].detach(),
                "kl": aux["kl"].detach()}

    return step
