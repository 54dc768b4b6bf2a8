"""Quality of the int8 and int4 KV caches against the exact bf16 cache: the
counterpart of scripts/kv_quality_check.py, with its flags and its keys.

A token stream is made once by the bf16-cache model (greedy over the image
vocabulary, after a random prefix of image tokens) and then forced into
the int8 and the int4 cache, so every run sees the same inputs and what
differs is the caches' quantization error, accumulated over the rollout.
Per cache:

  kl_mean_nats, kl_p99_nats        per-step KL(bf16 || quantized) over the
                                   whole vocabulary, mean and 99th percentile;
  argmax_flip_rate                 steps whose greedy image token changes;
  sampled_flip_rate                steps whose drawn image token changes
                                   under the same gumbel noise;
  mean_abs_dlogit_at_ref_argmax    |delta logit| at the bf16 argmax.

The prefix and the gumbel noise come from numpy's RandomState as the JAX
script draws them; the weights are random, from the port's own generator
seeded with ``--seed`` (a caller may pass other weights to :func:`run`).
On a card every decode step of a quantized cache runs K1 (int8) or K2
(int4); ``--device cpu`` runs the plain versions.

Usage: python -m cogview_tpu_torch.scripts.kv_quality_check
       [--preset tutorial] [--batch 4] [--steps 256] [--prefix 33]
       [--seed 0] [--json] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, Optional

import numpy as np
import torch

from ..config import cogview_base, cogview_tutorial, tiny_test
from ..models import gpt
from ._timing import pick_device

PRESETS = {
    "tiny": lambda: tiny_test(compute_dtype=torch.bfloat16),
    "tutorial": cogview_tutorial,
    "base": cogview_base,
}
CACHES = ("int8", "int4")


def img_vocab(preset: str) -> int:
    return 64 if preset == "tiny" else 8192


def rollout(params, cfg, prefix: torch.Tensor, steps: int, vocab: int,
            forced: Optional[np.ndarray] = None):
    """Prefill ``prefix`` [B, S0], then ``steps`` decode steps -> (logits
    [B, steps, V] float32, tokens [B, steps]) in numpy.  Without ``forced``
    the model's greedy image token is fed back."""
    B, S0 = prefix.shape
    dev = prefix.device
    total = S0 + steps
    pos = torch.arange(total, device=dev).expand(B, total)
    cache = gpt.init_cache(cfg, B, total, device=dev)
    cur = gpt.forward_with_cache(params, cfg, prefix, pos[:, :S0], cache, 0)[:, -1]
    logits, toks = [], []
    for t in range(steps):
        cur = cur.float().cpu().numpy()
        logits.append(cur)
        nxt = cur[:, :vocab].argmax(-1) if forced is None else forced[:, t]
        toks.append(nxt)
        tok = torch.as_tensor(nxt, dtype=torch.long, device=dev)[:, None]
        cur = gpt.forward_with_cache(params, cfg, tok, pos[:, S0 + t:S0 + t + 1], cache,
                                     S0 + t)[:, 0]
    return np.stack(logits, 1), np.stack(toks, 1)


def _log_softmax(x: np.ndarray) -> np.ndarray:
    x = x - x.max(-1, keepdims=True)
    return x - np.log(np.exp(x).sum(-1, keepdims=True))


def compare(ref: np.ndarray, got: np.ndarray, gumbel: np.ndarray, vocab: int) -> Dict:
    """The reported keys of one cache's logits ``got`` against ``ref``."""
    ref_lp, got_lp = _log_softmax(ref), _log_softmax(got)
    kl = (np.exp(ref_lp) * (ref_lp - got_lp)).sum(-1)  # [B, T] nats
    ref_argmax = ref[..., :vocab].argmax(-1)
    flips = got[..., :vocab].argmax(-1) != ref_argmax
    sflips = (got[..., :vocab] + gumbel).argmax(-1) != (ref[..., :vocab] + gumbel).argmax(-1)
    dlogit = np.take_along_axis(np.abs(got - ref), ref_argmax[..., None], axis=-1)
    return {"kl_mean_nats": float(kl.mean()),
            "kl_p99_nats": float(np.percentile(kl, 99)),
            "argmax_flip_rate": float(flips.mean()),
            "sampled_flip_rate": float(sflips.mean()),
            "mean_abs_dlogit_at_ref_argmax": float(dlogit.mean())}


def run(device: torch.device, preset: str = "tutorial", batch: int = 4, steps: int = 256,
        prefix: int = 33, seed: int = 0, params=None, verbose: bool = True) -> Dict:
    """The bf16 stream, then both quantized caches forced along it ->
    {"preset", "batch", "steps", "prefix", "seed", "int8": {...}, "int4": {...}}.
    ``params`` (bf16 GPT params on ``device``) default to random ones from
    ``seed``."""
    cfg0 = PRESETS[preset]()
    vocab = img_vocab(preset)
    if prefix + steps > cfg0.max_position_embeddings:
        raise SystemExit(f"prefix + steps = {prefix + steps} exceeds the "
                         f"{cfg0.max_position_embeddings} positions of {preset}")
    if params is None:
        params = gpt.init_params(cfg0, torch.Generator(device=device).manual_seed(seed),
                                 dtype=torch.bfloat16, device=device)
    rng = np.random.RandomState(seed)
    ids = rng.randint(vocab, min(cfg0.vocab_size, vocab + 1000), (batch, prefix))
    ids = torch.as_tensor(ids, dtype=torch.long, device=device)

    with torch.no_grad():
        ref, forced = rollout(params, cfg0.replace(kv_cache_dtype="bfloat16"), ids, steps,
                              vocab)
        # the same gumbel noise for every cache: only the logits flip a draw
        gumbel = np.random.RandomState(seed + 1).gumbel(size=(batch, steps, vocab))
        gumbel = gumbel.astype(np.float32)
        out = {"preset": preset, "batch": batch, "steps": steps, "prefix": prefix,
               "seed": seed}
        for kv in CACHES:
            got, _ = rollout(params, cfg0.replace(kv_cache_dtype=kv), ids, steps, vocab,
                             forced)
            out[kv] = m = compare(ref, got, gumbel, vocab)
            if verbose:
                print(f"{kv}: KL mean {m['kl_mean_nats']:.4e} p99 {m['kl_p99_nats']:.4e} "
                      f"nats | argmax flips {m['argmax_flip_rate']:.3%} | sampled flips "
                      f"{m['sampled_flip_rate']:.3%} | d|logit|@ref "
                      f"{m['mean_abs_dlogit_at_ref_argmax']:.4f}", flush=True)
    return out


def main(argv=None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--preset", default="tutorial", choices=sorted(PRESETS))
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--steps", type=int, default=256,
                    help="teacher-forced decode steps (<= 1024)")
    ap.add_argument("--prefix", type=int, default=33,
                    help="prefix length before decoding")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--json", action="store_true")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = ap.parse_args(argv)
    device = pick_device(args.device)
    out = run(device, args.preset, args.batch, args.steps, args.prefix, args.seed,
              verbose=not args.json)
    if device.type == "cuda":
        out["device"] = torch.cuda.get_device_name(device)
    if args.json:
        print(json.dumps(out))
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
