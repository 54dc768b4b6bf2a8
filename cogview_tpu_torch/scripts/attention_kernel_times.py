"""Device time of the attention kernels K1-K5 at the shapes of PERF.md §6's
D = 64 rows, and of K3 at one shape by head dim, tile and copy width, one
JSON line, for holding two checkouts against each other on one card.

  python -m cogview_tpu_torch.scripts.attention_kernel_times [--reps 25]

K1 and K2: bf16 q, batch 4, 40 heads, 9 windows, index 600 (the split
plan's 4 splits) and 1031 (a seal). K3: bf16 on fused-QKV views, post-
selection's B=4, N=40, S=1,058 at sep 0, and the tutorial's training shape
B=16, N=16, S=1,088 with dropout 0.1 and without. K4 and K5: the training
shape with dropout 0.1 and without.

K3 by tile: K3 at the D = 100 pretraining shape (bf16, B=2, N=32, S=1,088,
sep 0, no dropout) at D = 128 in the exact library (D and the copy width
constants) and in the run-time one (``flash_attention_16_128``) at 16-, 8-
and 4-byte copies, at D = 112 and 100 in the 128 tile, and at D = 96 in
its own tile, each at the copy widths its heads allow.  A copy width is
chosen by where the operands start in one buffer (a pointer 8, 4 or 2
bytes past a 16-byte boundary); each output is held against the plain
version (2e-2) and the script exits non-zero on a difference.  These
call the wrapper's launch path with a named library.

A copy of the script runs in any checkout whose flash wrapper has tile
libraries (run parent, this tree, this tree, parent in one call to
compare).

Each time is the median of ``--reps`` calls between CUDA events behind a
queued sleep (``_timing.median_device_us``). Random inputs from fixed
seeds. Exits non-zero without a card.
"""

from __future__ import annotations

import argparse
import json
import subprocess

import torch

from cogview_tpu_torch.ops import decode_attention as da
from cogview_tpu_torch.ops import flash_attention as fa

from ._timing import median_device_us

# (head dim, tile's library or None for the wrapper's choice, copy widths)
TILE_CASES = ((128, fa.EXACT_LIBRARY, (16,)), (128, "flash_attention_16_128", (16, 8, 4)),
              (112, None, (16, 8)), (100, None, (8, 4, 2)), (96, None, (16, 8)))


def decode_times(packed: bool, reps: int) -> dict:
    B, N, D, NW, W, G = 4, 40, 64, 9, da.WRITE_WINDOW, da.SEAL_GROUP
    gen = torch.Generator(device="cuda").manual_seed(1)
    if packed:
        hi, lo = (torch.randint(-7, 8, (NW, B, 2, N, D // 2, W), generator=gen, device="cuda")
                  for _ in range(2))
        kv = (16 * hi + lo + 8).to(torch.int8)
    else:
        kv = torch.randint(-127, 128, (NW, B, 2, N, D, W), generator=gen, device="cuda",
                           dtype=torch.int8)
    sc = torch.rand((NW, B, 2, N, W), generator=gen, device="cuda") * 0.02
    ring = torch.randn((G, B, N, 2 * D), generator=gen, device="cuda")
    q = torch.randn((B, N, D), generator=gen, device="cuda").to(torch.bfloat16)
    return {f"index{i}": median_device_us(lambda: da.decode_attention_quant(q, ring, kv, sc, i),
                                          reps)
            for i in (600, 1031)}


def flash_inputs(B, N, S, seed, D=64, skew=0):
    """q, k, v as views of one fused bf16 QKV buffer starting ``skew``
    elements past its base, and dO."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    n = B * S * 3 * N * D
    buf = torch.randn((n + 8,), generator=gen, device="cuda").to(torch.bfloat16)
    qkv = buf[skew:skew + n].view(B, S, 3, N * D)
    q, k, v = (qkv[:, :, i].reshape(B, S, N, D) for i in range(3))
    do = torch.randn((B, S, N, D), generator=gen, device="cuda").to(torch.bfloat16)
    return q, k, v, do


def forward_in(library, q, k, v):
    """K3 (sep 0, no dropout) in ``library``, or the wrapper's choice."""
    if library is None:
        return fa.flash_attention(q, k, v, 0)
    B, S, N, D, layout = fa._cuda_operands(("q", q), ("k", k), ("v", v))
    o = torch.empty((B, S, N, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, N, S), dtype=torch.float32, device=q.device)
    fa.launch(library, "flash_attention_fwd", q.device, q.data_ptr(), k.data_ptr(),
              v.data_ptr(), o.data_ptr(), lse.data_ptr(), 1, B, S, N, *layout,
              *fa._dropout_args(D, N, 0, 0.0, None, (0, 0, None)))
    return o, lse


def tile_times(reps: int) -> dict:
    out = {}
    for D, library, widths in TILE_CASES:
        for width in widths:
            # elements past a 16-byte boundary that leave exactly `width`-byte alignment
            q, k, v, _ = flash_inputs(2, 32, 1088, 6, D, skew=width // 2 % 8)
            got = fa.copy_width([q, k, v], D)
            if got != width:
                raise SystemExit(f"D={D}: asked for {width}-byte copies, the operands give {got}")
            name = library or fa._library(D, fa.tile_width(D), width)
            o, _ = forward_in(library, q, k, v)
            ro, _ = fa.flash_attention_reference(q, k, v, 0)
            err = (o.float() - ro.float()).abs().max().item()
            if not err <= 2e-2:
                raise SystemExit(f"K3 in {name} at D={D}, {width}-byte copies: o differs by {err}")
            key = f"D{D}_tile{fa.tile_width(D)}_{name}_copy{width}"
            out[key] = median_device_us(lambda: forward_in(library, q, k, v), reps)
            del q, k, v, o, ro
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--reps", type=int, default=25)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: this script times the card's kernels")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip().splitlines()[0]
    reps = args.reps
    out = {"K1": decode_times(False, reps), "K2": decode_times(True, reps)}
    q, k, v, _ = flash_inputs(4, 40, 1058, 2)
    out["K3"] = {"post_selection": median_device_us(lambda: fa.flash_attention(q, k, v, 0), reps)}
    q, k, v, do = flash_inputs(16, 16, 1088, 4)
    drop = dict(dropout_rate=0.1, dropout_seed=1234)
    out["K3"]["train_dropout"] = median_device_us(
        lambda: fa.flash_attention(q, k, v, 0, **drop), reps)
    out["K3"]["train"] = median_device_us(lambda: fa.flash_attention(q, k, v, 0), reps)
    with torch.no_grad():
        o, lse = fa.flash_attention(q, k, v, 0)
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    bwd = (q, k, v, do, lse, delta, 0)
    for name, fn in (("K4", fa.flash_bwd_dq), ("K5", fa.flash_bwd_dkv)):
        out[name] = {"train_dropout": median_device_us(lambda: fn(*bwd, **drop), reps),
                     "train": median_device_us(lambda: fn(*bwd), reps)}
    del q, k, v, do, o, lse, delta
    out["K3_tiles"] = tile_times(reps)
    print(json.dumps({"device": smi, "us": out}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
