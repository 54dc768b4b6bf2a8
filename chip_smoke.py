#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each prints its lines; any failure exits non-zero and prints no
result):

1. device: require CUDA, print the card's name and power limit, turn TF32 off;
2. build: compile the three kernel sources from cogview_tpu_torch/csrc/ with
   nvcc, one process per source, in parallel;
3. decode kernels: K1 (int8 cache) and K2 (packed int4 cache) against their
   plain PyTorch version at cogview-base head shapes (N=40, D=64, 9
   windows) at batch 4 (the split plan's 4 splits) and 40 (one), float32
   and bfloat16 queries, seal and non-seal steps (index 135 seals on a
   window boundary, 1031 mid-window, index 3 has every sealed column
   masked), and at batch 1 over 11 windows, a super-resolution window's
   cache (indices 1300, and 1151 and 1343, seals); context within
   tolerance, cache bytes bit-equal, two launches bit-equal; the
   microseconds per call of both at index 600 and 1031 at batches 4 and 40
   and at 1300 and 1343 at batch 1, and the bound; at batch 4 also at
   every split count.
   Then the SASS of all 20 decode instantiations holds LDGSTS (cp.async),
   their registers are printed, and at D=64 they spill nothing;
4. flash forward kernel (K3; bf16 on the tensor cores, float32 FMA):
   against its plain PyTorch version at cogview-base head shapes (B=4,
   N=40, D=64) on strided q/k/v views of a fused QKV tensor, float32 and
   bfloat16: S=1058 (post-selection), S=1089 with a prefix that crosses
   tiles, a ragged small S, and dropout 0.1; at the tutorial's training
   shape (B=16, N=16, S=1088, sep 0, dropout 0.1); and at D=16, 32, 128
   (B=2, N=4, S=77, and 333 with dropout); o and lse within tolerance, two
   launches bit-equal; the microseconds per call of both at S=1058, of the
   kernel at the training shape with and without dropout, and of
   F.scaled_dot_product_attention with the same mask and with is_causal at
   both shapes (yardsticks the port never calls), and the bounds;
5. flash backward kernels: dq (K4) and dk/dv (K5) against their plain
   versions at tutorial head shapes (B=16, N=16, S=1088, sep 0 and 64, the
   latter with dropout 0.1), cogview-base head shapes (B=4, N=40,
   S=1058) and at D=16, 32, 128 (B=2, N=4, S=130, and 333 with dropout),
   float32 and bfloat16; two launches bit-equal; the microseconds per call
   of both at the tutorial's training shape, with and without dropout, and
   of one torch.autograd.grad through SDPA with the boolean mask and with
   is_causal; then the SASS of every bf16 instantiation of the three flash
   kernels (8 each) holds HGMMA (wgmma) and LDGSTS (cp.async), their
   registers are printed, and at D=64 they spill nothing;
6. probes: P1a (add_one) on a random block and P2 (the seal's lane
   scatter) on the TPU probe's inputs and at every lane0 in [0, 120], with
   the one-hot and with it permuted within the group, bit-equal to their
   plain versions; P1b's SASS holds its cp.async copies, and every global
   store in P2's is 128 bits wide (STG.E.128).  Then the three measurement
   entry points at their default shapes, each of which checks what it times and exits non-zero on a
   difference: ``scripts.launch_probe`` (P1b at cogview-base width and batch
   40 on a random 12 GB cache, layers 0, 1, 47, bit-equal; the P1a and P1b
   480-call chains, eager and replayed from a CUDA graph, bit-equal to the
   plain chains), ``scripts.seal_scatter_probe`` (the 64-call loop and the
   kernel alone), and ``scripts.decode_kernel_microbench`` for the int8 and
   the int4 cache, for the int8 cache without the ring write, and for the
   int8 cache at batch 4 (K1, K2 on a random cache at batch 40, or 4, over
   1-9 live windows, each point's ctx against the plain version: the slope
   and intercept, eager and in a graph), each cache freed before the next.  The probes' times are per
   call of many calls replayed from one CUDA graph, the plain versions'
   and torch.add's beside them, with the bounds; P1a's, torch.add's and
   P1b's device time per launch is read by torch.profiler off graph
   replays, and P1b's bound share given on both;
7. small input: prefill + decode of a tiny float32 model through the int8,
   int4 and bfloat16 caches, and a tiny float32 forward through the flash
   kernel, on the card against the same model on the CPU (plain versions);
8. two tiny float32 train steps through the three flash kernels with
   dropout 0.1, card against CPU;
9. text->image: ``cogview_tpu_torch.cli.generate.main`` at cogview-base width
   (48 layers, random weights from a seed), int8 KV cache, batch 4, one
   request of 30 words, first with int8 weights, then with bf16 weights.
   Checks the generated ids, the four PNGs, and that every decode step of
   every layer launched K1 and never its plain version; decode steps
   512-519 of the bf16-weight request run under torch.profiler, which gives
   K1's device milliseconds per step, and the host clock per step before
   and after them (the profiler leaves a cost on later launches, so phase
   12, 15 and 16, the other long host-bound requests, run before the
   profiled request);
10. image->text: the CLI on the first bf16-weight PNG, batch 4: 20 text ids
   per row, 20 x 48 K1 launches;
11. post-selection: the CLI scores the four PNGs against the prompt: four
   finite negative scores in scores_rank_0.txt, 48 flash-kernel launches;
   the same tokens scored again through dense attention on the card agree;
12. serve: ``cogview_tpu_torch.cli.serve.main`` at cogview-base width with
   the int4 cache, bf16 weights, batch 4, one query file of the 30-word
   prompt: the file reaches done/ and failed/ stays empty, four PNGs, ids in
   [0, 8192), 1024 x 48 K2 launches, no K1 launch and no plain call;
13. cache fidelity: cogview-base at batch 4, random weights, the
   text->image context and 64 teacher-forced decode steps through the bf16,
   int8 and int4 caches: finite logits, the mean per-step KL of int8 and
   int4 against the bf16 cache (int8's no larger) and the argmax agreement;
14. pretraining: ``cogview_tpu_torch.cli.pretrain.main`` at the tutorial
   preset's widths (12 layers, hidden 1024, 16 heads, vocab 58,240), bf16
   compute, dropout 0.1, remat, batch 16 x 1,088 tokens, 30 steps on a
   CompactBinary corpus written from a seed: finite falling losses, no
   skipped step, every flash launch counted (2 forward and 1 of each
   backward kernel per layer and step, no plain call), the step time,
   tokens per second, device-busy share, each flash kernel's milliseconds
   per step (torch.profiler) and peak memory; then a ``--load``
   run resumes at the saved iteration and takes 2 more steps;
15. low-level super-resolution: the CLI at cogview-base width and depth,
   int8 cache, batch 4, on the prompt and the int8-weight request's first
   PNG read at 128 pixels (the bilinear resize): 256 context codes, 4 x
   1024 ids in [0, 8192), four finite PNGs, 1024 x 48 K1 launches;
16. super-resolution: the CLI with ``--preset cogview-sr`` at its
   published widths (hidden 2560, 40 heads, 1,345 positions, vocabulary
   58,240), depth cut to SR_LAYERS, int8 cache, batch 1, on the same PNG,
   its weights through ``--load`` of a 1,089-position bfloat16 DeepSpeed
   file at cogview-base widths and SR_LAYERS depth written here from
   seeds: every leaf bit-equal to the file's, the position table fitted
   to 1,345 rows (the file's 1,089, then the tiled rows); nine magnify
   windows, 4,096 codes in [0, 8192), a finite 512 x 512 image in
   sr-0.png, K1 launched once per decode step and layer.
   Phases 15 and 16 run between the int8- and the bf16-weight text->image
   requests;
17. checkpoint: a 48-layer cogview-base checkpoint in the reference's
   DeepSpeed layout (``{"module": state dict}``, ``module.`` keys, every
   tensor float16 from its own seed, 7.86 GB; written by a child process,
   ``chip_smoke.py --write-checkpoint``, so that this process never holds
   it) and a VQ-VAE state dict in the reference's layout, written to the
   phase's temporary directory; another child process (``chip_smoke.py
   --checkpoint-child``, so that its peak RSS measures the load alone)
   runs ``cli.generate.main`` with ``--load``
   and ``--img-tokenizer-path``, one image->text request on phase 9's
   first PNG: every leaf bit-equal to the file's tensors drawn again on the
   card, float16 kept, the load's peak host RSS at most 1.2 x the file
   above the RSS before it, 20 text ids a row, 960 K1 launches, the load's
   seconds and the decode step's milliseconds;
18. serving the pretraining checkpoint: after phase 14, ``cli.generate.main
   --preset tutorial --load <phase 14's save directory>``, one text->image
   request at batch 4: the loaded params equal the checkpoint's float32
   params cast to bf16, four finite PNGs, ids in [0, 8192), 1024 x 12 K1
   launches;
19. super-resolution finetuning from a checkpoint: ``cli.pretrain.main
   --preset cogview-base`` at its widths, depth cut to SR_LAYERS, 2 steps
   with --save (a 1,089-position checkpoint), then ``--preset cogview-sr
   --load <it> --finetune --dual-positions --dataset-type TokenizedDataset``
   for SR_TRAIN_STEPS steps on rows laid out as the JAX package's
   super-resolution rows (IndexedDataset, from a seed): iteration and
   optimizer count start at 0, [ROI2]'s id reaches the step, the position
   table's first 1,089 rows are the saved ones bit for bit and the rest the
   tiled table, finite losses, K3/K4/K5 once per layer and step (twice the
   forward); then ``--load`` of that checkpoint without --finetune resumes
   its iteration and optimizer count;
20. super-resolution finetuning at full depth: ``--preset cogview-sr
   --dual-positions``, 48 layers, batch SR_FULL_BATCH x 1,344 tokens,
   SR_FULL_STEPS steps, in a child process (``chip_smoke.py
   --sr-train-child``) whose peak device memory is its own, with the
   environment unchanged (the CLI sets the allocator's expandable
   segments itself): finite losses,
   no skipped step, 96 / 48 / 48 K3 / K4 / K5 launches a step; ms per step,
   tokens per second, peak memory, and two steps under torch.profiler
   (kernel time by kind, zero fills apart, busy share);
21. K3, K4 and K5 at the finetune's shape (B=2, N=40, D=64, S=1344, bf16,
   dropout 0.1 and none) against their plain versions, two launches
   bit-equal; their times beside the plain versions', the bounds, SDPA with
   the boolean mask and with is_causal, and torch.autograd.grad through it;
22. the memory, sparse and float16 routes through ``cli.pretrain.main`` at
   the tutorial preset, batch ROUTE_BATCH: ``--max-memory-length 512``
   (the memory of 13 hidden states at 512 positions), ``--is-sparse 1
   --query-window 64 --key-window-times 4 --num-pivot 256``, 6 steps each,
   and ``--fp16 --profile-dir`` for 14 steps from a loss scale of 2^16
   (the scale moves and not every step is skipped; the Chrome trace's
   kernels span steps 10-13): finite losses, no flash launch (these
   routes are dense torch, as in the JAX package).

23. preprocessing into pretraining: ``cogview_tpu_torch.cli.preprocess.main``
   at the released VQ-VAE geometry (channel 512, embed 256, 8,192 codes;
   a checkpoint in the reference's layout from a seed), text2image from a
   folder, a zip and a tar of the same 64 smooth 256 x 320 PNGs and a
   caption TSV: the three .bin files byte-equal, every row's codes those
   of the card's own img2code on the same arrays and in [0, 8192); the
   bfloat16 encoder's codes on the same arrays (the share equal to
   float32's); the encoder alone at batch 32 in float32 and bfloat16; super-resolution on
   4 images at 512 (16 rows, each laid out as the JAX package's); then 2
   ``cli.pretrain`` steps at the tutorial preset on the .bin: finite
   losses, the flash kernels launched;
24. VQ-VAE training: ``cli.vqtrain.main`` at the released geometry, batch
   32 x 256^2 on phase 23's images, 40 straight-through + EMA iterations
   (the recon MSE at the last log below the first, the codebook's
   cluster_size moved) and 20 with --gumbel --gumbel-hard; ms per
   iteration (CUDA events), images/s and peak memory of each;
25. FID and IS: ``cli.fid.main`` with the seeded random InceptionV3 on the
   card: FID(A, A) below 1e-3 and FID(A, B) > 0 for two sets of 32
   smooth 160 x 200 PNGs, --inception-score, a TSV of A's images giving the
   folder's statistics (to 1e-5), --extractor vq on phase 23's VQ-VAE;
   then pool3 alone at batch 50, 299 x 299 (images/s).

The next-to-last line is the kernels' JSON record (each kernel's launches
on the main path, error, time, plain version's time, bound and library
time), the last line ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import math
import os
import re
import resource
import statistics
import subprocess
import sys
import tempfile
import time
import zlib


def _fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    raise SystemExit(1)


def _check(cond: bool, msg: str) -> None:
    if not cond:
        _fail(msg)


class WordTokenizer:
    """Stand-in text tokenizer while cog-pretrain.model is absent: a
    50,000-token vocabulary whose ``encode`` maps each word to a fixed id."""

    num_tokens = 50000

    def encode(self, text):
        return [100 + zlib.crc32(w.encode()) % 30000 for w in text.split()]

    def decode(self, ids):
        return " ".join(f"<{i}>" for i in ids)


PROMPT = " ".join(f"word{i}" for i in range(30))


def _device_time_us(torch, fn, reps: int = 25) -> float:
    """Median device microseconds of ``fn()`` over ``reps`` calls, by CUDA
    events.  A queued sleep keeps the card busy while the host enqueues, so
    the interval holds device time only, not host launch overhead."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(20_000_000)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) * 1000.0)
    return statistics.median(times)


# the card's peaks for bound_ms: NVIDIA's H100 SXM data sheet, dense rates
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bf16": 989e12, "f32": 67e12}


def _bound(nbytes: float, ops: float, kind: str):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    operations over the peak rate of ``kind``."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / PEAK_OPS_PER_S[kind]
    return 1000.0 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def _decode_bound(B, N, D, Dc, G, index, q_bytes):
    """Least time of one decode call: the K/V bytes and scales of the c0
    visible sealed columns and the rem + 1 visible ring slots read once, q
    read once, ctx written once (plus the sealed group on a seal step);
    float32 operations (the dots run outside the tensor cores).  Columns the
    kernel streams but masks (those >= c0 of the last window, or the whole
    window at c0 = 0) and ring slots > rem are not counted."""
    rem = index % G
    c0, slots = index - rem, rem + 1
    nbytes = B * N * (c0 * 2 * (Dc + 4) + slots * 2 * D * 4 + 2 * D * q_bytes)
    if rem == G - 1:
        nbytes += B * N * G * 2 * (Dc + 4)
    ops = B * N * (c0 + slots) * 4 * D
    return _bound(nbytes, ops, "f32")


def _attn_pairs(S: int, sep: int) -> int:
    """Visible (query, key) pairs of the causal mask with a prefix of sep."""
    return sum(max(i + 1, sep) for i in range(S))


def _decode_inputs(torch, da, packed: bool, B: int, seed: int, NW: int):
    """Two layers of a random cogview-base cache (N=40, D=64, NW windows) at
    batch B -> (kv, scales, ring, float32 q)."""
    dev = torch.device("cuda")
    N, D, W, G, L = 40, 64, da.WRITE_WINDOW, da.SEAL_GROUP, 2
    gen = torch.Generator(device=dev).manual_seed(seed)
    if packed:  # bytes the packer can make: 16 * hi + lo + 8, hi, lo in [-7, 7]
        hi, lo = (torch.randint(-7, 8, (L, NW, B, 2, N, D // 2, W), generator=gen, device=dev)
                  for _ in range(2))
        kv = (16 * hi + lo + 8).to(torch.int8)
        sc = torch.rand((L, NW, B, 2, N, W), generator=gen, device=dev) * 0.3
    else:
        kv = torch.randint(-127, 128, (L, NW, B, 2, N, D, W), generator=gen, device=dev,
                           dtype=torch.int8)
        sc = torch.rand((L, NW, B, 2, N, W), generator=gen, device=dev) * 0.02
    ring = torch.randn((L, G, B, N, 2 * D), generator=gen, device=dev)
    return kv, sc, ring, torch.randn((B, N, D), generator=gen, device=dev)


# phase 3's cases: (batch, seed, windows, indices checked, indices timed):
# text->image's 9 windows (1,088 positions) at batch 4 and 40, and a
# super-resolution window's cache at batch 1 (11 windows: a magnify or
# low-level SR template of 1,318 slots, up to 1,345 positions)
DECODE_CASES = ((4, 0, 9, (10, 133, 600, 15, 135, 1031, 3, 7, 1088), (600, 1031)),
                (40, 1, 9, (600, 1031), (600, 1031)),
                (1, 2, 11, (1300, 1343, 1151), (1300, 1343)))


def phase_kernel(torch, da, packed: bool):
    """K1 (int8 cache) or K2 (packed int4 cache) against the plain version
    at cogview-base head shapes, batch 4 and 40 over 9 windows and batch 1
    over 11, on layer 1 of a two-layer cache: ctx within tolerance, cache
    bytes bit-equal, two launches bit-equal; then the times of both, and at
    batch 4 of the kernel at every split count -> summary dict."""
    N, D, G, li = 40, 64, da.SEAL_GROUP, 1
    Dc = D // 2 if packed else D
    name = "K2 int4" if packed else "K1 int8"
    worst, times, split_us = 0.0, {}, {}
    # K1's bf16 path rounds q and p * vs to bf16 (2e-2); K2 computes in
    # float32 and rounds its bf16 ctx once, as its plain version does, so the
    # two may differ by the float32 tolerance plus one bf16 ulp (2^-7 of the
    # value), no more
    bf16_tol = None if packed else 2e-2
    for B, seed, NW, indices, timed in DECODE_CASES:
        kv, sc, ring, q32 = _decode_inputs(torch, da, packed, B, seed + (9 if packed else 0), NW)
        splits = da.split_plan(B, N, NW)
        for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, bf16_tol)):
            q = q32.to(dtype)
            for idx in indices:
                kv_k, sc_k, kv_2, sc_2, kv_r, sc_r = (t.clone() for t in (kv, sc) * 3)
                ctx_k = da.decode_attention_quant(q, ring[li], kv_k[li], sc_k[li], idx)
                ctx_2 = da.decode_attention_quant(q, ring[li], kv_2[li], sc_2[li], idx)
                ctx_r = da.decode_attention_quant_reference(q, ring[li], kv_r[li], sc_r[li], idx)
                torch.cuda.synchronize()
                diff = (ctx_k.float() - ctx_r.float()).abs()
                err = diff.max().item()
                if tol is None:
                    ok = bool((diff <= 1e-4 + ctx_r.float().abs() * 2.0 ** -7).all())
                    tol_text = "1e-4 + one bf16 ulp"
                else:
                    ok, tol_text = err <= tol, f"{tol:g}"
                seal = idx % G == G - 1
                same = torch.equal(kv_k, kv_r) and torch.equal(sc_k, sc_r)
                changed = not torch.equal(kv_k, kv)
                repeat = (torch.equal(ctx_k, ctx_2) and torch.equal(kv_k, kv_2)
                          and torch.equal(sc_k, sc_2))
                print(f"kernel {name} {str(dtype)[6:]} B={B} NW={NW} splits={splits} index={idx} "
                      f"seal={seal}: ctx max_abs_err={err:.3e} (tol {tol_text}) cache "
                      f"bit-equal={same} cache written={changed} repeat bit-equal={repeat}")
                _check(ctx_k.dtype == dtype and ctx_k.shape == (B, N, D), "ctx dtype/shape")
                _check(ok, f"{name} ctx error {err} beyond {tol_text} at B={B} index {idx}")
                _check(same, f"{name} cache differs from the plain version at B={B} index "
                       f"{idx}: {(kv_k != kv_r).sum().item()} bytes, "
                       f"{(sc_k != sc_r).sum().item()} scales")
                _check(changed == seal, f"{name} cache written={changed} on seal={seal} at "
                       f"index {idx}")
                _check(repeat, f"two launches of {name} differ at B={B} index {idx}")
                worst = max(worst, err)
                del kv_k, sc_k, kv_2, sc_2, kv_r, sc_r

        for dtype in (torch.float32, torch.bfloat16):
            q = q32.to(dtype)
            for idx in timed:
                kv_t, sc_t = kv.clone(), sc.clone()
                args = (q, ring[li], kv_t[li], sc_t[li], idx)
                us_k = _device_time_us(torch, lambda: da.decode_attention_quant(*args))
                us_p = _device_time_us(torch, lambda: da.decode_attention_quant_reference(*args))
                bound_ms, by = _decode_bound(B, N, D, Dc, G, idx, q.element_size())
                times[(B, str(dtype)[6:], idx)] = (us_k, us_p, bound_ms, by)
                print(f"kernel {name} time {str(dtype)[6:]} B={B} NW={NW} index={idx}: kernel "
                      f"{us_k:.2f} us/call ({splits} splits), plain {us_p:.1f} us/call (CUDA "
                      f"events, median of 25); bound {1000.0 * bound_ms:.2f} us ({by}), share "
                      f"{1000.0 * bound_ms / us_k:.3f}")
                if B == 4 and dtype == torch.bfloat16:
                    # the split plan's choice against every other split count
                    split_us[idx] = [_device_time_us(torch, lambda: da.decode_attention_quant(
                        *args, splits=s)) for s in range(1, NW + 1)]
                    print(f"kernel {name} time bf16 B=4 index={idx} at 1..{NW} splits: "
                          + ", ".join(f"{u:.2f}" for u in split_us[idx])
                          + f" us/call (the plan takes {splits})")
                del kv_t, sc_t
        del kv, sc, ring
        torch.cuda.empty_cache()
    return {"max_abs_err": worst, "times": times, "split_us": split_us}


def _flash_bound(B, N, D, S, sep, esz, kind):
    """Least time of one forward: q, k, v read once, o and lse written once;
    4 D operations (s and p.v) per visible pair."""
    return _bound(4 * B * S * N * D * esz + B * N * S * 4, 4 * D * _attn_pairs(S, sep) * B * N,
                  kind)


def phase_flash_kernel(torch, fa):
    """Flash kernel vs plain version at cogview-base head shapes (D = 64),
    at the tutorial's training shape, and at small shapes for the other head
    widths; two launches bit-equal -> summary."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(2)
    worst, times = 0.0, {}
    # (B, N, D, S, sep, dropout rate): post-selection's length, a prefix that
    # crosses the 64-row tiles, a ragged small S, dropout with a fixed seed,
    # and the tutorial's training shape with dropout; then two small cases
    # at each other head width
    cases = [(4, 40, 64, 1058, 0, 0.0), (4, 40, 64, 1089, 100, 0.0), (4, 40, 64, 77, 5, 0.0),
             (4, 40, 64, 333, 40, 0.1), (16, 16, 64, 1088, 0, 0.1)]
    cases += [(2, 4, d, S, sep, rate) for d in (16, 32, 128)
              for S, sep, rate in ((77, 5, 0.0), (333, 40, 0.1))]
    for B, N, D, S, sep, rate in cases:
        qkv32 = torch.randn((B, S, 3, N * D), generator=gen, device=dev)
        for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
            # strided views of a fused projection, as the model passes them
            qkv = qkv32.to(dtype)
            q, k, v = (qkv[:, :, i].reshape(B, S, N, D) for i in range(3))
            kw = dict(dropout_rate=rate, dropout_seed=1234 if rate else None)
            o, lse = fa.flash_attention(q, k, v, sep, **kw)
            o2, lse2 = fa.flash_attention(q, k, v, sep, **kw)
            ro, rlse = fa.flash_attention_reference(q, k, v, sep, **kw)
            torch.cuda.synchronize()
            err = (o.float() - ro.float()).abs().max().item()
            lerr = (lse - rlse).abs().max().item()
            same = torch.equal(o, o2) and torch.equal(lse, lse2)
            name = str(dtype)[6:]
            print(f"flash kernel {name} B={B} N={N} D={D} S={S} sep={sep} dropout={rate}: o "
                  f"max_abs_err={err:.3e} (tol {tol:g}), lse max_abs_err={lerr:.3e} (tol 1e-4); "
                  f"repeat bit-equal={same}")
            _check(o.dtype == dtype and o.shape == (B, S, N, D) and lse.shape == (B, N, S),
                   "flash o/lse dtype or shape")
            _check(err <= tol and lerr <= 1e-4, f"flash kernel differs at D={D} S={S} {name}")
            _check(same, f"two launches of the flash kernel differ at D={D} S={S} {name}")
            worst = max(worst, err)
            del o, o2, ro, lse, lse2, rlse
            if S == 1058:
                us_k = _device_time_us(torch, lambda: fa.flash_attention(q, k, v, sep))
                us_p = _device_time_us(torch, lambda: fa.flash_attention_reference(q, k, v, sep))
                us_l, us_c = _sdpa_time_us(torch, q, k, v, sep)
                bound_ms, by = _flash_bound(B, N, D, S, sep, q.element_size(),
                                            "bf16" if dtype == torch.bfloat16 else "f32")
                times[name] = (us_k, us_p, us_l, us_c, bound_ms, by)
                print(f"flash kernel time {name} S=1058: kernel {us_k:.1f} us/call, plain "
                      f"{us_p:.1f} us/call, scaled_dot_product_attention with the boolean mask "
                      f"{us_l:.1f} us/call, with is_causal {us_c:.1f} us/call (CUDA events, median "
                      f"of 25); bound {1000.0 * bound_ms:.2f} us ({by}), share "
                      f"{bound_ms * 1000.0 / us_k:.3f}")
        del qkv32, qkv, q, k, v

    # the tutorial's training shape, where 744 of the 792 launches run: bf16,
    # sep 0, with dropout 0.1 (as the train step) and without
    B, N, D, S = 16, 16, 64, 1088
    qkv = torch.randn((B, S, 3, N * D), generator=gen, device=dev).to(torch.bfloat16)
    q, k, v = (qkv[:, :, i].reshape(B, S, N, D) for i in range(3))
    us_drop = _device_time_us(torch, lambda: fa.flash_attention(q, k, v, 0, dropout_rate=0.1,
                                                                dropout_seed=1234))
    us_nodrop = _device_time_us(torch, lambda: fa.flash_attention(q, k, v, 0))
    us_l, us_c = _sdpa_time_us(torch, q, k, v, 0)
    bound_ms, by = _flash_bound(B, N, D, S, 0, 2, "bf16")
    times["train"] = (us_drop, us_nodrop, us_l, us_c, bound_ms, by)
    print(f"flash kernel time bf16 B=16 N=16 S=1088 (training): kernel {us_drop:.1f} us/call "
          f"with dropout 0.1, {us_nodrop:.1f} without; scaled_dot_product_attention with the "
          f"boolean mask {us_l:.1f} us/call, with is_causal {us_c:.1f} us/call (CUDA events, "
          f"median of 25); bound {1000.0 * bound_ms:.2f} us ({by}), share "
          f"{bound_ms * 1000.0 / us_nodrop:.3f} without dropout")
    del qkv, q, k, v
    return {"max_abs_err": worst, "times": times}


def _sdpa_args(torch, q, k, v, sep):
    """[B, S, N, D] views -> SDPA's [B, N, S, D] views and the boolean
    causal-with-prefix mask (True = visible)."""
    S = q.shape[1]
    i = torch.arange(S, device=q.device)
    mask = (i[None, :] <= i[:, None]) | (i[None, :] < sep)
    return q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), mask


def _sdpa_time_us(torch, q, k, v, sep):
    """One F.scaled_dot_product_attention call on the same inputs, the
    yardstick of the flash forward, with the boolean mask and with
    is_causal (the same function at sep 0) -> (us, us); the port never
    calls it."""
    import torch.nn.functional as F

    qt, kt, vt, mask = _sdpa_args(torch, q, k, v, sep)
    return (_device_time_us(torch, lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                                          attn_mask=mask)),
            _device_time_us(torch, lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                                          is_causal=True)))


def _backward_inputs(torch, fa, dtype, b, s, n, sep, rate, gen, d=64):
    """Strided q/k/v views of a fused QKV tensor, dO, and the forward
    kernel's lse with delta = rowsum(dO * O) -> (args, dropout kwargs)."""
    qkv = torch.randn((b, s, 3, n * d), generator=gen, device="cuda").to(dtype)
    q, k, v = (qkv[:, :, i].reshape(b, s, n, d) for i in range(3))
    do = torch.randn((b, s, n, d), generator=gen, device="cuda").to(dtype)
    kw = dict(dropout_rate=rate, dropout_seed=2024 if rate else None)
    with torch.no_grad():
        o, lse = fa.flash_attention(q, k, v, sep, **kw)
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    return (q, k, v, do, lse, delta), kw


def _bwd_bounds(B, N, D, S):
    """Least times of dq and of dk/dv in bf16 at sep 0: q, k, v, dO (and o)
    read and the outputs written once, lse and delta read; 6 D (dq) and 8 D
    (dk, dv) operations per visible pair -> {"dq": (ms, by), "dkv": ...}."""
    pairs = _attn_pairs(S, 0) * B * N
    io = B * S * N * D * 2  # one bf16 [B, S, N, D] tensor
    return {"dq": _bound(5 * io + 2 * B * N * S * 4, 6 * D * pairs, "bf16"),
            "dkv": _bound(6 * io + 2 * B * N * S * 4, 8 * D * pairs, "bf16")}


def _sdpa_backward_us(torch, args):
    """One torch.autograd.grad through SDPA on the q, k, v and dO of
    ``args`` (sep 0, no dropout), with the boolean mask and with is_causal
    -> {"boolean mask": us, "is_causal": us}; the yardstick of dq + dk/dv,
    which the port never calls."""
    import torch.nn.functional as F

    qt, kt, vt, mask = _sdpa_args(torch, *args[:3], 0)
    qt, kt, vt = (t.detach().contiguous().requires_grad_() for t in (qt, kt, vt))
    dot = args[3].transpose(1, 2)
    library = {}
    for name, sdpa_kw in (("boolean mask", dict(attn_mask=mask)),
                          ("is_causal", dict(is_causal=True))):
        o = F.scaled_dot_product_attention(qt, kt, vt, **sdpa_kw)
        library[name] = _device_time_us(torch, lambda: torch.autograd.grad(
            o, (qt, kt, vt), dot, retain_graph=True))
        del o
    return library


def phase_flash_backward(torch, fa):
    """K4 (dq) and K5 (dk, dv) against their plain versions -> summary.

    Tolerances, relative to the largest |gradient|: float32 1e-4 (the
    kernels sum 64-wide tiles with FMA, the plain versions whole rows);
    bfloat16 2e-2 (ds and the dropped probabilities are rounded to
    bfloat16 before their products, at points where the kernels and the
    plain versions see slightly different float32 values, and the outputs
    are bfloat16)."""
    gen = torch.Generator(device="cuda").manual_seed(4)
    worst, rel_worst = 0.0, 0.0
    # (B, N, D, S, sep, rate): the tutorial's training shape, with a prefix
    # on a tile edge and dropout, and cogview-base's post-selection length;
    # then two small cases at each other head width
    cases = [(16, 16, 64, 1088, 0, 0.0), (16, 16, 64, 1088, 64, 0.1), (4, 40, 64, 1058, 0, 0.0)]
    cases += [(2, 4, d, s, sep, rate) for d in (16, 32, 128)
              for s, sep, rate in ((130, 5, 0.0), (333, 64, 0.1))]
    for b, n, d, s, sep, rate in cases:
        for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
            args, kw = _backward_inputs(torch, fa, dtype, b, s, n, sep, rate, gen, d)
            dq = fa.flash_bwd_dq(*args, sep, **kw)
            dk, dv = fa.flash_bwd_dkv(*args, sep, **kw)
            dq2 = fa.flash_bwd_dq(*args, sep, **kw)
            dk2, dv2 = fa.flash_bwd_dkv(*args, sep, **kw)
            torch.cuda.synchronize()
            same = torch.equal(dq, dq2) and torch.equal(dk, dk2) and torch.equal(dv, dv2)
            want_dq = fa.flash_bwd_dq_reference(*args, sep, kw["dropout_rate"],
                                                kw["dropout_seed"])
            want_dk, want_dv = fa.flash_bwd_dkv_reference(*args, sep, kw["dropout_rate"],
                                                          kw["dropout_seed"])
            errs = []
            for name, got, want in (("dq", dq, want_dq), ("dk", dk, want_dk),
                                    ("dv", dv, want_dv)):
                _check(got.dtype == dtype and got.shape == (b, s, n, d),
                       f"{name} dtype or shape")
                err = (got.float() - want.float()).abs().max().item()
                scale = want.float().abs().max().item()
                errs.append(f"{name} {err:.3e} ({err / scale:.2e} of max {scale:.3e})")
                _check(err <= tol * scale, f"flash {name} kernel differs at B={b} N={n} D={d} "
                       f"S={s} sep={sep} {dtype}: {err} > {tol} x {scale}")
                worst, rel_worst = max(worst, err), max(rel_worst, err / scale)
            print(f"flash backward {str(dtype)[6:]} B={b} N={n} D={d} S={s} sep={sep} "
                  f"dropout={rate}: max_abs_err {', '.join(errs)} (tol {tol:g} x max); repeat "
                  f"bit-equal={same}")
            _check(same, "two launches of the backward kernels differ")
            del args, dq, dk, dv, dq2, dk2, dv2, want_dq, want_dk, want_dv

    # time at the tutorial's training shape: bf16, dropout 0.1
    args, kw = _backward_inputs(torch, fa, torch.bfloat16, 16, 1088, 16, 0, 0.1, gen)
    rate, seed = kw["dropout_rate"], kw["dropout_seed"]
    times = {
        "dq": (_device_time_us(torch, lambda: fa.flash_bwd_dq(*args, 0, **kw)),
               _device_time_us(torch, lambda: fa.flash_bwd_dq_reference(*args, 0, rate, seed))),
        "dkv": (_device_time_us(torch, lambda: fa.flash_bwd_dkv(*args, 0, **kw)),
                _device_time_us(torch, lambda: fa.flash_bwd_dkv_reference(*args, 0, rate,
                                                                           seed))),
    }
    bounds = _bwd_bounds(16, 16, 64, 1088)
    for name, (us_k, us_p) in times.items():
        print(f"flash backward {name} time bf16 B=16 N=16 S=1088 dropout 0.1: kernel "
              f"{us_k:.1f} us/call, plain {us_p:.1f} us/call (CUDA events, median of 25); "
              f"bound {1000.0 * bounds[name][0]:.2f} us ({bounds[name][1]})")
    del args

    # the yardsticks: one torch.autograd.grad through SDPA on the same inputs
    # without dropout, with the boolean mask and with is_causal (the same
    # function at sep 0), against dq + dk/dv without dropout
    args, kw = _backward_inputs(torch, fa, torch.bfloat16, 16, 1088, 16, 0, 0.0, gen)
    nodrop = [_device_time_us(torch, lambda: fa.flash_bwd_dq(*args, 0)),
              _device_time_us(torch, lambda: fa.flash_bwd_dkv(*args, 0))]
    library = _sdpa_backward_us(torch, args)
    shares = [bounds[k][0] * 1000.0 / us for k, us in zip(("dq", "dkv"), nodrop)]
    print(f"flash backward without dropout, bf16 B=16 N=16 S=1088: dq {nodrop[0]:.1f} + dk/dv "
          f"{nodrop[1]:.1f} = {sum(nodrop):.1f} us/call (bound shares {shares[0]:.3f}, "
          f"{shares[1]:.3f}); torch.autograd.grad through scaled_dot_product_attention with the "
          f"boolean mask {library['boolean mask']:.1f} us/call, with is_causal "
          f"{library['is_causal']:.1f} us/call (CUDA events, median of 25); kernels / boolean-mask "
          f"call = {sum(nodrop) / library['boolean mask']:.3f}")
    del args
    return {"max_abs_err": worst, "rel_err": rel_worst, "times": times, "bounds": bounds,
            "library_us": library["boolean mask"], "library_causal_us": library["is_causal"],
            "nodrop_us": nodrop}


def _cuobjdump(so, flag):
    from cogview_tpu_torch.ops import _kernels

    cuobjdump = os.path.join(os.path.dirname(_kernels._nvcc()), "cuobjdump")
    return subprocess.run([cuobjdump, flag, str(so)], capture_output=True, text=True,
                          check=True).stdout


FLASH_TC_KERNELS = {"fwd": "flash_fwd_wgmma_kernel", "dq": "flash_bwd_dq_wgmma_kernel",
                    "dkv": "flash_bwd_dkv_wgmma_kernel"}


def _check_tensor_core_kernels(so) -> None:
    """The bf16 flash kernels (K3 forward, K4, K5) run their products on the
    tensor cores and copy asynchronously: each of the 8 instantiations of
    each (D in HEAD_DIMS, with and without dropout) holds HGMMA and UTMALDG
    or LDGSTS in its SASS; and at D = 64 none spills (no stack, no local
    memory in cuobjdump's resource usage).  Prints every one's registers."""
    found = {}
    for section in _cuobjdump(so, "-sass").split("Function : ")[1:]:
        name = section.split(None, 1)[0]
        if "wgmma_kernel" in name:
            found[name] = (section.count("HGMMA"),
                           section.count("UTMALDG") + section.count("LDGSTS"))
    usage = {}
    for fn, line in re.findall(r"Function (\S+?):\s*\n\s*(REG:.*)", _cuobjdump(so, "-res-usage")):
        if "wgmma_kernel" in fn:
            usage[fn] = {k: int(v) for k, v in re.findall(r"(REG|STACK|LOCAL):(\d+)", line)}
    for kind, kernel in FLASH_TC_KERNELS.items():
        mine = {fn: hc for fn, hc in found.items() if kernel in fn}
        regs = {(int(d), drop == "1"): u["REG"] for fn, u in usage.items() if kernel in fn
                for d, drop in re.findall(r"ILi(\d+)ELb([01])E", fn)}
        print(f"flash {kind} SASS (cuobjdump): {len(mine)} bf16 instantiations, HGMMA "
              f"{sorted({h for h, _ in mine.values()})}, UTMALDG + LDGSTS "
              f"{sorted({c for _, c in mine.values()})}; registers (D, dropout) "
              f"{dict(sorted(regs.items()))}")
        _check(len(mine) == 8 and all(h > 0 and c > 0 for h, c in mine.values()),
               f"a bf16 {kind} kernel lacks tensor-core products or asynchronous copies")
    d64 = {fn: u for fn, u in usage.items() if "Li64E" in fn}
    print(f"flash SASS at D = 64: {len(d64)} bf16 instantiations, stack and local bytes "
          f"{sorted({u['STACK'] + u['LOCAL'] for u in d64.values()})}")
    _check(len(found) == 24, f"{len(found)} bf16 flash instantiations, expected 24")
    _check(len(d64) == 6 and all(u["STACK"] == 0 and u["LOCAL"] == 0 for u in d64.values()),
           "a bf16 flash kernel at D = 64 spills")


def _check_decode_kernels(so, head_dims) -> None:
    """K1 and K2 stream their windows with cp.async: each of the 20
    instantiations (int8 with bf16 or float32 q, int4 with either, D in
    HEAD_DIMS) holds LDGSTS in its SASS, and at D = 64 none spills (no stack,
    no local memory).  Prints every one's registers."""
    pat = r"decode_attention_kernelI(f|13__nv_bfloat16)Lb[01]ELb([01])ELi(\d+)E"
    copies = {}
    for section in _cuobjdump(so, "-sass").split("Function : ")[1:]:
        m = re.search(pat, section.split(None, 1)[0])
        if m:
            copies[m.groups()] = section.count("LDGSTS")
    usage = {}
    for fn, line in re.findall(r"Function (\S+?):\s*\n\s*(REG:.*)", _cuobjdump(so, "-res-usage")):
        m = re.search(pat, fn)
        if m:
            usage[m.groups()] = {k: int(v) for k, v in re.findall(r"(REG|STACK|LOCAL):(\d+)", line)}

    def key(t, packed, d):
        return f"{'int4' if packed == '1' else 'int8'} {'f32' if t == 'f' else 'bf16'} D={d}"

    regs = {key(*k): u["REG"] for k, u in sorted(usage.items(), key=lambda kv: int(kv[0][2]))}
    print(f"decode SASS (cuobjdump): {len(copies)} instantiations, LDGSTS "
          f"{sorted(set(copies.values()))}; registers {regs}")
    d64 = [u for (_, _, d), u in usage.items() if d == "64"]
    print(f"decode SASS at D = 64: {len(d64)} instantiations, stack and local bytes "
          f"{sorted({u['STACK'] + u['LOCAL'] for u in d64})}")
    _check(len(copies) == 4 * len(head_dims) and all(copies.values())
           and {int(d) for _, _, d in copies} == set(head_dims),
           f"a decode kernel lacks cp.async or an instantiation is missing: {copies}")
    _check(len(d64) == 4 and all(u["STACK"] == 0 and u["LOCAL"] == 0 for u in d64),
           "a decode kernel at D = 64 spills")


def phase_probes(torch, probes, ssp):
    """P1a on a random block and P2 on the TPU probe's inputs, then at every
    lane0 in [0, 120] on random qc with the matching one-hot and with a
    one-hot permuted within the group, single calls, against their plain
    versions bit for bit -> the largest difference of each.  P1b's checks,
    and the chains eager and in a CUDA graph, are the entry points' own
    (``phase_probe_entry_points``)."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(8)

    def diff(a, b):
        return (a.float() - b.float()).abs().max().item()

    x = torch.randn((8, 128), generator=gen, device=dev)
    err = {"add_one": diff(probes.add_one(x), probes.add_one_reference(x)), "seal_scatter": 0.0}
    print(f"probe P1a add_one [8,128]: max_abs_err {err['add_one']:.1e} (tol 0)")
    _check(err["add_one"] == 0, "P1a differs from its plain version")

    qc, oh, l0 = ssp.probe_inputs(dev)
    cases = [(qc, oh, l0)]
    rng = torch.Generator().manual_seed(10)
    for lane0 in range(ssp.W - ssp.G + 1):
        l0_c = torch.full((1, 1), lane0, dtype=torch.int32, device=dev)
        qc_c = torch.randint(-127, 127, qc.shape, generator=rng).float().to(dev)
        perm = torch.randperm(ssp.G, generator=rng).to(dev)
        cases += [(qc_c, ssp.one_hot(lane0, dev), l0_c),
                  (qc_c, ssp.one_hot(lane0, dev)[perm], l0_c)]
    for qc_c, oh_c, l0_c in cases:
        got = probes.seal_scatter(qc_c, oh_c, l0_c)
        want = probes.seal_scatter_reference(qc_c, oh_c, l0_c)
        _check(torch.equal(got, want), f"P2 bytes differ at lane0 {l0_c.item()}")
        err["seal_scatter"] = max(err["seal_scatter"], diff(got, want))
    print(f"probe P2 seal_scatter [40,64,128]: byte-equal in {len(cases)} cases, lane0 "
          f"{ssp.LANE0} (the probe's inputs) and every lane0 in [0, {ssp.W - ssp.G}], each "
          f"with the one-hot and with it permuted within the group")
    return err


def _check_async_copy(so) -> None:
    """P1b's copy must not be optimised away: its kernel in the built
    library holds LDGSTS (cp.async) in its SASS."""
    found = {}
    for section in _cuobjdump(so, "-sass").split("Function : ")[1:]:
        name = section.split(None, 1)[0]
        if "decode_convention_kernel" in name:
            found[name] = section.count("LDGSTS")
    print(f"probe P1b SASS (cuobjdump): LDGSTS in the kernel {list(found.values())}")
    _check(len(found) == 1 and all(found.values()), "P1b's asynchronous copy is missing")


def _check_seal_stores(so) -> None:
    """P2 writes its output 16 bytes at a time: every global store in its
    kernel's SASS is STG.E.128."""
    stores = []
    for section in _cuobjdump(so, "-sass").split("Function : ")[1:]:
        if "seal_scatter_kernel" in section.split(None, 1)[0]:
            stores += re.findall(r"\bSTG\S*", section)
    print(f"probe P2 SASS (cuobjdump): global stores {sorted(set(stores))} x {len(stores)}")
    _check(stores and all(st.startswith("STG.E.128") for st in stores),
           "P2's kernel does not store 128 bits at a time")


# the window sweeps: (key, decode_kernel_microbench arguments); batch 40
# unless named, and the main path's batch 4 (the split plan's 4 splits)
SWEEPS = (("sweep_int8", ["--kv", "int8"]), ("sweep_int4", ["--kv", "int4"]),
          ("sweep_int8_no_ring_write", ["--kv", "int8", "--ring-write", "0"]),
          ("sweep_int8_b4", ["--kv", "int8", "--batch", "4"]))


def phase_probe_entry_points(torch, da, probes, lp, ssp, dkm):
    """The three measurement entry points at their default shapes, each
    12 GB cache freed before the next is made -> (their results, the
    wrappers' launch counts of each run: eager calls and graph captures;
    the entry points count what the replays ran)."""
    counters = (probes.add_one, probes.decode_convention, probes.seal_scatter)
    for c in counters:
        c.launches = 0
    res = {"launch_probe": lp.main([])}
    torch.cuda.empty_cache()
    res["seal_scatter_probe"] = ssp.main([])
    launches = {c.__name__: c.launches for c in counters}
    decode = da.decode_attention_quant
    for key, argv in SWEEPS:
        decode.launches = decode.launches_int4 = 0
        res[key] = dkm.main(argv)
        launches[key] = decode.launches + decode.launches_int4
        torch.cuda.empty_cache()
    replayed = {key: res[key]["graph_replayed"] for key, _ in SWEEPS}
    replayed["add_one"] = res["launch_probe"]["tiny"]["graph_replayed"]
    replayed["decode_convention"] = res["launch_probe"]["convention"]["graph_replayed"]
    replayed["seal_scatter"] = res["seal_scatter_probe"]["graph_replayed"]
    print(f"probe entry points: wrapper launches {launches} (eager calls and graph captures); "
          f"launches run by graph replays {replayed}")
    _check(all(n > 0 for n in launches.values()), "an entry point launched no kernel")
    for key, _ in SWEEPS:
        s = res[key]
        _check(len(s["points"]) == 5 and all(
            math.isfinite(s[col][k]) for col in ("eager", "graph")
            for k in ("slope_us", "intercept_us")), f"the {key} sweep gave no line")
    return res, launches


def phase_small_training(torch, cfgmod, fa, tl, optim):
    """Two tiny float32 train steps through the flash kernels (one head of
    64, dropout 0.1) on the card, against the same steps on the CPU (plain
    versions): losses to 1e-4 relative, params after the steps to 1e-4."""
    from cogview_tpu_torch.models import gpt

    cfg = cfgmod.tiny_test(num_heads=1, use_flash_attention=True, embedding_dropout=0.1,
                           attention_dropout=0.1, output_dropout=0.1)
    rng = torch.Generator().manual_seed(5)
    batches = [{"text": torch.randint(0, 128, (2, 64), generator=rng),
                "loss_mask": torch.ones(2, 64)} for _ in range(2)]
    seeds = [torch.randint(0, 2 ** 32, (3,), generator=rng).tolist() for _ in range(2)]
    runs = {}
    for dev in ("cpu", "cuda"):
        params = optim.tree_map(lambda t: t.to(dev),
                                gpt.init_params(cfg, torch.Generator().manual_seed(6)))
        opt, _ = optim.make_optimizer(params, lr=1e-3, warmup_iter=1, num_iters=10)
        state = tl.init_train_state(params, opt, torch.Generator().manual_seed(0))
        step = tl.make_train_step(cfg, opt, img_vocab=64)
        launches = (fa.flash_attention.launches, fa.flash_bwd_dq.launches,
                    fa.flash_bwd_dkv.launches)
        losses = [step(state, batch, seeds=s)[1]["lm_loss"] for batch, s in zip(batches, seeds)]
        launched = tuple(b - a for a, b in zip(launches, (
            fa.flash_attention.launches, fa.flash_bwd_dq.launches, fa.flash_bwd_dkv.launches)))
        runs[dev] = (losses, [p.detach().cpu() for p in optim.tree_leaves(state["params"])],
                     launched)
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(runs["cuda"][0], runs["cpu"][0]))
    param_err = max((a - b).abs().max().item() for a, b in zip(runs["cuda"][1], runs["cpu"][1]))
    print(f"small input training (tiny_test f32, 1 head of 64, S=63, dropout 0.1, 2 steps): "
          f"losses card {runs['cuda'][0]} CPU {runs['cpu'][0]}, max rel diff {loss_err:.2e} "
          f"(tol 1e-4); params max_abs_err {param_err:.2e} (tol 1e-4); kernel launches on the "
          f"card (fwd, dq, dkv) {runs['cuda'][2]}, on the CPU {runs['cpu'][2]}")
    _check(loss_err <= 1e-4 and param_err <= 1e-4, "card train steps differ from the CPU's")
    # remat: per step and layer, the forward twice and each backward once
    _check(runs["cuda"][2] == (8, 4, 4) and runs["cpu"][2] == (0, 0, 0),
           "the card's train steps did not launch the flash kernels once per layer")


def phase_small_input(torch, gpt, cfgmod, da, fa):
    """Tiny float32 models on the card (kernels) against the CPU (plain
    versions) with the same weights: prefill + 28 decode steps through the
    int8, int4 and bfloat16 caches, and a full forward through the flash
    kernel."""
    gen = torch.Generator().manual_seed(1)
    params_cpu = gpt.init_params(cfgmod.tiny_test(), gen)

    def to_dev(t):
        return {k: to_dev(v) for k, v in t.items()} if isinstance(t, dict) else t.cuda()

    params_gpu = to_dev(params_cpu)
    B, S, ctx = 2, 40, 12
    tokens = torch.randint(0, 128, (B, S), generator=gen)
    pos = torch.arange(S).expand(B, S)
    for kv in ("int8", "int4", "bfloat16"):
        cfg = cfgmod.tiny_test(kv_cache_dtype=kv)
        outs, launched = {}, {}
        for name, params, dev in (("cpu", params_cpu, "cpu"), ("cuda", params_gpu, "cuda")):
            n1, n2 = da.decode_attention_quant.launches, da.decode_attention_quant.launches_int4
            cache = gpt.init_cache(cfg, B, S, device=dev)
            tk, ps = tokens.to(dev), pos.to(dev)
            got = [gpt.forward_with_cache(params, cfg, tk[:, :ctx], ps[:, :ctx], cache, 0)]
            for t in range(ctx, S):
                got.append(gpt.forward_with_cache(params, cfg, tk[:, t:t + 1], ps[:, t:t + 1],
                                                  cache, t))
            outs[name] = torch.cat(got, dim=1).cpu()
            launched[name] = (da.decode_attention_quant.launches - n1,
                              da.decode_attention_quant.launches_int4 - n2)
        err = (outs["cpu"] - outs["cuda"]).abs().max().item()
        want = {"int8": ((S - ctx) * 2, 0), "int4": (0, (S - ctx) * 2), "bfloat16": (0, 0)}[kv]
        print(f"small input (tiny_test f32, {kv} cache, prefill 12 + 28 decode steps): logits "
              f"max_abs_err card vs CPU = {err:.3e} (tol 1e-3); (K1, K2) launches on the card "
              f"{launched['cuda']}, on the CPU {launched['cpu']}")
        _check(err <= 1e-3, f"card logits differ from the CPU's by {err} ({kv} cache)")
        _check(launched["cuda"] == want and launched["cpu"] == (0, 0),
               f"the {kv} cache did not launch its decode kernel once per step and layer")

    # one head of 64 dims, the flash kernel's width; S=40 is one ragged tile
    cfg = cfgmod.tiny_test(num_heads=1, use_flash_attention=True)
    params_cpu = gpt.init_params(cfg, torch.Generator().manual_seed(3))
    params_gpu = to_dev(params_cpu)
    want = gpt.forward(params_cpu, cfg, tokens, sep=7)
    launches = fa.flash_attention.launches
    got = gpt.forward(params_gpu, cfg, tokens.cuda(), sep=7).cpu()
    launches = fa.flash_attention.launches - launches
    err = (got - want).abs().max().item()
    print(f"small input (tiny_test f32, 1 head of 64, S=40, sep 7, flash forward): logits "
          f"max_abs_err card vs CPU = {err:.3e} (tol 1e-4); flash launches {launches}")
    _check(err <= 1e-4 and launches == cfg.num_layers, "flash forward differs from the CPU's")


def _run_cli(cli, tasks, sampling, torch, argv, captured):
    """cli.main(argv) with generate_once / filling_sequence timed and their
    results kept in ``captured``."""
    orig_gen, orig_fill = cli.generate_once, tasks.filling_sequence

    def timed_generate_once(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = orig_gen(*a, **kw)
        torch.cuda.synchronize()
        captured["request_s"] = time.perf_counter() - t0
        captured["res"] = res
        return res

    def timed_fill(params, cfg, template, *a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = orig_fill(params, cfg, template, *a, **kw)
        torch.cuda.synchronize()
        captured["fill_s"] = time.perf_counter() - t0
        captured["ctx"] = template.context_length
        captured["steps"] = sampling.decode_end(template) - template.context_length
        return out

    cli.generate_once, tasks.filling_sequence = timed_generate_once, timed_fill
    try:
        rc = cli.main(argv, txt_tokenizer=WordTokenizer())
    finally:
        cli.generate_once, tasks.filling_sequence = orig_gen, orig_fill
    _check(rc == 0, f"cli.main returned {rc}")


def _cli_argv(weights: str, task: str, query: str, out_dir: str):
    return ["--preset", "cogview-base", "--dtype", "bfloat16", "--weights", weights,
            "--kv-cache", "int8", "--batch-size", "4", "--top_k", "200", "--seed", "1234",
            "--device", "cuda", "--generation-task", task, "--input-source", query,
            "--output-path", out_dir]


PROFILED_STEPS = (512, 8)  # (first decode step, steps) under torch.profiler


def _profiling_decode_steps(torch, gpt, rec):
    """A stand-in for ``gpt.forward_with_cache`` that runs decode steps
    PROFILED_STEPS under torch.profiler and keeps the profile and its wall
    time in ``rec``, with the host clock at the first decode step, at the
    profiled window's ends and after the last step (the steps before and
    after the window show what the profiler costs the steps it does not
    trace).  The step before the window is the profiler's warmup step
    (``torch.profiler.schedule``): tracing starts there and is discarded, so
    the window's first launches are not lost to the tracer's start (a run
    without it once saw 383 of the window's 384 K1 launches)."""
    orig = gpt.forward_with_cache
    first, count = PROFILED_STEPS

    def forward_with_cache(params, cfg, tokens, *a, **kw):
        if tokens.shape[1] != 1:  # the prefill
            return orig(params, cfg, tokens, *a, **kw)
        step = rec.setdefault("steps", 0)
        rec["steps"] = step + 1
        if step in (0, first, first + count):
            rec[f"host_{step}"] = time.perf_counter()
        if step == first - 1:
            torch.cuda.synchronize()
            rec["prof"] = torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU,
                            torch.profiler.ProfilerActivity.CUDA],
                schedule=torch.profiler.schedule(wait=0, warmup=1, active=count, repeat=1))
            rec["prof"].__enter__()
        if first <= step < first + count:
            if step == first:
                torch.cuda.synchronize()
            rec["prof"].step()
            if step == first:
                rec["t0"] = time.perf_counter()
        out = orig(params, cfg, tokens, *a, **kw)
        if step == first + count - 1:
            torch.cuda.synchronize()
            rec["wall"] = time.perf_counter() - rec["t0"]
            rec["prof"].step()
            rec["prof"].__exit__(None, None, None)
        rec["host_end"] = time.perf_counter()
        return out

    return forward_with_cache


def _decode_step_profile(torch, rec) -> dict:
    """K1's device ms and launches per decode step, all kernels' device ms
    per step and the busy share, from a profile of PROFILED_STEPS."""
    count = PROFILED_STEPS[1]
    k1_us = k1_n = total_us = 0.0
    for e in rec["prof"].key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        # the schedule's ProfilerStep annotations span each step on the
        # device timeline: they are ranges, not kernels
        if (us <= 0 or e.device_type != torch.autograd.DeviceType.CUDA
                or e.key.startswith("ProfilerStep")):
            continue
        total_us += us
        if "decode_attention_kernel" in e.key:
            k1_us, k1_n = k1_us + us, k1_n + e.count
    first = PROFILED_STEPS[0]
    after = rec["steps"] - first - count
    return {"k1_ms": k1_us / 1000.0 / count, "k1_launches": k1_n / count,
            "kernels_ms": total_us / 1000.0 / count, "wall_ms": 1000.0 * rec["wall"] / count,
            "busy": total_us / 1e6 / rec["wall"],
            "host_ms_before": 1000.0 * (rec[f"host_{first}"] - rec["host_0"]) / first,
            "host_ms_after": 1000.0 * (rec["host_end"] - rec[f"host_{first + count}"]) / after}


def phase_main_path(torch, da, gpt, cli, tasks, sampling, png, weights: str, work: str):
    """One text2image request through the CLI -> (kernel launches, PNG dir,
    the decode-step profile of the bf16-weight request or None)."""
    import numpy as np

    query = os.path.join(work, "query.txt")
    with open(query, "w") as f:
        f.write(PROMPT + "\n")
    out_dir = os.path.join(work, f"t2i_{weights}")
    captured, rec = {}, {}
    da.decode_attention_quant.launches = 0
    da.decode_attention_quant_reference.calls = 0
    da.decode_attention_quant.launches_int4 = 0
    orig_fwc = gpt.forward_with_cache
    if weights == "bfloat16":
        gpt.forward_with_cache = _profiling_decode_steps(torch, gpt, rec)
    try:
        _run_cli(cli, tasks, sampling, torch, _cli_argv(weights, "text2image", query, out_dir),
                 captured)
    finally:
        gpt.forward_with_cache = orig_fwc
    launches = da.decode_attention_quant.launches
    plain_calls = da.decode_attention_quant_reference.calls
    _check(da.decode_attention_quant.launches_int4 == 0, "the int8 cache launched K2")

    res = captured["res"]
    ctx, steps = captured["ctx"], captured["steps"]
    gen_ids = res.tokens[:, ctx:ctx + 1024]
    ok_ids = bool(((gen_ids >= 0) & (gen_ids < 8192)).all()) and gen_ids.shape == (4, 1024)
    print(f"main path weights={weights}: {gen_ids.size} generated ids, all in [0, 8192): {ok_ids}")
    _check(ok_ids, "generated ids outside the image vocabulary")
    shapes = []
    for i in range(4):
        img = png.read_png(os.path.join(out_dir, f"{i}.png"))
        shapes.append(img.shape)
    finite = all(a.shape == (1, 256, 256, 3) and bool(np.isfinite(a).all())
                 for a in res.images)
    print(f"main path weights={weights}: {len(res.images)} finite 256x256x3 images, "
          f"PNG shapes {shapes}")
    _check(len(res.images) == 4 and finite and all(s == (256, 256, 3) for s in shapes),
           "images missing, non-finite or of the wrong shape")
    want = steps * 48
    print(f"main path weights={weights}: kernel launches {launches} == decode steps x 48 = "
          f"{steps} x 48 = {want}: {launches == want}; plain-version calls {plain_calls}")
    _check(steps == 1024 and launches == want and plain_calls == 0,
           "the main path did not run the kernel once per step and layer")
    print(f"main path weights={weights}: {captured['request_s']:.3f} s per request "
          f"(batch 4); filling {captured['fill_s']:.3f} s = "
          f"{1000.0 * captured['fill_s'] / steps:.3f} ms per decode step "
          f"(prefill included, {steps} steps)")
    profile = None
    if rec:
        profile = _decode_step_profile(torch, rec)
        first, count = PROFILED_STEPS
        print(f"main path weights={weights}: decode steps {first}-{first + count - 1} under "
              f"torch.profiler: K1 {profile['k1_ms']:.4f} ms of device time per step in "
              f"{profile['k1_launches']:g} launches; all kernels {profile['kernels_ms']:.3f} ms "
              f"per step, wall {profile['wall_ms']:.3f} ms per step, device busy "
              f"{100.0 * profile['busy']:.1f}%; host clock {profile['host_ms_before']:.3f} ms "
              f"per step before the window, {profile['host_ms_after']:.3f} after")
        _check(profile["k1_launches"] == 48, "the profiled decode steps did not launch K1 48 "
               "times each")
    return launches, out_dir, profile


def phase_image2text(torch, da, fa, cli, tasks, sampling, png_dir: str, work: str):
    """image->text on the first PNG through the CLI -> decode-kernel launches."""
    query = os.path.join(work, "i2t.txt")
    with open(query, "w") as f:
        f.write(os.path.join(png_dir, "0.png") + "\n")
    captured = {}
    da.decode_attention_quant.launches = 0
    da.decode_attention_quant_reference.calls = 0
    fa.flash_attention.launches = 0
    _run_cli(cli, tasks, sampling, torch,
             _cli_argv("bfloat16", "image2text", query, os.path.join(work, "i2t")), captured)
    launches = da.decode_attention_quant.launches
    plain_calls = da.decode_attention_quant_reference.calls
    res, ctx, steps = captured["res"], captured["ctx"], captured["steps"]
    ids = res.tokens[:, ctx:ctx + 20]
    ok = ids.shape == (4, 20) and bool(((ids >= 8192) & (ids < 8192 + 50000)).all())
    print(f"image2text: ids {ids.shape}, all in the text range [8192, 58192): {ok}; "
          f"first row {ids[0].tolist()}")
    _check(ctx == 1028 and ok, "image2text ids outside the text range")
    print(f"image2text: decode kernel launches {launches} == 20 x 48 = 960: {launches == 960}; "
          f"plain-version calls {plain_calls}; flash launches {fa.flash_attention.launches}")
    _check(steps == 20 and launches == 960 and plain_calls == 0,
           "image2text did not run the decode kernel once per step and layer")
    print(f"image2text: {captured['request_s']:.3f} s per request (batch 4, encode + prefill "
          f"1028 + 20 decode steps); filling {captured['fill_s']:.3f} s")
    return launches


def phase_low_level_sr(torch, da, cli, tasks, sampling, png, png_dir: str, work: str):
    """Low-level super-resolution through the CLI at cogview-base width and
    depth, int8 cache, batch 4, on the prompt and the first PNG of the
    int8-weight text->image request, read at 128 pixels (the bilinear
    resize, 256 -> 128) -> K1 launches."""
    import numpy as np

    query = os.path.join(work, "llsr.txt")
    with open(query, "w") as f:
        f.write(PROMPT + "\t" + os.path.join(png_dir, "0.png") + "\n")
    out_dir = os.path.join(work, "llsr")
    captured = {}
    da.decode_attention_quant.launches = 0
    da.decode_attention_quant.launches_int4 = 0
    da.decode_attention_quant_reference.calls = 0
    _run_cli(cli, tasks, sampling, torch,
             _cli_argv("bfloat16", "low-level super-resolution", query, out_dir), captured)
    launches = da.decode_attention_quant.launches
    plain_calls = da.decode_attention_quant_reference.calls
    _check(da.decode_attention_quant.launches_int4 == 0, "the int8 cache launched K2")

    res, ctx, steps = captured["res"], captured["ctx"], captured["steps"]
    # [ROI1], 30 words, [BASE] [BOI1], the 16 x 16 codes of a 128-pixel
    # image, [EOI1] [ROI2] [POS0] [BASE] [BOI2]
    ctx_codes = res.tokens[:, 33:33 + 256]
    gen_ids = res.tokens[:, ctx:ctx + 1024]
    ok_ids = (ctx == 33 + 256 + 5 and gen_ids.shape == (4, 1024)
              and bool(((gen_ids >= 0) & (gen_ids < 8192)).all())
              and bool(((ctx_codes >= 0) & (ctx_codes < 8192)).all()))
    shapes = [png.read_png(os.path.join(out_dir, f"{i}.png")).shape for i in range(4)]
    finite = len(res.images) == 4 and all(
        a.shape == (1, 256, 256, 3) and bool(np.isfinite(a).all()) for a in res.images)
    print(f"low-level SR: context {ctx} (256 codes of the 128-pixel image), {gen_ids.size} "
          f"generated ids, all in [0, 8192): {ok_ids}; PNG shapes {shapes}, images finite: "
          f"{finite}")
    _check(ok_ids and finite and shapes == [(256, 256, 3)] * 4, "low-level SR outputs")
    print(f"low-level SR: K1 launches {launches} == decode steps x 48 = {steps} x 48 = "
          f"{steps * 48}: {launches == steps * 48}; plain-version calls {plain_calls}")
    _check(steps == 1024 and launches == steps * 48 and plain_calls == 0,
           "low-level SR did not run K1 once per step and layer")
    print(f"low-level SR: {captured['request_s']:.3f} s per request (batch 4, cogview-base, 48 "
          f"layers); filling {captured['fill_s']:.3f} s = "
          f"{1000.0 * captured['fill_s'] / steps:.3f} ms per decode step (prefill included)")
    return launches


# the super-resolution request's depth, cut from cogview-sr's 48 layers: its
# nine windows are 6,048 decode steps at batch 1
SR_LAYERS = 2


def phase_super_resolution(torch, da, cfgmod, cli, gpt, magnify, sampling, png, png_dir: str,
                           work: str, smi: str):
    """Super-resolution through the CLI with ``--preset cogview-sr`` at its
    published widths (hidden 2560, 40 heads, 1,345 positions, the full
    vocabulary), depth cut to SR_LAYERS, int8 cache, batch 1, on the prompt
    and the first PNG of the int8-weight text->image request: nine magnify
    windows -> K1 launches.  The weights come through ``--load`` of a
    1,089-position bfloat16 DeepSpeed file at cogview-base widths and
    SR_LAYERS depth, so the CLI fits the position table to 1,345 rows."""
    import numpy as np

    base = cfgmod.cogview_base()
    dims = (SR_LAYERS, base.hidden_size, base.vocab_size, base.max_position_embeddings)
    ckpt_dir = tempfile.TemporaryDirectory(dir=work)
    ckpt = os.path.join(ckpt_dir.name, "mp_rank_00_model_states.pt")
    file_bytes = _write_gpt_checkpoint(torch, ckpt, *dims, torch.bfloat16)
    print(f"super-resolution: wrote a {SR_LAYERS}-layer cogview-base DeepSpeed file, bfloat16, "
          f"{base.max_position_embeddings} positions, {file_bytes / 1e9:.3f} GB")
    query = os.path.join(work, "sr.txt")
    with open(query, "w") as f:
        f.write(PROMPT + "\t" + os.path.join(png_dir, "0.png") + "\n")
    out_dir = os.path.join(work, "sr")
    rec = {"steps": 0, "windows": 0}
    orig_sr, orig_fill = cli.super_resolution, magnify.filling_sequence
    orig_preset = cli.PRESETS["cogview-sr"]

    def timed_sr(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = orig_sr(*a, **kw)
        torch.cuda.synchronize()
        rec.update(request_s=time.perf_counter() - t0, res=res)
        return res

    def counted_fill(params, cfg, template, *a, **kw):
        rec["steps"] += sampling.decode_end(template) - template.context_length
        rec["windows"] += 1
        rec.update(cfg=cfg, length=template.length)
        return orig_fill(params, cfg, template, *a, **kw)

    orig_load = cli.load_model

    def checked_load(args, device):
        """The loaded params against the file: every leaf, and the position
        table's rows past the file's 1,089 against the port's
        extend_position_embedding of the file's table."""
        params, cfg = orig_load(args, device)
        pos = params["embed"]["pos"]
        n, bad = _verify_gpt_leaves(torch, params, *dims, torch.bfloat16)
        src_pos = _seeded(torch, 1, (dims[3], dims[1]), "", torch.bfloat16)
        tail = torch.equal(pos, gpt.extend_position_embedding(src_pos, cfg.max_position_embeddings))
        print(f"super-resolution: --load {file_bytes / 1e9:.3f} GB under the cogview-sr preset: "
              f"{n} leaves bit-equal to the file's: {not bad}; position table {tuple(pos.shape)} "
              f"{pos.dtype}, rows {dims[3]}.. equal the tiled table: {tail}")
        _check(not bad and tail and tuple(pos.shape) == (1345, dims[1])
               and pos.dtype == torch.bfloat16, "the super-resolution params differ from the file")
        return params, cfg

    argv = ["--preset", "cogview-sr", "--load", ckpt, "--dtype", "bfloat16", "--weights",
            "bfloat16", "--kv-cache", "int8", "--top_k", "200", "--seed", "1234", "--device",
            "cuda", "--generation-task", "super-resolution", "--input-source", query,
            "--output-path", out_dir]
    da.decode_attention_quant.launches = 0
    da.decode_attention_quant.launches_int4 = 0
    da.decode_attention_quant_reference.calls = 0
    cli.super_resolution, magnify.filling_sequence = timed_sr, counted_fill
    cli.PRESETS["cogview-sr"] = lambda: cfgmod.cogview_sr(num_layers=SR_LAYERS)
    cli.load_model = checked_load
    try:
        rc = cli.main(argv, txt_tokenizer=WordTokenizer())
    finally:
        cli.super_resolution, magnify.filling_sequence = orig_sr, orig_fill
        cli.PRESETS["cogview-sr"] = orig_preset
        cli.load_model = orig_load
        ckpt_dir.cleanup()
    _check(rc == 0, f"cli.main returned {rc}")
    launches = da.decode_attention_quant.launches
    plain_calls = da.decode_attention_quant_reference.calls
    _check(da.decode_attention_quant.launches_int4 == 0, "the int8 cache launched K2")

    cfg, res, steps = rec["cfg"], rec["res"], rec["steps"]
    widths = (cfg.num_layers, cfg.hidden_size, cfg.num_heads, cfg.max_position_embeddings,
              cfg.vocab_size)
    print(f"super-resolution: cogview-sr (layers, hidden, heads, positions, vocabulary) "
          f"{widths}; {rec['windows']} windows of {rec['length']} slots")
    _check(widths == (SR_LAYERS, 2560, 40, 1345, 58240) and rec["windows"] == 9,
           "super-resolution did not run cogview-sr's widths through nine windows")
    codes = res.tokens
    ok_ids = codes.shape == (1, 4096) and bool(((codes >= 0) & (codes < 8192)).all())
    (img,) = res.images
    shape = png.read_png(os.path.join(out_dir, "sr-0.png")).shape
    finite = img.shape == (1, 512, 512, 3) and bool(np.isfinite(img).all())
    print(f"super-resolution: {codes.size} codes, all in [0, 8192): {ok_ids}; image "
          f"{img.shape} finite: {finite}; sr-0.png {shape}")
    _check(ok_ids and finite and shape == (512, 512, 3), "super-resolution outputs")
    print(f"super-resolution: K1 launches {launches} == decode steps x layers = {steps} x "
          f"{SR_LAYERS} = {steps * SR_LAYERS}: {launches == steps * SR_LAYERS}; plain-version "
          f"calls {plain_calls}")
    _check(launches == steps * SR_LAYERS and plain_calls == 0,
           "super-resolution did not run K1 once per step and layer")
    print(f"super-resolution: {rec['request_s']:.3f} s per request (batch 1, {SR_LAYERS} "
          f"layers, {steps} decode steps: {1000.0 * rec['request_s'] / steps:.3f} ms per step, "
          f"the windows' prefills included; {smi})")
    return launches


def phase_post_selection(torch, fa, cli, tasks, scoring, png_dir: str, work: str):
    """Post-selection of the four PNGs through the CLI -> flash launches."""
    import numpy as np

    query = os.path.join(work, "ps.txt")
    with open(query, "w") as f:
        f.write("\t".join([PROMPT] + [os.path.join(png_dir, f"{i}.png") for i in range(4)])
                + "\n")
    out_dir = os.path.join(work, "ps")
    captured = {}
    orig_ps, orig_score = cli.post_selection, tasks.inverse_prompt_score

    def timed_post_selection(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = orig_ps(*a, **kw)
        torch.cuda.synchronize()
        captured["request_s"] = time.perf_counter() - t0
        return res

    def kept_score(params, cfg, tokens, **kw):
        captured.update(params=params, cfg=cfg, tokens=tokens, kw=kw)
        return orig_score(params, cfg, tokens, **kw)

    fa.flash_attention.launches = 0
    fa.flash_attention_reference.calls = 0
    cli.post_selection, tasks.inverse_prompt_score = timed_post_selection, kept_score
    try:
        rc = cli.main(_cli_argv("bfloat16", "post-selection", query, out_dir),
                      txt_tokenizer=WordTokenizer())
    finally:
        cli.post_selection, tasks.inverse_prompt_score = orig_ps, orig_score
    launches = fa.flash_attention.launches
    plain_calls = fa.flash_attention_reference.calls
    _check(rc == 0, f"cli.main returned {rc}")

    with open(os.path.join(out_dir, "scores_rank_0.txt")) as f:
        lines = f.read().splitlines()
    scores = np.array([float(x) for x in lines[1].split("\t")])
    S = captured["tokens"].shape[1]
    distinct = len(torch.unique(captured["tokens"], dim=0))
    ok = scores.shape == (4,) and bool(np.isfinite(scores).all() and (scores < 0).all())
    print(f"post-selection: S={S}, {distinct} distinct token rows (the random VQ-VAE's "
          f"images are near-constant), scores {scores.tolist()}, 4 finite and negative: {ok}")
    _check(ok and lines[0] == open(query).read().strip(), "post-selection scores")
    print(f"post-selection: flash launches {launches} == 48: {launches == 48}; "
          f"plain-version calls {plain_calls}")
    _check(launches == 48 and plain_calls == 0, "post-selection did not run the flash kernel")
    print(f"post-selection: {captured['request_s']:.3f} s per request (4 candidates: encode + "
          f"one batch-4 forward at S={S})")

    # the same tokens through dense attention: the two attention paths
    # round bf16 probabilities and contexts at different points, so the
    # scores agree to a relative 2e-3, a few bf16 roundings of a sum
    params, cfg, tokens = captured["params"], captured["cfg"], captured["tokens"]
    t = {}
    for name, flag in (("flash", True), ("dense", False)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = scoring.inverse_prompt_score(params, cfg.replace(use_flash_attention=flag),
                                           tokens, **captured["kw"]).cpu().numpy()
        torch.cuda.synchronize()
        t[name] = (time.perf_counter() - t0, got)
    diff = float(np.abs(t["dense"][1] - scores).max())
    rerun = float(np.abs(t["flash"][1] - scores).max())
    tol = 2e-3 * float(np.abs(scores).max())
    print(f"post-selection: dense-attention scores {t['dense'][1].tolist()}; max |flash - dense| "
          f"= {diff:.4e} (tol {tol:.4e} = 2e-3 x max |score|), flash rerun differs by "
          f"{rerun:.4e}; scoring forward {t['flash'][0]:.3f} s flash, {t['dense'][0]:.3f} s dense")
    _check(diff <= tol and rerun <= tol, "flash and dense scores disagree")
    return launches


def phase_serve_int4(torch, da, serve, tasks, sampling, png, work: str):
    """One request through the folder-watcher server with the int4 cache ->
    K2 launches."""
    import numpy as np

    inp, img = os.path.join(work, "serve_in"), os.path.join(work, "serve_img")
    os.makedirs(inp)
    with open(os.path.join(inp, "query.txt"), "w") as f:
        f.write(PROMPT + "\n")
    argv = ["--preset", "cogview-base", "--dtype", "bfloat16", "--weights", "bfloat16",
            "--kv-cache", "int4", "--batch-size", "4", "--top_k", "200", "--seed", "1234",
            "--device", "cuda", "--no-warmup", "--max-polls", "1", "--time-interval", "0",
            "--input-folder-path", inp, "--img-folder-path", img]
    captured = {}
    da.decode_attention_quant.launches = 0
    da.decode_attention_quant.launches_int4 = 0
    da.decode_attention_quant_reference.calls = 0
    _run_cli(serve, tasks, sampling, torch, argv, captured)
    k1, k2 = da.decode_attention_quant.launches, da.decode_attention_quant.launches_int4
    plain_calls = da.decode_attention_quant_reference.calls

    failed = os.listdir(os.path.join(inp, "failed"))
    done = os.listdir(os.path.join(inp, "done"))
    print(f"serve int4: done/ {done}, failed/ {failed}")
    _check(done == ["query.txt"] and failed == [], "the query file did not reach done/ alone")
    res, ctx, steps = captured["res"], captured["ctx"], captured["steps"]
    gen_ids = res.tokens[:, ctx:ctx + 1024]
    ok_ids = gen_ids.shape == (4, 1024) and bool(((gen_ids >= 0) & (gen_ids < 8192)).all())
    shapes = [png.read_png(os.path.join(img, "query-0", f"{i}.png")).shape for i in range(4)]
    finite = len(res.images) == 4 and all(bool(np.isfinite(a).all()) for a in res.images)
    print(f"serve int4: {gen_ids.size} generated ids, all in [0, 8192): {ok_ids}; PNG shapes "
          f"{shapes}, images finite: {finite}")
    _check(ok_ids and finite and shapes == [(256, 256, 3)] * 4, "serve outputs")
    print(f"serve int4: K2 launches {k2} == 1024 x 48 = {1024 * 48}: {k2 == 1024 * 48}; K1 "
          f"launches {k1}; plain-version calls {plain_calls}")
    _check(steps == 1024 and k2 == 1024 * 48 and k1 == 0 and plain_calls == 0,
           "the int4 request did not run K2 once per step and layer")
    print(f"serve int4: {captured['request_s']:.3f} s per request (batch 4); filling "
          f"{captured['fill_s']:.3f} s = {1000.0 * captured['fill_s'] / steps:.3f} ms per decode "
          f"step (prefill included, {steps} steps)")
    return k2


FIDELITY_STEPS = 64


def phase_cache_fidelity(torch, gpt, cfgmod, tasks, sampling, tokenization):
    """cogview-base at batch 4 with random weights: the text->image context,
    then 64 teacher-forced image tokens, once through each cache.  The
    per-step KL of the int8 and int4 caches' next-token distributions from
    the exact bf16 cache's, and the argmax agreement."""
    import numpy as np

    cfg = cfgmod.cogview_base()
    dev = torch.device("cuda")
    params = gpt.init_params(cfg, torch.Generator(device=dev).manual_seed(3),
                             dtype=torch.bfloat16, device=dev)
    tok = tokenization.UnifiedTokenizer(img_tokenizer=tokenization.FakeImageTokenizer(8192),
                                        txt_tokenizer=WordTokenizer())
    seq = tasks.parse_query_line(PROMPT, "text2image", tok)
    tpl = sampling.compile_template(seq, tok, padded_vocab=cfg.vocab_size,
                                    pad_to=-(-len(seq) // 32) * 32)
    ctx, B = int(tpl.context_length), 4
    S = ctx + FIDELITY_STEPS
    tokens = torch.as_tensor(tpl.tokens[:S], device=dev).long().expand(B, S).clone()
    tokens[:, ctx:] = torch.as_tensor(np.random.RandomState(11).randint(0, 8192, (B, S - ctx)),
                                      device=dev)
    pos = torch.as_tensor(tpl.position_ids[:S], device=dev).long().expand(B, S)
    logp = {}
    for kv in ("bfloat16", "int8", "int4"):
        c = cfg.replace(kv_cache_dtype=kv)
        cache = gpt.init_cache(c, B, S, device=dev)
        gpt.forward_with_cache(params, c, tokens[:, :ctx], pos[:, :ctx], cache, 0)
        steps = [gpt.forward_with_cache(params, c, tokens[:, t:t + 1], pos[:, t:t + 1], cache,
                                        t)[:, 0] for t in range(ctx, S)]
        logp[kv] = torch.log_softmax(torch.stack(steps, dim=1).float(), dim=-1)
        del cache
        _check(bool(torch.isfinite(logp[kv]).all()), f"non-finite logits with the {kv} cache")
    ref = logp["bfloat16"]
    out = {}
    for kv in ("int8", "int4"):
        kl = (ref.exp() * (ref - logp[kv])).sum(-1)  # [B, steps]
        agree = (ref.argmax(-1) == logp[kv].argmax(-1)).float().mean().item()
        out[kv] = (kl.mean().item(), kl.max().item(), agree)
        print(f"cache fidelity cogview-base B=4, context {ctx} + {FIDELITY_STEPS} teacher-forced "
              f"steps: {kv} vs the bf16 cache: mean per-step KL {out[kv][0]:.4e} nats (max "
              f"{out[kv][1]:.4e}), argmax agreement {100.0 * agree:.2f}%")
    _check(out["int8"][0] <= out["int4"][0], "the int8 cache's KL exceeds the int4 cache's")
    del params, logp, ref
    torch.cuda.empty_cache()
    return out


PRETRAIN_STEPS = 30


def _write_corpus(path: str, rows: int, seed: int) -> None:
    """A CompactBinary corpus: per row 64 text ids (8-40 real, padded with
    -1), then 1,024 image codes in [0, 8192)."""
    import numpy as np

    rng = np.random.RandomState(seed)
    data = np.full((rows, 64 + 1024), -1, np.int32)
    for r in range(rows):
        n = rng.randint(8, 41)
        data[r, :n] = rng.randint(8192, 8192 + 50000, n)
    data[:, 64:] = rng.randint(0, 8192, (rows, 1024))
    data.tofile(path)


def phase_pretrain(torch, fa, pretrain, losses, optim, work: str):
    """Tutorial-width pretraining through the CLI, then a resumed run ->
    (K3, K4, K5 launches, timings)."""
    import contextlib
    import io

    import numpy as np

    corpus = os.path.join(work, "tutorial_t2i.bin")
    _write_corpus(corpus, 600, seed=7)
    save = os.path.join(work, "pretrain_ckpt")
    argv = ["--preset", "tutorial", "--device", "cuda", "--train-data", corpus,
            "--batch-size", "16", "--split", "0.9,0.1,0.0", "--lr", "1e-3", "--warmup", "0.1",
            "--seed", "1234", "--log-interval", "5", "--eval-interval", str(PRETRAIN_STEPS),
            "--eval-iters", "2", "--save", save, "--save-interval", str(PRETRAIN_STEPS)]
    rec = {"metrics": [], "step_s": []}
    orig_make = pretrain.make_train_step

    def recording_make(cfg, opt, **kw):
        step = orig_make(cfg, opt, **kw)
        rec.update(cfg=cfg, kw=kw)

        def timed(state, batch):
            i = len(rec["step_s"])
            if i == 5:
                rec["prof"] = torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA])
                rec["prof"].__enter__()
                rec["prof_t0"] = time.perf_counter()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, metrics = step(state, batch)
            torch.cuda.synchronize()
            rec["step_s"].append(time.perf_counter() - t0)
            if i == 7:
                rec["prof_wall"] = time.perf_counter() - rec["prof_t0"]
                rec["prof"].__exit__(None, None, None)
            rec["metrics"].append(metrics)
            rec.update(state=state, batch=batch)
            return state, metrics

        return timed

    counters = (fa.flash_attention, fa.flash_bwd_dq, fa.flash_bwd_dkv)
    plains = (fa.flash_attention_reference, fa.flash_bwd_dq_reference, fa.flash_bwd_dkv_reference)
    for c in counters:
        c.launches = 0
    for c in plains:
        c.calls = 0
    torch.cuda.reset_peak_memory_stats()
    out = io.StringIO()
    pretrain.make_train_step = recording_make
    try:
        with contextlib.redirect_stdout(out):
            rc = pretrain.main(argv + ["--train-iters", str(PRETRAIN_STEPS)],
                               txt_tokenizer=WordTokenizer())
    finally:
        pretrain.make_train_step = orig_make
    launches = [c.launches for c in counters]
    plain_calls = [c.calls for c in plains]
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    print(out.getvalue(), end="")
    _check(rc == 0, f"pretrain.main returned {rc}")

    steps = len(rec["metrics"])
    lm = [m["lm_loss"] for m in rec["metrics"]]
    skipped = sum(m["skipped"] for m in rec["metrics"])
    print(f"pretrain: {steps} steps, lm loss first {lm[0]:.4f}, mean of the last 5 "
          f"{np.mean(lm[-5:]):.4f}, all finite: {bool(np.isfinite(lm).all())}, skipped {skipped}")
    _check(steps == PRETRAIN_STEPS and np.isfinite(lm).all() and skipped == 0,
           "pretraining losses not finite or a step skipped")
    _check(np.mean(lm[-5:]) <= lm[0] - 0.5, "pretraining loss did not fall by 0.5")
    val = [ln for ln in out.getvalue().splitlines() if ln.startswith(" validation loss")]
    L = rec["cfg"].num_layers
    want = [2 * L * steps + L * 2, L * steps, L * steps]  # remat replay; 2 eval batches
    print(f"pretrain: launches (flash fwd, dq, dkv) {launches}, expected {want}; plain-version "
          f"calls {plain_calls}; eval lines {len(val)}")
    _check(launches == want and plain_calls == [0, 0, 0] and len(val) == 1,
           "pretraining did not run the flash kernels once per layer and step")

    step_ms = 1000.0 * statistics.median(rec["step_s"][3:])
    tokens = 16 * 1088
    from cogview_tpu_torch.scripts._timing import device_time

    cats, _, busy, top, flash = device_time(rec["prof"], rec["prof_wall"])
    print(f"pretrain: {step_ms:.3f} ms per step (median of steps 4-{steps}, host clock around "
          f"synchronised steps), {tokens / step_ms * 1000.0:.1f} tokens/s; peak memory "
          f"{peak_gib:.3f} GiB")
    print(f"pretrain: steps 6-8 under torch.profiler: wall {rec['prof_wall']:.3f} s, device "
          f"busy {100.0 * busy:.1f}%; kernel time by kind " + ", ".join(
              f"{k} {1000.0 * v / 3:.3f} ms/step" for k, v in cats.items()))
    for sec, n, name in top:
        print(f"pretrain: kernel {1000.0 * sec / 3:.3f} ms/step ({n // 3} launches/step) {name}")
    for name, (sec, n) in sorted(flash.items()):
        print(f"pretrain: flash kernel {name} {1000.0 * sec / 3:.3f} ms/step ({n // 3} "
              f"launches/step)")

    # forward, backward and optimizer apart, on the last batch and state
    state, cfg, kw = rec["state"], rec["cfg"], rec["kw"]
    params = state["params"]
    leaves = list(optim.tree_leaves(params))
    batch = {k: torch.as_tensor(v).cuda() for k, v in rec["batch"].items()}
    seeds = list(range(1, L + 2))
    parts = {"forward": [], "forward + backward": []}
    for _ in range(3):
        for name in parts:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss, _ = losses.lm_loss(params, cfg, batch, img_vocab=kw["img_vocab"],
                                     txt_loss_scale=kw["txt_loss_scale"], seeds=seeds)
            if name != "forward":
                torch.autograd.grad(loss, leaves)
            torch.cuda.synchronize()
            parts[name].append(time.perf_counter() - t0)
            del loss
    fwd = 1000.0 * min(parts["forward"])
    fb = 1000.0 * min(parts["forward + backward"])
    print(f"pretrain: forward {fwd:.3f} ms, backward {fb - fwd:.3f} ms (remat replay "
          f"included), optimizer and the rest {step_ms - fb:.3f} ms per step (host clock, "
          f"best of 3)")
    del rec, state, params, leaves, batch
    torch.cuda.empty_cache()

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = pretrain.main(argv + ["--train-iters", str(PRETRAIN_STEPS + 2), "--load", save,
                                   "--resume-dataloader", "--log-interval", "1",
                                   "--save", os.path.join(work, "pretrain_ckpt2")],
                           txt_tokenizer=WordTokenizer())
    print(out.getvalue(), end="")
    lines = out.getvalue().splitlines()
    resumed = f"loaded checkpoint from {save} at iteration {PRETRAIN_STEPS}" in lines
    iters = _iterations(out.getvalue())
    print(f"pretrain resume: loaded at iteration {PRETRAIN_STEPS}: {resumed}; iterations run "
          f"{iters}")
    _check(rc == 0 and resumed and iters == [str(PRETRAIN_STEPS + 1), str(PRETRAIN_STEPS + 2)],
           "the --load run did not resume at the saved iteration")
    return launches, {"step_ms": step_ms, "busy": busy}


# ---------------------------------------------------------------------------
# checkpoints in the reference's layouts, every tensor drawn from its own seed
# ---------------------------------------------------------------------------

CKPT_SEED = 1000
# per-layer keys of the reference's GPT state dict -> (port leaf, field, how
# the converter lays the [out, in] tensor out)
_LAYER_KEYS = (
    ("input_layernorm.weight", "ln_in", "g", "gain"),
    ("input_layernorm.bias", "ln_in", "b", ""),
    ("attention.query_key_value.weight", "qkv", "w", "qkv"),
    ("attention.query_key_value.bias", "qkv", "b", "qkv_b"),
    ("attention.dense.weight", "attn_out", "w", "t"),
    ("attention.dense.bias", "attn_out", "b", ""),
    ("post_attention_layernorm.weight", "ln_post", "g", "gain"),
    ("post_attention_layernorm.bias", "ln_post", "b", ""),
    ("third_layernorm.weight", "ln_attn", "g", "gain"),
    ("third_layernorm.bias", "ln_attn", "b", ""),
    ("fourth_layernorm.weight", "ln_mlp", "g", "gain"),
    ("fourth_layernorm.bias", "ln_mlp", "b", ""),
    ("mlp.dense_h_to_4h.weight", "mlp_in", "w", "t"),
    ("mlp.dense_h_to_4h.bias", "mlp_in", "b", ""),
    ("mlp.dense_4h_to_h.weight", "mlp_out", "w", "t"),
    ("mlp.dense_4h_to_h.bias", "mlp_out", "b", ""),
)


def _gpt_layout(L: int, H: int, V: int, P: int):
    """The reference GPT state dict in order -> [(key, shape, port leaf path,
    layer or None, layout)]."""
    shapes = {"input_layernorm": (H,), "post_attention_layernorm": (H,), "third_layernorm": (H,),
              "fourth_layernorm": (H,), "attention.query_key_value": (3 * H, H),
              "attention.dense": (H, H), "mlp.dense_h_to_4h": (4 * H, H),
              "mlp.dense_4h_to_h": (H, 4 * H)}
    out = [("word_embeddings.weight", (V, H), ("embed", "word"), None, ""),
           ("transformer.position_embeddings.weight", (P, H), ("embed", "pos"), None, "")]
    for i in range(L):
        for key, leaf, field, how in _LAYER_KEYS:
            mod, kind = key.rsplit(".", 1)
            shape = shapes[mod] if kind == "weight" else shapes[mod][:1]
            out.append((f"transformer.layers.{i}.{key}", shape, ("layers", leaf, field), i, how))
    out += [("transformer.final_layernorm.weight", (H,), ("ln_final", "g"), None, "gain"),
            ("transformer.final_layernorm.bias", (H,), ("ln_final", "b"), None, "")]
    return out


def _seeded(torch, idx: int, shape, how: str, dtype):
    """Tensor ``idx`` of a synthetic checkpoint, drawn on the card from seed
    CKPT_SEED + idx: N(0, 0.02^2), plus 1 for a LayerNorm gain."""
    dev = torch.device("cuda")
    t = torch.randn(shape, generator=torch.Generator(device=dev).manual_seed(CKPT_SEED + idx),
                    device=dev, dtype=torch.float32).mul_(0.02)
    if how == "gain":
        t.add_(1.0)
    return t.to(dtype)


def _write_gpt_checkpoint(torch, path: str, L: int, H: int, V: int, P: int, dtype) -> int:
    """A DeepSpeed mp_rank_00_model_states.pt: {"module": state dict with
    module. keys, ...} with the training arguments beside it -> its bytes."""
    import argparse

    sd = {f"module.{key}": _seeded(torch, i, shape, how, dtype).cpu()
          for i, (key, shape, _, _, how) in enumerate(_gpt_layout(L, H, V, P))}
    torch.save({"module": sd, "mp_world_size": 1, "iteration": 0,
                "args": argparse.Namespace(num_layers=L, hidden_size=H)}, path)
    del sd
    return os.path.getsize(path)


def _verify_gpt_leaves(torch, params, L: int, H: int, V: int, P: int, dtype):
    """Every leaf of loaded GPT params against its source tensor drawn again
    from its seed on the card, laid out as the converter lays it out (a
    longer position table against its first P rows) -> (leaves checked,
    the keys that differ in value or dtype)."""
    bad, n = [], 0
    for i, (key, shape, path, layer, how) in enumerate(_gpt_layout(L, H, V, P)):
        leaf = params
        for k in path:
            leaf = leaf[k]
        if layer is not None:
            leaf = leaf[layer]
        src = _seeded(torch, i, shape, how, dtype)
        if how == "qkv":
            src = src.t().reshape(H, 3, H)
        elif how == "qkv_b":
            src = src.reshape(3, H)
        elif how == "t":
            src = src.t()
        if key == "transformer.position_embeddings.weight":
            leaf = leaf[:P]
        if leaf.dtype != dtype or not torch.equal(leaf, src):
            bad.append(key)
        n += 1
    return n, bad


def _write_vqvae_checkpoint(torch, vqvae, cfgmod, path: str) -> None:
    """The released VQ-VAE's state dict layout (enc_b.blocks.{0,2,4,6},
    quantize_t.*, dec.blocks.{0,2,4,6}) at its published widths, float32,
    from the port's random init with a seed."""
    dev = torch.device("cuda")
    p = vqvae.init_params(cfgmod.VQVAEConfig(), torch.Generator(device=dev).manual_seed(5), dev)
    sd = {}
    for part, names in (("enc_b", ("conv0", "conv1", "conv2", "proj")),
                        ("dec", ("convt0", "convt1", "convt2", "proj"))):
        tree = p["encoder" if part == "enc_b" else "decoder"]
        for j, name in enumerate(names):
            sd[f"{part}.blocks.{2 * j}.weight"] = tree[name]["w"].cpu()
            sd[f"{part}.blocks.{2 * j}.bias"] = tree[name]["b"].cpu()
    embed = p["quantize"]["embed"].cpu()
    sd.update({"quantize_t.embed": embed, "quantize_t.embed_avg": embed.clone(),
               "quantize_t.cluster_size": torch.ones(embed.shape[1])})
    torch.save(sd, path)


def _status_kib(field: str):
    """A field of /proc/self/status in KiB (VmRSS, VmHWM), or None where the
    kernel does not report it."""
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith(field + ":"):
                return int(line.split()[1])
    return None


class _PeakRss:
    """The process's peak host RSS over a span in KiB, by every measure the
    kernel offers (a sandboxed kernel may report no VmHWM): VmHWM; VmRSS
    sampled every 2 ms by a thread; and getrusage's ru_maxrss where it grew
    during the span.  ru_maxrss keeps what the process inherited across
    fork and exec (the parent's peak), so only a rise within the span makes
    it this span's peak."""

    def __enter__(self):
        import resource
        import threading

        self.maxrss_before = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
        self.sampled, self._stop = _status_kib("VmRSS") or 0, threading.Event()

        def poll():
            while not self._stop.wait(0.002):
                self.sampled = max(self.sampled, _status_kib("VmRSS") or 0)

        self._thread = threading.Thread(target=poll, daemon=True)
        self._thread.start()
        return self

    def __exit__(self, *exc):
        import resource

        self._stop.set()
        self._thread.join()
        self.sampled = max(self.sampled, _status_kib("VmRSS") or 0)
        self.hwm = _status_kib("VmHWM")
        self.maxrss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
        grew = self.maxrss if self.maxrss > self.maxrss_before else 0
        self.peak = max(self.sampled, self.hwm or 0, grew)
        return False


def write_checkpoint_child(spec_json: str) -> int:
    """``chip_smoke.py --write-checkpoint <json>``: the GPT checkpoint that
    phase 17 loads, written by its own process, so that the parent's peak
    host RSS (which a child's ru_maxrss inherits) never holds the 7.9 GB
    dict.  Prints one JSON line: the file's bytes and the seconds taken."""
    import torch

    spec = json.loads(spec_json)
    t0 = time.perf_counter()
    nbytes = _write_gpt_checkpoint(torch, spec["path"], *spec["dims"],
                                   getattr(torch, spec["dtype"]))
    print(json.dumps({"bytes": nbytes, "seconds": time.perf_counter() - t0}))
    return 0


def _run_child(flag: str, spec: dict, what: str):
    """``chip_smoke.py <flag> <spec as JSON>`` from the script's directory:
    its output lines but the last, prefixed, and its last line's JSON."""
    here = os.path.dirname(os.path.abspath(__file__))
    proc = subprocess.run([sys.executable, os.path.join(here, "chip_smoke.py"), flag,
                           json.dumps(spec)], cwd=here, capture_output=True, text=True,
                          timeout=900)
    lines = proc.stdout.strip().splitlines()
    if lines[:-1]:
        print("\n".join(f"{what}: {ln}" for ln in lines[:-1]))
    if proc.returncode != 0 or not lines:
        print(proc.stderr[-4000:], file=sys.stderr)
        _fail(f"the {what} process exited {proc.returncode}")
    return json.loads(lines[-1])


def checkpoint_child(spec_json: str) -> int:
    """The child process of the checkpoint phase: ``cli.generate.main``
    with --load (the 48-layer float16 DeepSpeed file) and
    --img-tokenizer-path, one image->text request.  Prints its numbers, then
    one JSON line: the load's seconds, peak and pre-load host RSS, the
    params' bytes on the card, the leaves' check, the request's seconds and
    ms per decode step, K1 launches and the generated ids' check."""
    import torch

    from cogview_tpu_torch import config as cfgmod
    from cogview_tpu_torch.cli import generate as cli
    from cogview_tpu_torch.generation import sampling, tasks
    from cogview_tpu_torch.models import gpt
    from cogview_tpu_torch.ops import decode_attention as da
    from cogview_tpu_torch.training.optim import tree_leaves

    spec = json.loads(spec_json)
    cfg = cfgmod.cogview_base()
    dims = (cfg.num_layers, cfg.hidden_size, cfg.vocab_size, cfg.max_position_embeddings)
    torch.zeros(1, device="cuda")  # the CUDA context before the baseline RSS
    torch.cuda.synchronize()
    rec = {"rss_before_kib": _status_kib("VmRSS")}
    orig_load, orig_fwc = cli.load_model, gpt.forward_with_cache

    def measured_load(args, device):
        with _PeakRss() as peak:
            t0 = time.perf_counter()
            params, c = orig_load(args, device)
            torch.cuda.synchronize()
            rec["load_s"] = time.perf_counter() - t0
        rec.update(hwm_kib=peak.peak, vmhwm_kib=peak.hwm, maxrss_kib=peak.maxrss,
                   maxrss_before_kib=peak.maxrss_before, sampled_kib=peak.sampled,
                   rss_after_kib=_status_kib("VmRSS"))
        rec["params_bytes"] = sum(t.numel() * t.element_size() for t in tree_leaves(params))
        rec["dtypes"] = sorted({str(t.dtype) for t in tree_leaves(params)})
        rec["leaves"], rec["differ"] = _verify_gpt_leaves(torch, params, *dims, torch.float16)
        return params, c

    step_t = []

    def timed_fwc(params, c, tokens, *a, **kw):
        if tokens.shape[1] == 1:
            step_t.append(time.perf_counter())
        return orig_fwc(params, c, tokens, *a, **kw)

    captured = {}
    da.decode_attention_quant.launches = 0
    da.decode_attention_quant_reference.calls = 0
    cli.load_model, gpt.forward_with_cache = measured_load, timed_fwc
    try:
        _run_cli(cli, tasks, sampling, torch,
                 _cli_argv("bfloat16", "image2text", spec["query"], spec["out"])
                 + ["--load", spec["gpt"], "--img-tokenizer-path", spec["vq"]], captured)
    finally:
        cli.load_model, gpt.forward_with_cache = orig_load, orig_fwc
    torch.cuda.synchronize()
    res, ctx = captured["res"], captured["ctx"]
    ids = res.tokens[:, ctx:ctx + 20]
    rec.update(k1_launches=da.decode_attention_quant.launches,
               plain_calls=da.decode_attention_quant_reference.calls,
               ctx=ctx, steps=captured["steps"], request_s=captured["request_s"],
               ids_ok=bool(ids.shape == (4, 20) and ((ids >= 8192) & (ids < 58192)).all()),
               step_ms=1000.0 * (step_t[-1] - step_t[1]) / (len(step_t) - 2))
    print(json.dumps(rec))
    return 0


def phase_checkpoint(torch, cfgmod, vqvae, png_dir: str, work: str, smi: str) -> int:
    """cogview-base at full size from the reference's file layouts: a
    48-layer float16 DeepSpeed checkpoint (written by a child process, so
    this one never holds the 7.9 GB dict) and the VQ-VAE's state dict, both
    from seeds, loaded by another child process, whose peak RSS measures
    the load alone, that serves one image->text request -> its K1
    launches."""
    cfg = cfgmod.cogview_base()
    dims = (cfg.num_layers, cfg.hidden_size, cfg.vocab_size, cfg.max_position_embeddings)
    with tempfile.TemporaryDirectory(dir=work) as tmp:
        gpt_path = os.path.join(tmp, "mp_rank_00_model_states.pt")
        vq_path = os.path.join(tmp, "vqvae_hard_biggerset_011.pt")
        w = _run_child("--write-checkpoint", {"path": gpt_path, "dims": dims,
                                              "dtype": "float16"}, "checkpoint writer")
        file_bytes = w["bytes"]
        _write_vqvae_checkpoint(torch, vqvae, cfgmod, vq_path)
        query = os.path.join(tmp, "i2t.txt")
        with open(query, "w") as f:
            f.write(os.path.join(png_dir, "0.png") + "\n")
        maxrss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
        print(f"checkpoint: a child process wrote a 48-layer cogview-base DeepSpeed file, "
              f"float16, {file_bytes / 1e9:.3f} GB in {w['seconds']:.2f} s; the VQ-VAE's "
              f"state dict; this process's ru_maxrss {maxrss} KiB, which the loading child "
              f"inherits")
        torch.cuda.empty_cache()  # the child needs the card's memory
        r = _run_child("--checkpoint-child", {"gpt": gpt_path, "vq": vq_path, "query": query,
                                              "out": os.path.join(tmp, "i2t")},
                       "checkpoint child")
    gib = 2.0 ** 30
    peak = (r["hwm_kib"] - r["rss_before_kib"]) * 1024
    print(f"checkpoint: load {r['load_s']:.3f} s; peak host RSS {r['hwm_kib'] * 1024 / gib:.3f} "
          f"GiB (the largest of VmHWM {r['vmhwm_kib']} KiB, VmRSS sampled every 2 ms "
          f"{r['sampled_kib']} KiB, and ru_maxrss {r['maxrss_kib']} KiB where it grew from the "
          f"{r['maxrss_before_kib']} KiB it held before the load), "
          f"{peak / gib:.3f} GiB above the {r['rss_before_kib'] * 1024 / gib:.3f} GiB "
          f"before the load = {peak / file_bytes:.3f} x the file (bound 1.2); RSS after the "
          f"load {r['rss_after_kib'] * 1024 / gib:.3f} GiB; params on the card "
          f"{r['params_bytes'] / 1e9:.3f} GB, dtypes {r['dtypes']} ({smi})")
    print(f"checkpoint: {r['leaves']} leaves bit-equal to the file's tensors: "
          f"{not r['differ']} (differ: {r['differ'][:4]})")
    _check(not r["differ"] and r["dtypes"] == ["torch.float16"],
           "loaded leaves differ from the checkpoint's tensors")
    _check(peak <= 1.2 * file_bytes, "the load's peak host RSS exceeds 1.2 x the file")
    print(f"checkpoint: image2text from the loaded model: context {r['ctx']}, 20 ids a row in "
          f"the text range: {r['ids_ok']}; K1 launches {r['k1_launches']} == 20 x 48 = 960, "
          f"plain-version calls {r['plain_calls']}; {r['request_s']:.3f} s per request, "
          f"{r['step_ms']:.3f} ms per decode step (host clock, float16 weights cast at use; "
          f"{smi})")
    _check(r["ids_ok"] and r["ctx"] == 1028 and r["steps"] == 20 and r["k1_launches"] == 960
           and r["plain_calls"] == 0, "the loaded model's image2text request")
    return r["k1_launches"]


def phase_serve_pretrained(torch, da, cli, optim, tasks, sampling, png, work: str,
                           smi: str) -> int:
    """text->image at the tutorial preset through ``cli.generate.main --load``
    of phase 14's pretraining checkpoint -> K1 launches."""
    import numpy as np

    save = os.path.join(work, "pretrain_ckpt")
    query = os.path.join(work, "tutorial_query.txt")
    with open(query, "w") as f:
        f.write(PROMPT + "\n")
    out_dir = os.path.join(work, "tutorial_t2i")
    argv = ["--preset", "tutorial", "--load", save, "--dtype", "bfloat16", "--weights",
            "bfloat16", "--kv-cache", "int8", "--batch-size", "4", "--top_k", "200", "--seed",
            "1234", "--device", "cuda", "--generation-task", "text2image", "--input-source",
            query, "--output-path", out_dir]
    loaded = {}
    orig_load = cli.load_model

    def keep(args, device):
        params, cfg = orig_load(args, device)
        loaded.update(params=params, cfg=cfg)
        return params, cfg

    captured = {}
    da.decode_attention_quant.launches = 0
    da.decode_attention_quant.launches_int4 = 0
    da.decode_attention_quant_reference.calls = 0
    cli.load_model = keep
    try:
        _run_cli(cli, tasks, sampling, torch, argv, captured)
    finally:
        cli.load_model = orig_load
    launches = da.decode_attention_quant.launches
    plain_calls = da.decode_attention_quant_reference.calls
    L = loaded["cfg"].num_layers

    with open(os.path.join(save, "latest_checkpointed_iteration.txt")) as f:
        it = f.read().strip()
    saved = torch.load(os.path.join(save, it, "state.pt"), map_location="cuda",
                       weights_only=True)["params"]
    got, want = list(optim.tree_leaves(loaded["params"])), list(optim.tree_leaves(saved))
    same = len(got) == len(want) and all(
        g.dtype == torch.bfloat16 and torch.equal(g, w.to(torch.bfloat16))
        for g, w in zip(got, want))
    print(f"serve pretrained: --preset tutorial --load {os.path.basename(save)} (iteration "
          f"{it}): {len(got)} leaves equal to the checkpoint's float32 params cast to bf16: "
          f"{same}")
    _check(same, "the loaded tutorial params differ from the checkpoint's")
    res, ctx, steps = captured["res"], captured["ctx"], captured["steps"]
    gen_ids = res.tokens[:, ctx:ctx + 1024]
    ok_ids = gen_ids.shape == (4, 1024) and bool(((gen_ids >= 0) & (gen_ids < 8192)).all())
    shapes = [png.read_png(os.path.join(out_dir, f"{i}.png")).shape for i in range(4)]
    finite = len(res.images) == 4 and all(bool(np.isfinite(a).all()) for a in res.images)
    print(f"serve pretrained: {gen_ids.size} generated ids, all in [0, 8192): {ok_ids}; PNG "
          f"shapes {shapes}, images finite: {finite}")
    _check(ok_ids and finite and shapes == [(256, 256, 3)] * 4, "tutorial text2image outputs")
    print(f"serve pretrained: K1 launches {launches} == 1024 x {L} = {1024 * L}: "
          f"{launches == 1024 * L}; plain-version calls {plain_calls}; "
          f"{captured['request_s']:.3f} s per request (batch 4), "
          f"{1000.0 * captured['fill_s'] / steps:.3f} ms per decode step (prefill included; "
          f"{smi})")
    _check(L == 12 and steps == 1024 and launches == 1024 * L and plain_calls == 0,
           "the tutorial request did not run K1 once per step and layer")
    return launches


# ---------------------------------------------------------------------------
# super-resolution finetuning, and the memory, sparse and float16 routes
# ---------------------------------------------------------------------------


def _write_sr_corpus(path: str, rows: int, seed: int) -> int:
    """An IndexedDataset of super-resolution rows laid out as
    cogview_tpu/preprocess/tokenize_images.py's make_super_resolution_rows
    lays them out: [ROI1], 8-40 text ids, [BASE] [BOI1], the overview's
    1,024 codes, [EOI1] [ROI2] [POSp] [BASE] [BOI2], the patch's 1,024
    codes, [EOI2] (the 1,345-position preset reads each row's first 1,345
    ids) -> the id of [ROI2]."""
    import numpy as np

    from cogview_tpu_torch.data.datasets import IndexedDataset
    from cogview_tpu_torch.tokenization.unified import FakeImageTokenizer, UnifiedTokenizer

    tok = UnifiedTokenizer(img_tokenizer=FakeImageTokenizer(8192), txt_tokenizer=WordTokenizer())
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(rows):
        n = rng.randint(8, 41)
        out.append(np.concatenate([
            [tok["[ROI1]"]], rng.randint(8192, 8192 + 50000, n), [tok["[BASE]"], tok["[BOI1]"]],
            rng.randint(0, 8192, 1024),
            [tok["[EOI1]"], tok["[ROI2]"], tok[f"[POS{rng.randint(9)}]"], tok["[BASE]"],
             tok["[BOI2]"]],
            rng.randint(0, 8192, 1024), [tok["[EOI2]"]]]).astype(np.int32))
    IndexedDataset.write(path, out)
    return tok["[ROI2]"]


def _recording_steps(torch, pretrain, name: str, rec: dict, profile_steps=()):
    """Wraps the CLI's step factory ``pretrain.<name>``: each step is timed
    (host clock around a synchronised step), its metrics, the memory's shape
    and at the first step the position table and the optimizer count are
    kept in ``rec``; the steps at the 0-based indices ``profile_steps`` run
    under torch.profiler (rec["prof"], rec["prof_wall"]) -> a function that
    puts the factory back."""
    orig = getattr(pretrain, name)
    rec.update(metrics=[], step_s=[], mems=[])

    def make(cfg, opt, **kw):
        step = orig(cfg, opt, **kw)
        rec["kw"] = kw

        def timed(state, batch, *a, **k):
            i = len(rec["step_s"])
            if i == 0:
                rec["first"] = {"pos": state["params"]["embed"]["pos"].detach().clone(),
                                "count": state["opt_state"]["count"]}
            if profile_steps and i == profile_steps[0]:
                rec["prof"] = torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA])
                rec["prof"].__enter__()
                rec["prof_t0"] = time.perf_counter()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = step(state, batch, *a, **k)
            torch.cuda.synchronize()
            rec["step_s"].append(time.perf_counter() - t0)
            if profile_steps and i == profile_steps[-1]:
                rec["prof_wall"] = time.perf_counter() - rec["prof_t0"]
                rec["prof"].__exit__(None, None, None)
            rec["metrics"].append(out[1])
            if len(out) == 3:
                rec["mems"].append(tuple(out[2].shape))
            return out

        return timed

    setattr(pretrain, name, make)
    return lambda: setattr(pretrain, name, orig)


def _run_pretrain(pretrain, argv):
    """``cli.pretrain.main(argv)`` with its output captured and printed ->
    (return code, output)."""
    import contextlib
    import io

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = pretrain.main(argv, txt_tokenizer=WordTokenizer())
    print(out.getvalue(), end="")
    return rc, out.getvalue()


def _iterations(out: str):
    return [ln.split("/")[0].split()[-1] for ln in out.splitlines()
            if ln.startswith(" iteration")]


FLASH_COUNTERS = ("flash_attention", "flash_bwd_dq", "flash_bwd_dkv")
FLASH_PLAINS = ("flash_attention_reference", "flash_bwd_dq_reference", "flash_bwd_dkv_reference")


def _zero_flash_counts(fa) -> None:
    for name in FLASH_COUNTERS:
        getattr(fa, name).launches = 0
    for name in FLASH_PLAINS:
        getattr(fa, name).calls = 0


def _flash_counts(fa):
    """-> ([K3, K4, K5 launches], [their plain versions' calls])."""
    return ([getattr(fa, n).launches for n in FLASH_COUNTERS],
            [getattr(fa, n).calls for n in FLASH_PLAINS])


SR_TRAIN_STEPS = 4


def phase_sr_finetune(torch, fa, pretrain, gpt, work: str):
    """Super-resolution finetuning through ``cli.pretrain.main`` at the
    published widths, depth cut to SR_LAYERS: cogview-base trains 2 steps
    and saves a 1,089-position checkpoint; cogview-sr loads it with
    --finetune --dual-positions and trains SR_TRAIN_STEPS steps on rows
    laid out as the JAX package's super-resolution rows; a second --load
    without --finetune resumes the optimizer -> [K3, K4, K5 launches]."""
    import numpy as np

    t2i = os.path.join(work, "sr_base_t2i.bin")
    _write_corpus(t2i, 16, seed=11)
    rows = os.path.join(work, "sr_rows")
    roi2 = _write_sr_corpus(rows, 16, seed=12)
    base, ft = os.path.join(work, "sr_base_ckpt"), os.path.join(work, "sr_ft_ckpt")
    common = ["--num-layers", str(SR_LAYERS), "--device", "cuda", "--batch-size", "2",
              "--split", "1.0,0.0,0.0", "--log-interval", "1", "--lr", "1e-4", "--warmup",
              "0.0", "--seed", "1234"]
    sr = ["--preset", "cogview-sr", "--dual-positions", "--dataset-type", "TokenizedDataset",
          "--train-data", rows]
    L, total = SR_LAYERS, np.zeros(3, np.int64)

    _zero_flash_counts(fa)
    rc, out = _run_pretrain(pretrain, ["--preset", "cogview-base", "--train-data", t2i,
                                       "--train-iters", "2", "--save", base] + common)
    launches, plain = _flash_counts(fa)
    _check(rc == 0 and _iterations(out) == ["1", "2"], "the cogview-base run failed")
    _check(launches == [4 * L, 2 * L, 2 * L] and plain == [0, 0, 0],
           "the cogview-base steps did not run the flash kernels once per layer")
    total += launches
    saved = torch.load(os.path.join(base, "2", "state.pt"), map_location="cuda",
                       weights_only=True)["params"]["embed"]["pos"]
    print(f"sr finetune: cogview-base ({L} of 48 layers) saved at iteration 2, position "
          f"table {tuple(saved.shape)}")

    rec = {}
    restore = _recording_steps(torch, pretrain, "make_train_step", rec)
    _zero_flash_counts(fa)
    try:
        rc, out = _run_pretrain(pretrain, sr + common + [
            "--load", base, "--finetune", "--train-iters", str(SR_TRAIN_STEPS), "--save", ft])
    finally:
        restore()
    launches, plain = _flash_counts(fa)
    total += launches
    pos = rec["first"]["pos"]
    lm = [m["lm_loss"] for m in rec["metrics"]]
    skipped = sum(m["skipped"] for m in rec["metrics"])
    extended = torch.equal(pos, gpt.extend_position_embedding(saved, 1345))
    print(f"sr finetune: --preset cogview-sr --load --finetune --dual-positions: loaded at "
          f"iteration 0: {f'loaded checkpoint from {base} at iteration 0' in out}; iterations "
          f"{_iterations(out)}; optimizer count at the first step {rec['first']['count']}; "
          f"[ROI2] id {rec['kw']['dual_positions_roi2']} (want {roi2}); position table "
          f"{tuple(pos.shape)}, rows 0-1088 bit-equal to the saved table: "
          f"{torch.equal(pos[:1089], saved)}, rows 1089-1344 the tiled table: {extended}")
    print(f"sr finetune: lm loss {['%.4f' % v for v in lm]}, skipped {skipped}; flash launches "
          f"(fwd, dq, dkv) {launches}, plain-version calls {plain}; "
          f"{1000.0 * statistics.median(rec['step_s']):.3f} ms per step at batch 2 x 1,344")
    _check(rc == 0 and f"loaded checkpoint from {base} at iteration 0" in out
           and _iterations(out) == [str(i + 1) for i in range(SR_TRAIN_STEPS)],
           "the --finetune run did not start at iteration 0")
    _check(rec["first"]["count"] == 0 and rec["kw"]["dual_positions_roi2"] == roi2,
           "--finetune kept the optimizer state, or --dual-positions was not passed on")
    _check(pos.shape == (1345, saved.shape[1]) and torch.equal(pos[:1089], saved) and extended,
           "the finetune's position table is not the saved one extended")
    _check(np.isfinite(lm).all() and skipped == 0, "finetune losses not finite or a step skipped")
    want = [2 * L * SR_TRAIN_STEPS, L * SR_TRAIN_STEPS, L * SR_TRAIN_STEPS]
    _check(launches == want and plain == [0, 0, 0],
           f"the finetune steps launched {launches} flash kernels, not {want}")

    restore = _recording_steps(torch, pretrain, "make_train_step", rec)
    _zero_flash_counts(fa)
    try:
        rc, out = _run_pretrain(pretrain, sr + common + [
            "--load", ft, "--train-iters", str(SR_TRAIN_STEPS + 2)])
    finally:
        restore()
    launches, _ = _flash_counts(fa)
    total += launches
    resumed = f"loaded checkpoint from {ft} at iteration {SR_TRAIN_STEPS}" in out
    print(f"sr finetune resume: --load without --finetune: loaded at iteration "
          f"{SR_TRAIN_STEPS}: {resumed}; iterations {_iterations(out)}; optimizer count at the "
          f"first step {rec['first']['count']}")
    _check(rc == 0 and resumed and rec["first"]["count"] == SR_TRAIN_STEPS
           and _iterations(out) == [str(SR_TRAIN_STEPS + 1), str(SR_TRAIN_STEPS + 2)],
           "the --load run without --finetune did not resume the optimizer")
    return rows, [int(n) for n in total]


# cogview-sr finetuning at its full depth: batch 2 x 1,344 tokens
SR_FULL_BATCH = 2
SR_FULL_STEPS = 6
SR_FULL_PROFILED = (4, 5)  # the 0-based steps under torch.profiler; 1-3 are timed


def sr_train_child(spec_json: str) -> int:
    """``chip_smoke.py --sr-train-child <json>``: cogview-sr at its published
    widths and 48 layers through ``cli.pretrain.main --dual-positions`` in a
    process of its own, so that its peak device memory is its own.  Prints
    the CLI's lines, then one JSON line: per-step times, losses, skips, the
    flash launches, the peak memory, and the profiled steps' kernel time by
    kind."""
    import torch

    from cogview_tpu_torch.cli import pretrain
    from cogview_tpu_torch.ops import flash_attention as fa
    from cogview_tpu_torch.scripts._timing import device_time

    spec = json.loads(spec_json)
    rec = {}
    restore = _recording_steps(torch, pretrain, "make_train_step", rec, SR_FULL_PROFILED)
    _zero_flash_counts(fa)
    # nothing here touches CUDA before the CLI does, so the CLI's allocator
    # setting takes effect; the peak is this process's own
    try:
        rc, out = _run_pretrain(pretrain, [
            "--preset", "cogview-sr", "--dual-positions", "--device", "cuda",
            "--dataset-type", "TokenizedDataset", "--train-data", spec["data"],
            "--batch-size", str(SR_FULL_BATCH), "--train-iters", str(SR_FULL_STEPS),
            "--split", "1.0,0.0,0.0", "--log-interval", "1", "--lr", "1e-4", "--warmup", "0.0",
            "--seed", "1234"])
    finally:
        restore()
    launches, plain = _flash_counts(fa)
    secs, counts, busy, top, flash = device_time(rec["prof"], rec["prof_wall"])
    n = len(SR_FULL_PROFILED)
    print(json.dumps({
        "rc": rc, "iterations": _iterations(out), "step_s": rec["step_s"],
        "lm": [m["lm_loss"] for m in rec["metrics"]],
        "skipped": sum(m["skipped"] for m in rec["metrics"]),
        "roi2": rec["kw"]["dual_positions_roi2"], "launches": launches, "plain": plain,
        "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
        "alloc_conf": os.environ.get("PYTORCH_CUDA_ALLOC_CONF"),
        "kernel_ms": {k: 1000.0 * v / n for k, v in secs.items()},
        "kernel_launches": {k: v // n for k, v in counts.items()},
        "busy": busy, "prof_wall_ms": 1000.0 * rec["prof_wall"] / n,
        "top": [(1000.0 * s / n, c // n, name) for s, c, name in top],
        "flash": {k: (1000.0 * s / n, c // n) for k, (s, c) in flash.items()}}))
    return 0


def phase_sr_full_depth(torch, rows: str, smi: str):
    """cogview-sr finetuning at full depth in a child process (the rows of
    phase 19) -> ([K3, K4, K5 launches], summary)."""
    import numpy as np

    torch.cuda.empty_cache()  # the child needs the card's memory
    held = torch.cuda.memory_reserved() / 2 ** 30
    print(f"sr full depth: this process holds {held:.3f} GiB of the card's memory "
          f"(torch.cuda.memory_reserved) while the child runs")
    # the child inherits this environment as it is: the allocator setting
    # the 48-layer step needs is the CLI's own
    inherited = os.environ.get("PYTORCH_CUDA_ALLOC_CONF")
    r = _run_child("--sr-train-child", {"data": rows}, "sr full depth")
    print(f"sr full depth: PYTORCH_CUDA_ALLOC_CONF {inherited!r} in this process, "
          f"{r['alloc_conf']!r} in the child after cli.pretrain.main")
    _check(inherited is not None or r["alloc_conf"] == "expandable_segments:True",
           "the pretrain CLI did not set the allocator's expandable segments")
    L, S = 48, SR_FULL_STEPS
    step_ms = 1000.0 * statistics.median(r["step_s"][1:SR_FULL_PROFILED[0]])
    tokens = SR_FULL_BATCH * 1344
    print(f"sr full depth: cogview-sr, 48 layers, batch {SR_FULL_BATCH} x 1,344, --dual-positions "
          f"([ROI2] {r['roi2']}): iterations {r['iterations']}, lm loss "
          f"{['%.4f' % v for v in r['lm']]}, skipped {r['skipped']}")
    print(f"sr full depth: {step_ms:.3f} ms per step (median of steps 2-{SR_FULL_PROFILED[0]}, "
          f"host clock around "
          f"synchronised steps; all {['%.1f' % (1000.0 * t) for t in r['step_s']]}), "
          f"{tokens / step_ms * 1000.0:.1f} tokens/s; peak memory {r['peak_gib']:.3f} GiB "
          f"(torch.cuda.max_memory_allocated, the child's own); {smi}")
    kernel_ms = sum(r["kernel_ms"].values())
    print(f"sr full depth: steps {SR_FULL_PROFILED[0] + 1}-{SR_FULL_PROFILED[-1] + 1} under "
          f"torch.profiler: wall {r['prof_wall_ms']:.3f} ms a step, device busy "
          f"{100.0 * r['busy']:.1f}% of it; {kernel_ms:.3f} ms of kernels a step, "
          f"{100.0 * kernel_ms / step_ms:.1f}% of the unprofiled step; kernel time by kind "
          + ", ".join(
              f"{k} {v:.3f} ms/step ({r['kernel_launches'][k]} launches)"
              for k, v in r["kernel_ms"].items()))
    for ms, n, name in r["top"]:
        print(f"sr full depth: kernel {ms:.3f} ms/step ({n} launches/step) {name}")
    for name, (ms, n) in sorted(r["flash"].items()):
        print(f"sr full depth: flash kernel {name} {ms:.3f} ms/step ({n} launches/step)")
    want = [2 * L * S, L * S, L * S]
    print(f"sr full depth: flash launches (fwd, dq, dkv) {r['launches']} == {want} (96 / 48 / "
          f"48 a step with remat); plain-version calls {r['plain']}")
    _check(r["rc"] == 0 and r["iterations"] == [str(i + 1) for i in range(S)]
           and np.isfinite(r["lm"]).all() and r["skipped"] == 0,
           "the full-depth finetune's losses are not finite or a step skipped")
    _check(r["launches"] == want and r["plain"] == [0, 0, 0],
           "the full-depth finetune did not launch the flash kernels once per layer and step")
    return r["launches"], {"step_ms": step_ms, "peak_gib": r["peak_gib"], "busy": r["busy"]}


SR_SHAPE = (SR_FULL_BATCH, 40, 64, 1344)  # B, N, D, S of cogview-sr finetuning


def phase_flash_sr_shape(torch, fa):
    """K3, K4 and K5 at super-resolution finetuning's shape (bf16, sep 0,
    dropout 0.1 and none) against their plain versions, two launches
    bit-equal; their times, bounds and the SDPA yardsticks -> summary."""
    B, N, D, S = SR_SHAPE
    gen = torch.Generator(device="cuda").manual_seed(6)
    qkv = torch.randn((B, S, 3, N * D), generator=gen, device="cuda").to(torch.bfloat16)
    q, k, v = (qkv[:, :, i].reshape(B, S, N, D) for i in range(3))
    worst = 0.0
    for rate in (0.1, 0.0):
        kw = dict(dropout_rate=rate, dropout_seed=1234 if rate else None)
        o, lse = fa.flash_attention(q, k, v, 0, **kw)
        o2, lse2 = fa.flash_attention(q, k, v, 0, **kw)
        ro, rlse = fa.flash_attention_reference(q, k, v, 0, **kw)
        torch.cuda.synchronize()
        err, lerr = (o.float() - ro.float()).abs().max().item(), (lse - rlse).abs().max().item()
        same = torch.equal(o, o2) and torch.equal(lse, lse2)
        print(f"flash sr shape bf16 B={B} N={N} D={D} S={S} dropout={rate}: o max_abs_err "
              f"{err:.3e} (tol 2e-2), lse {lerr:.3e} (tol 1e-4); repeat bit-equal={same}")
        _check(err <= 2e-2 and lerr <= 1e-4 and same, f"K3 differs at the SR shape, dropout {rate}")
        worst = max(worst, err)
        del o, o2, ro, lse, lse2, rlse
    drop = dict(dropout_rate=0.1, dropout_seed=1234)
    fwd = {"ms": _device_time_us(torch, lambda: fa.flash_attention(q, k, v, 0, **drop)),
           "nodrop_ms": _device_time_us(torch, lambda: fa.flash_attention(q, k, v, 0)),
           "plain_ms": _device_time_us(torch, lambda: fa.flash_attention_reference(q, k, v, 0,
                                                                                   **drop))}
    fwd["library_ms"], fwd["library_causal_ms"] = _sdpa_time_us(torch, q, k, v, 0)
    fwd = {key: us / 1000.0 for key, us in fwd.items()}
    fwd["bound_ms"], fwd["bound_by"] = _flash_bound(B, N, D, S, 0, 2, "bf16")
    del qkv, q, k, v

    args, kw = _backward_inputs(torch, fa, torch.bfloat16, B, S, N, 0, 0.1, gen)
    rate, seed = kw["dropout_rate"], kw["dropout_seed"]
    dq, (dk, dv) = fa.flash_bwd_dq(*args, 0, **kw), fa.flash_bwd_dkv(*args, 0, **kw)
    dq2, (dk2, dv2) = fa.flash_bwd_dq(*args, 0, **kw), fa.flash_bwd_dkv(*args, 0, **kw)
    want = (fa.flash_bwd_dq_reference(*args, 0, rate, seed),
            *fa.flash_bwd_dkv_reference(*args, 0, rate, seed))
    torch.cuda.synchronize()
    same = torch.equal(dq, dq2) and torch.equal(dk, dk2) and torch.equal(dv, dv2)
    rel = [((g.float() - w.float()).abs().max() / w.float().abs().max()).item()
           for g, w in zip((dq, dk, dv), want)]
    print(f"flash sr shape backward bf16 dropout 0.1: dq, dk, dv max_abs_err / max "
          f"{['%.2e' % r for r in rel]} (tol 2e-2); repeat bit-equal={same}")
    _check(max(rel) <= 2e-2 and same, "K4/K5 differ at the SR shape")
    del dq, dk, dv, dq2, dk2, dv2, want
    bounds = _bwd_bounds(B, N, D, S)
    bwd = {}
    for name, fn, plain in (("dq", fa.flash_bwd_dq, fa.flash_bwd_dq_reference),
                            ("dkv", fa.flash_bwd_dkv, fa.flash_bwd_dkv_reference)):
        bwd[name] = {"ms": _device_time_us(torch, lambda: fn(*args, 0, **kw)) / 1000.0,
                     "nodrop_ms": _device_time_us(torch, lambda: fn(*args, 0)) / 1000.0,
                     "plain_ms": _device_time_us(torch, lambda: plain(*args, 0, rate,
                                                                      seed)) / 1000.0,
                     "bound_ms": bounds[name][0], "bound_by": bounds[name][1]}
    library = _sdpa_backward_us(torch, args)
    del args
    print(f"flash sr shape times bf16 B={B} N={N} S={S}: K3 {1000 * fwd['ms']:.1f} us with "
          f"dropout 0.1, {1000 * fwd['nodrop_ms']:.1f} without, plain "
          f"{1000 * fwd['plain_ms']:.1f}, SDPA boolean mask {1000 * fwd['library_ms']:.1f}, "
          f"is_causal {1000 * fwd['library_causal_ms']:.1f}, bound "
          f"{1000 * fwd['bound_ms']:.2f} us ({fwd['bound_by']}); " + "; ".join(
              f"{n} {1000 * b['ms']:.1f} us with dropout, {1000 * b['nodrop_ms']:.1f} without, "
              f"plain {1000 * b['plain_ms']:.1f}, bound {1000 * b['bound_ms']:.2f} us "
              f"({b['bound_by']})" for n, b in bwd.items())
          + f"; autograd.grad through SDPA boolean mask {library['boolean mask']:.1f} us, "
          f"is_causal {library['is_causal']:.1f} us (CUDA events, median of 25)")
    return {"max_abs_err": worst, "rel_err": max(rel), "fwd": fwd, "bwd": bwd,
            "library_ms": library["boolean mask"] / 1000.0,
            "library_causal_ms": library["is_causal"] / 1000.0}


ROUTE_STEPS = 6
ROUTE_BATCH = 1


def phase_other_routes(torch, fa, pretrain, work: str):
    """The memory, sparse and float16 routes through ``cli.pretrain.main`` at
    the tutorial preset (batch ROUTE_BATCH x 1,088, phase 14's corpus): the memory at
    512 positions, sparse attention at the reference's shipped 64 / 4 / 256,
    and float16 for 14 steps with --profile-dir; none launches a flash
    kernel (dense torch, as in the JAX package)."""
    import numpy as np

    common = ["--preset", "tutorial", "--device", "cuda", "--train-data",
              os.path.join(work, "tutorial_t2i.bin"), "--batch-size", str(ROUTE_BATCH), "--split",
              "1.0,0.0,0.0", "--log-interval", "1", "--lr", "1e-4", "--warmup", "0.0",
              "--seed", "1234"]
    prof_dir = os.path.join(work, "fp16_profile")
    routes = (("mems", "make_train_step", ["--max-memory-length", "512"], ROUTE_STEPS),
              ("sparse", "make_train_step", ["--is-sparse", "1", "--query-window", "64",
                                             "--key-window-times", "4", "--num-pivot", "256"],
               ROUTE_STEPS),
              # a scale of 2^16 that doubles after 4 good steps and halves on
              # an overflow: steps apply and the scale moves within 14 steps
              ("fp16", "make_fp16_train_step", ["--fp16", "--profile-dir", prof_dir,
                                                "--loss-scale-init", "65536",
                                                "--loss-scale-window", "4"], 14))
    for route, factory, flags, steps in routes:
        rec = {}
        restore = _recording_steps(torch, pretrain, factory, rec)
        _zero_flash_counts(fa)
        try:
            rc, out = _run_pretrain(pretrain, common + flags + ["--train-iters", str(steps)])
        finally:
            restore()
        launches, plain = _flash_counts(fa)
        lm = [m["lm_loss"] for m in rec["metrics"]]
        print(f"route {route}: {len(lm)} steps, lm loss {['%.4f' % v for v in lm]}, skipped "
              f"{sum(m['skipped'] for m in rec['metrics'])}, "
              f"{1000.0 * statistics.median(rec['step_s'][1:]):.3f} ms per step "
              f"(batch {ROUTE_BATCH}); "
              f"flash launches {launches}, plain-version calls {plain}")
        _check(rc == 0 and len(lm) == steps and np.isfinite(lm).all(),
               f"the {route} route's losses are not finite")
        _check(launches == [0, 0, 0] and plain == [0, 0, 0],
               f"the {route} route ran flash attention")
        if route == "mems":
            print(f"route mems: memory shapes {rec['mems'][:2]} ... {rec['mems'][-1]}")
            _check(rec["mems"] == [(13, ROUTE_BATCH, 512, 1024)] * steps,
                   "the memory did not reach 512 positions of the 13 hidden states")
        elif route == "sparse":
            _check(rec["kw"]["is_sparse"], "--is-sparse did not reach the step")
        else:
            scales = [m["loss_scale"] for m in rec["metrics"]]
            trace = os.path.join(prof_dir, "trace.json")
            with open(trace) as f:
                events = json.load(f)["traceEvents"]
            kernels = [e for e in events if e.get("cat") == "kernel"]
            span_ms = (max(e["ts"] + e["dur"] for e in kernels)
                       - min(e["ts"] for e in kernels)) / 1000.0 if kernels else 0.0
            steps_ms = 1000.0 * sum(rec["step_s"][9:13])
            print(f"route fp16: loss scale {scales}; {trace}: {len(kernels)} kernel events over "
                  f"{span_ms:.1f} ms of the {steps_ms:.1f} ms that steps 10-13 took")
            skipped = sum(m["skipped"] for m in rec["metrics"])
            _check(len(set(scales)) > 1 and skipped < steps,
                   "the float16 loss scale did not move, or every step was skipped")
            _check(f"profiler trace (steps 10-13) -> {trace}" in out and kernels
                   and span_ms >= 0.5 * steps_ms, "the profile does not cover steps 10-13")


# --------------------------------------------------------------------- #
# phases 23-25: preprocessing -> pretraining, VQ-VAE training, FID / IS
# --------------------------------------------------------------------- #

CORPUS_IMAGES = 64  # 256 x 320 images of phase 23's sources
SR_IMAGES = 4  # 512 x 640 images of its super-resolution task
VQ_ST_ITERS, VQ_GUMBEL_ITERS, VQ_BATCH = 40, 20, 32
INCEPTION_BATCH = 50


def _gradient_image(rng, h: int, w: int):
    """A smooth seeded image: per channel a sine over a random direction
    and phase, plus a soft blob (not noise, so the VQ-VAE has structure to
    learn)."""
    import numpy as np

    y, x = np.mgrid[0:h, 0:w].astype(np.float64)
    chans = []
    for _ in range(3):
        fx, fy, ph = rng.uniform(-2.5, 2.5), rng.uniform(-2.5, 2.5), rng.uniform(0, 6.3)
        cy, cx, r = rng.uniform(0, h), rng.uniform(0, w), rng.uniform(h / 8, h / 3)
        wave = np.sin(2 * np.pi * (fx * x / w + fy * y / h) + ph)
        blob = np.exp(-((y - cy) ** 2 + (x - cx) ** 2) / (2 * r * r))
        chans.append(127.5 + 90.0 * wave * (1 - 0.5 * blob) + 35.0 * blob)
    return np.clip(np.stack(chans, -1), 0, 255).astype(np.uint8)


def _write_image_sources(png, work: str, n: int, seed: int, h: int = 256, w: int = 320):
    """n smooth images as a folder of PNGs, a zip and a tar of the same
    files, and a caption TSV -> (folder, zip, tar, captions)."""
    import io
    import tarfile
    import zipfile

    import numpy as np

    rng = np.random.RandomState(seed)
    folder = os.path.join(work, f"images_{seed}")
    os.makedirs(folder)
    names = [f"img_{i:03d}.png" for i in range(n)]
    for name in names:
        png.write_png(os.path.join(folder, name), _gradient_image(rng, h, w))
    zp, tp = folder + ".zip", folder + ".tar"
    with zipfile.ZipFile(zp, "w") as z, tarfile.open(tp, "w") as t:
        for name in names:
            with open(os.path.join(folder, name), "rb") as f:
                data = f.read()
            z.writestr(name, data)
            info = tarfile.TarInfo(name)
            info.size = len(data)
            t.addfile(info, io.BytesIO(data))
    caps = folder + ".tsv"
    with open(caps, "w") as f:
        for i, name in enumerate(names):
            f.write(f"{name}\t" + " ".join(f"word{(i + k) % 50}" for k in range(6 + i % 7)) + "\n")
    return folder, zp, tp, caps


def _run_quiet(fn, *args, **kw):
    """fn(*args, **kw) with its standard output captured and printed ->
    (its return value, the output)."""
    import contextlib
    import io

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = fn(*args, **kw)
    print(out.getvalue(), end="")
    return rc, out.getvalue()


def phase_preprocess(torch, fa, vqvae, cfgmod, png, pretrain, work: str) -> list:
    """``cli.preprocess.main`` at the released VQ-VAE geometry: text2image
    from a folder, a zip and a tar of the same 64 images (the three .bin
    byte-equal, every row's codes those of the card's own img2code, in
    [0, 8192)), the bfloat16 encoder's codes beside them, super-resolution on 4
    images at 512, then 2 tutorial pretraining steps on the .bin -> the
    flash kernels' launches in those steps."""
    import re

    import numpy as np

    from cogview_tpu_torch.cli import preprocess
    from cogview_tpu_torch.data.datasets import IndexedDataset
    from cogview_tpu_torch.models import convert
    from cogview_tpu_torch.preprocess.raw_datasets import open_image_source
    from cogview_tpu_torch.tokenization import FakeImageTokenizer, UnifiedTokenizer

    folder, zp, tp, caps = _write_image_sources(png, work, CORPUS_IMAGES, seed=23)
    vq_path = os.path.join(work, "vqvae_released.pt")
    _write_vqvae_checkpoint(torch, vqvae, cfgmod, vq_path)
    rates, bins = {}, {}
    for kind, src in (("folder", folder), ("zip", zp), ("tar", tp)):
        out = os.path.join(work, f"t2i_{kind}.bin")
        rc, log = _run_quiet(preprocess.main, [
            "--task", "text2image", "--image-source", src, "--text-source", caps,
            "--img-tokenizer-path", vq_path, "--output", out, "--batch-size", "32",
            "--device", "cuda"], txt_tokenizer=WordTokenizer())
        _check(rc == 0, f"preprocess text2image on the {kind} source failed")
        rates[kind] = float(re.search(r"\(([\d.]+) images/s\)", log).group(1))
        with open(out, "rb") as f:
            bins[kind] = f.read()
    _check(bins["folder"] == bins["zip"] == bins["tar"],
           "the folder, zip and tar corpora differ")
    rows = np.frombuffer(bins["folder"], np.int32).reshape(-1, 64 + 1024)
    _check(rows.shape[0] == CORPUS_IMAGES, f"{rows.shape[0]} rows, not {CORPUS_IMAGES}")
    codes = rows[:, 64:]
    _check(((codes >= 0) & (codes < 8192)).all(), "a code outside [0, 8192)")
    params = convert.load_vqvae_checkpoint(vq_path, torch.device("cuda"))
    imgs = np.stack([a for _, a in open_image_source(folder, 256)])
    x = torch.from_numpy(imgs).cuda()
    own = torch.cat([vqvae.img2code(params, x[i:i + 32]) for i in range(0, len(x), 32)])
    _check(np.array_equal(own.cpu().numpy(), codes),
           "the corpus codes differ from the card's img2code on the same arrays")
    bf = torch.cat([vqvae.img2code(params, x[i:i + 32], dtype=torch.bfloat16)
                    for i in range(0, len(x), 32)])
    agree = float((bf.cpu().numpy() == codes).mean())
    # the encoder alone on the card, batch 32, float32 and bfloat16
    batch = x[:32]
    enc_us = {name: _device_time_us(torch, lambda d=dtype: vqvae.img2code(params, batch, dtype=d),
                                    reps=10)
              for name, dtype in (("float32", None), ("bfloat16", torch.bfloat16))}
    print(f"preprocess text2image: {CORPUS_IMAGES} images 256x320 -> {rows.shape[0]} rows, "
          f"folder/zip/tar byte-equal; images/s (CLI end to end, host decode included): "
          f"{', '.join(f'{k} {v:.1f}' for k, v in rates.items())}; VQ encode alone at batch 32: "
          f"float32 {enc_us['float32'] / 1000:.3f} ms ({32e6 / enc_us['float32']:.1f} images/s), "
          f"bfloat16 {enc_us['bfloat16'] / 1000:.3f} ms ({32e6 / enc_us['bfloat16']:.1f} "
          f"images/s); bfloat16 codes equal to float32's: {agree:.4f}")

    sr_folder, _, _, sr_caps = _write_image_sources(png, work, SR_IMAGES, seed=24, h=512, w=640)
    sr_out = os.path.join(work, "sr_rows")
    rc, _ = _run_quiet(preprocess.main, [
        "--task", "super-resolution", "--image-source", sr_folder, "--text-source", sr_caps,
        "--img-tokenizer-path", vq_path, "--output", sr_out, "--img-size", "512",
        "--sampling-num", "4", "--batch-size", "4", "--device", "cuda"],
        txt_tokenizer=WordTokenizer())
    tok = UnifiedTokenizer(img_tokenizer=FakeImageTokenizer(8192), txt_tokenizer=WordTokenizer())
    sr = IndexedDataset(sr_out)
    _check(rc == 0 and len(sr) == SR_IMAGES * 4, f"{len(sr)} super-resolution rows, not 16")
    for r in (np.asarray(sr[i]) for i in range(len(sr))):
        boi1, eoi1 = (int(np.nonzero(r == tok[t])[0][0]) for t in ("[BOI1]", "[EOI1]"))
        boi2 = int(np.nonzero(r == tok["[BOI2]"])[0][0])
        _check(r[0] == tok["[ROI1]"] and r[-1] == tok["[EOI2]"] and eoi1 - boi1 - 1 == 1024
               and len(r) - 2 - boi2 == 1024 and (r[boi1 + 1:eoi1] < 8192).all()
               and (r[boi2 + 1:-1] < 8192).all(), "a super-resolution row is malformed")
    print(f"preprocess super-resolution: {SR_IMAGES} images at 512 -> {len(sr)} rows of "
          f"{len(sr[0])} ids")

    rec = {}
    restore = _recording_steps(torch, pretrain, "make_train_step", rec)
    _zero_flash_counts(fa)
    try:
        rc, _ = _run_pretrain(pretrain, [
            "--preset", "tutorial", "--device", "cuda", "--train-data",
            os.path.join(work, "t2i_folder.bin"), "--batch-size", "8", "--split", "1.0,0.0,0.0",
            "--train-iters", "2", "--log-interval", "1", "--lr", "1e-4", "--warmup", "0.0",
            "--seed", "1234"])
    finally:
        restore()
    launches, plain = _flash_counts(fa)
    lm = [m["lm_loss"] for m in rec["metrics"]]
    print(f"pretrain on the preprocessed corpus: lm loss {['%.4f' % v for v in lm]}; "
          f"flash launches {launches}, plain-version calls {plain}")
    _check(rc == 0 and len(lm) == 2 and np.isfinite(lm).all(),
           "pretraining on the preprocessed corpus did not give finite losses")
    _check(min(launches) > 0 and plain == [0, 0, 0],
           "pretraining on the preprocessed corpus did not run the flash kernels")
    return launches


def phase_vqtrain(torch, work: str, smi: str) -> None:
    """``cli.vqtrain.main`` at the released geometry (channel 512, embed
    256, 8,192 codes, 256-pixel images, batch 32) on phase 23's images:
    VQ_ST_ITERS straight-through + EMA iterations (the recon MSE falls
    between the first and the last log, the codebook's cluster_size moves),
    then VQ_GUMBEL_ITERS with --gumbel --gumbel-hard; ms per iteration,
    images/s and peak memory."""
    import re

    import numpy as np

    from cogview_tpu_torch.cli import vqtrain
    from cogview_tpu_torch.training.checkpointing import load_latest

    folder = os.path.join(work, "images_23")
    save = os.path.join(work, "vqtrain_ckpt")
    results = {}
    for mode, iters, extra in (("st-ema", VQ_ST_ITERS, ["--save", save, "--save-interval",
                                                        str(VQ_ST_ITERS)]),
                               ("gumbel-hard", VQ_GUMBEL_ITERS, ["--gumbel", "--gumbel-hard"])):
        torch.cuda.reset_peak_memory_stats()
        rc, log = _run_quiet(vqtrain.main, [
            "--data", folder, "--batch-size", str(VQ_BATCH), "--train-iters", str(iters),
            "--log-interval", "10", "--device", "cuda", "--seed", "0", *extra])
        mse = [float(v) for v in re.findall(r"recon_mse (\S+)", log)]
        loss = [float(v) for v in re.findall(r"\bloss (\S+)", log)]
        _check(rc == 0 and len(mse) == iters // 10 and np.isfinite(mse + loss).all(),
               f"vqtrain {mode} did not log finite losses")
        results[mode] = dict(vqtrain.main.last, mse=mse)
    st = results["st-ema"]
    _check(st["mse"][-1] < st["mse"][0],
           f"the ST + EMA recon MSE did not fall: {st['mse']}")
    state = load_latest(save)
    moved = float((state["params"]["quantize"]["cluster_size"] != 0).float().mean())
    _check(state["step"] == VQ_ST_ITERS and moved > 0, "the EMA codebook's cluster_size did not move")
    for mode, r in results.items():
        print(f"vqtrain {mode} ({smi}): batch {VQ_BATCH} x 256^2, channel 512, 8192 codes: "
              f"{r['ms_per_iter']:.1f} ms/iter over the last 10 iterations (CUDA events), "
              f"{VQ_BATCH * 1000.0 / r['ms_per_iter']:.1f} images/s, peak {r['peak_gib']:.2f} GiB; "
              f"recon mse by log {['%.5f' % v for v in r['mse']]}")
    print(f"vqtrain st-ema: codes with a nonzero EMA cluster size {moved:.4f}")


def phase_fid(torch, png, work: str, smi: str) -> None:
    """``cli.fid.main`` on the card: the seeded random InceptionV3 gives
    FID(A, A) below 1e-3 and FID(A, B) > 0 for two distinct sets of 32
    smooth 160 x 200 images; --inception-score; a TSV of A's images gives
    A's statistics; --extractor vq with phase 23's VQ-VAE; then the
    extractor's images/s at batch 50, 299 x 299."""
    import base64

    import numpy as np

    from cogview_tpu_torch.cli import fid
    from cogview_tpu_torch.eval_utils import inception

    # 160 x 200 PNGs (resized to 256 by the CLI): a TSV row of one stays
    # under the csv module's 131,072-character field limit, which the JAX
    # package's stream shares
    a = _write_image_sources(png, work, 32, seed=25, h=160, w=200)[0]
    b = _write_image_sources(png, work, 32, seed=26, h=160, w=200)[0]
    tsv = os.path.join(work, "fid_a.tsv")
    with open(tsv, "w") as f:
        for n in sorted(os.listdir(a)):
            with open(os.path.join(a, n), "rb") as g:
                f.write(f"{n}\t_\tcaption\t{base64.urlsafe_b64encode(g.read()).decode()}\n")
    runs = {}
    for key, argv in (("aa", ["--path1", a, "--path2", a]),
                      ("ab", ["--path1", a, "--path2", b, "--inception-score", "--is-splits", "2"]),
                      ("tsv", ["--path1", tsv, "--path2", b]),
                      ("vq", ["--path1", a, "--path2", b, "--extractor", "vq",
                              "--img-tokenizer-path", os.path.join(work, "vqvae_released.pt")])):
        rc, _ = _run_quiet(fid.main, [*argv, "--batch-size", "16", "--device", "cuda"])
        _check(rc == 0, f"fid {key} failed")
        runs[key] = dict(fid.main.last)
    aa, ab, ts, vq = runs["aa"], runs["ab"], runs["tsv"], runs["vq"]
    _check(abs(aa["fid"]) < 1e-3, f"FID(A, A) = {aa['fid']}")
    _check(ab["fid"] > 0 and vq["fid"] > 0, f"FID(A, B) = {ab['fid']}, vq {vq['fid']}")
    _check(np.isfinite(ab["is_mean"]) and ab["is_mean"] >= 1.0 - 1e-6, "IS is not finite")
    mu_err = float(np.abs(ts["mu1"] - ab["mu1"]).max())
    sig_err = float(np.abs(ts["sigma1"] - ab["sigma1"]).max())
    _check(ts["n1"] == ab["n1"] == 32 and mu_err <= 1e-5 * float(np.abs(ab["mu1"]).max())
           and sig_err <= 1e-5 * float(np.abs(ab["sigma1"]).max()),
           f"the TSV's statistics differ from the folder's (mu {mu_err}, sigma {sig_err})")
    # the extractor alone: pool3 of a batch of 50 256-pixel images (the
    # resize to 299 inside), CUDA events
    model = inception.init_model(0, with_fc=False, device="cuda")
    x = torch.rand(INCEPTION_BATCH, 256, 256, 3, generator=torch.Generator(device="cuda")
                   .manual_seed(0), device="cuda")
    us = _device_time_us(torch, lambda: inception.pool3_features(model, x), reps=10)
    print(f"fid ({smi}): FID(A, A) {aa['fid']:.3e}, FID(A, B) {ab['fid']:.6f}, "
          f"IS(B) {ab['is_mean']:.6f} +/- {ab['is_std']:.6f}, vq-proxy FID(A, B) "
          f"{vq['fid']:.6f}; TSV vs folder statistics max |d mu| {mu_err:.3e}, "
          f"max |d sigma| {sig_err:.3e}; InceptionV3 pool3 at batch {INCEPTION_BATCH}, 299^2: "
          f"{us / 1000:.3f} ms ({INCEPTION_BATCH * 1e6 / us:.1f} images/s)")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        _fail("torch.cuda.is_available() is False: this script needs an NVIDIA GPU")
    try:
        from cogview_tpu_torch import config as cfgmod
        from cogview_tpu_torch import tokenization
        from cogview_tpu_torch.cli import generate as cli
        from cogview_tpu_torch.cli import pretrain, serve
        from cogview_tpu_torch.generation import magnify, sampling, scoring, tasks
        from cogview_tpu_torch.models import gpt, vqvae
        from cogview_tpu_torch.ops import _kernels
        from cogview_tpu_torch.ops import decode_attention as da
        from cogview_tpu_torch.ops import flash_attention as fa
        from cogview_tpu_torch.ops import probes
        from cogview_tpu_torch.ops.precision import set_fp32_precision
        from cogview_tpu_torch.scripts import decode_kernel_microbench as dkm
        from cogview_tpu_torch.scripts import launch_probe as lp
        from cogview_tpu_torch.scripts import seal_scatter_probe as ssp
        from cogview_tpu_torch.training import losses, optim
        from cogview_tpu_torch.training import train_loop as tl
        from cogview_tpu_torch.utils import png
    except ImportError as e:
        _fail(f"the port is not importable here ({e}); run from the repository root")
    t_start = time.perf_counter()

    def lap(what: str) -> None:  # where the time limit goes
        print(f"chip_smoke: {what} done at {time.perf_counter() - t_start:.1f} s")

    # phase 1: device
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip()
    print(smi.splitlines()[0])
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    set_fp32_precision()

    # phase 2: build the three libraries, one nvcc each, in parallel
    t0 = time.perf_counter()
    names = ("decode_attention", "flash_attention", "probes")
    sos = _kernels.build_all(names)
    for name in names:
        _kernels.lib(name)
    print(f"build: {', '.join(so.name for so in sos)} in {time.perf_counter() - t0:.2f} s")

    # phases 3-5: kernels against their plain versions
    k1 = phase_kernel(torch, da, packed=False)
    k2 = phase_kernel(torch, da, packed=True)
    _check_decode_kernels(sos[names.index("decode_attention")], da.HEAD_DIMS)
    k3 = phase_flash_kernel(torch, fa)
    k45 = phase_flash_backward(torch, fa)
    _check_tensor_core_kernels(sos[names.index("flash_attention")])
    lap("phases 3-5")
    # phase 6: the probes against their plain versions, then the three
    # measurement entry points
    probe_err = phase_probes(torch, probes, ssp)
    _check_async_copy(sos[names.index("probes")])
    _check_seal_stores(sos[names.index("probes")])
    entry, probe_launches = phase_probe_entry_points(torch, da, probes, lp, ssp, dkm)
    lap("phase 6")
    # phases 7-8: small input
    phase_small_input(torch, gpt, cfgmod, da, fa)
    phase_small_training(torch, cfgmod, fa, tl, optim)
    lap("phases 7-8")

    with tempfile.TemporaryDirectory() as work:
        # phase 12 first: the folder-watcher server, int4 cache, runs before
        # phase 9's profiled decode steps, whose tracing leaves a cost on
        # every later launch
        k2_launches = phase_serve_int4(torch, da, serve, tasks, sampling, png, work)
        lap("phase 12")
        # phase 9: text->image with int8 weights; its PNGs feed phases 15
        # (low-level SR) and 16 (super-resolution), which also run before
        # the profiled request; then the bf16-weight request (profiled),
        # whose PNGs feed 10, 11
        t2i = [phase_main_path(torch, da, gpt, cli, tasks, sampling, png, "int8", work)]
        lap("phase 9, int8 weights")
        llsr_launches = phase_low_level_sr(torch, da, cli, tasks, sampling, png, t2i[0][1], work)
        lap("phase 15")
        sr_launches = phase_super_resolution(torch, da, cfgmod, cli, gpt, magnify, sampling,
                                             png, t2i[0][1], work, smi.splitlines()[0])
        lap("phase 16")
        t2i.append(phase_main_path(torch, da, gpt, cli, tasks, sampling, png, "bfloat16", work))
        lap("phase 9, bf16 weights")
        png_dir = t2i[1][1]
        # phase 10: image->text; phase 11: post-selection; phase 13: fidelity
        i2t = phase_image2text(torch, da, fa, cli, tasks, sampling, png_dir, work)
        flash_launches = phase_post_selection(torch, fa, cli, tasks, scoring, png_dir, work)
        phase_cache_fidelity(torch, gpt, cfgmod, tasks, sampling, tokenization)
        lap("phases 10, 11, 13")
        # phase 17: the 48-layer float16 DeepSpeed file through --load in a
        # child process, one image->text request on phase 9's first PNG
        ckpt_launches = phase_checkpoint(torch, cfgmod, vqvae, png_dir, work,
                                         smi.splitlines()[0])
        lap("phase 17")
        # phase 14: pretraining at the tutorial width, then a resumed run;
        # phase 18: its checkpoint served through --load
        train_launches, _ = phase_pretrain(torch, fa, pretrain, losses, optim, work)
        lap("phase 14")
        tut_launches = phase_serve_pretrained(torch, da, cli, optim, tasks, sampling, png,
                                              work, smi.splitlines()[0])
        lap("phase 18")
        # phase 19: cogview-base -> cogview-sr finetuning at SR_LAYERS depth
        # (--load --finetune --dual-positions, then a resume); phase 20:
        # cogview-sr at full depth in a child process, on phase 19's rows
        sr_rows, ft_launches = phase_sr_finetune(torch, fa, pretrain, gpt, work)
        lap("phase 19")
        full_launches, _ = phase_sr_full_depth(torch, sr_rows, smi.splitlines()[0])
        lap("phase 20")
        # phase 21: K3, K4, K5 at the finetune's shape; phase 22: the memory,
        # sparse and float16 routes at the tutorial width
        k345_sr = phase_flash_sr_shape(torch, fa)
        lap("phase 21")
        phase_other_routes(torch, fa, pretrain, work)
        lap("phase 22")
        # phase 23: a corpus from images through the preprocess CLI, then
        # pretraining on it; phase 24: VQ-VAE training; phase 25: FID and IS
        pre_launches = phase_preprocess(torch, fa, vqvae, cfgmod, png, pretrain, work)
        lap("phase 23")
        phase_vqtrain(torch, work, smi.splitlines()[0])
        lap("phase 24")
        phase_fid(torch, png, work, smi.splitlines()[0])
        lap("phase 25")
    # the flash kernels' launches on the training paths: phases 14, 19, 20, 23
    train_launches = [a + b + c + d for a, b, c, d in zip(train_launches, ft_launches,
                                                          full_launches, pre_launches)]

    def decode_entry(name, summary, launches, err, kv):
        times = summary["times"]
        us_k, us_p, bound_ms, by = times[(4, "bfloat16", 600)]
        sweeps = [key for key, argv in SWEEPS if argv[1] == kv]
        # ms, plain_ms, bound_ms: bf16 q, B=4, index 600; index1031_* the
        # seal step mid-window; b40_*: B=40, index 600; splits_us: the
        # kernel at B=4 (index 600 and 1031) at 1..9 splits
        return {"name": name, "route": "cuda",
                "source": "cogview_tpu_torch/csrc/decode_attention.cu",
                "replaces": "cogview_tpu/ops/decode_attention.py:161", "launches": launches,
                "max_abs_err": err, "ms": us_k / 1000.0, "plain_ms": us_p / 1000.0,
                "bound_ms": bound_ms, "bound_by": by, "library_ms": None,
                "design": "split over windows, merged in one launch; cp.async double buffer; "
                          "D a template",
                "bound_share": bound_ms / (us_k / 1000.0),
                "index1031_ms": times[(4, "bfloat16", 1031)][0] / 1000.0,
                "index1031_bound_ms": times[(4, "bfloat16", 1031)][2],
                "b40_ms": times[(40, "bfloat16", 600)][0] / 1000.0,
                "b40_plain_ms": times[(40, "bfloat16", 600)][1] / 1000.0,
                "b40_bound_ms": times[(40, "bfloat16", 600)][2],
                "b40_bound_share": times[(40, "bfloat16", 600)][2]
                / (times[(40, "bfloat16", 600)][0] / 1000.0),
                # b1_*: B=1 over 11 windows (a super-resolution window's
                # cache, the plan's 11 splits), index 1300; b1_seal_*: the
                # seal step at index 1343
                "b1_ms": times[(1, "bfloat16", 1300)][0] / 1000.0,
                "b1_plain_ms": times[(1, "bfloat16", 1300)][1] / 1000.0,
                "b1_bound_ms": times[(1, "bfloat16", 1300)][2],
                "b1_bound_share": times[(1, "bfloat16", 1300)][2]
                / (times[(1, "bfloat16", 1300)][0] / 1000.0),
                "b1_seal_ms": times[(1, "bfloat16", 1343)][0] / 1000.0,
                "b1_seal_bound_ms": times[(1, "bfloat16", 1343)][2],
                "splits_us": summary["split_us"],
                # the window sweeps at batch 40, or 4 where the key ends in
                # b4 (decode_kernel_microbench):
                # launches are eager calls and graph captures, captured the
                # calls the captures recorded (they run nothing), replayed
                # the launches the graphs' replays ran; window_bound_share:
                # a window's bytes at 3.35 TB/s over the graph's slope
                **{f"{key}_{field}": value for key in sweeps for field, value in (
                    ("launches", probe_launches[key]),
                    ("captured", entry[key]["graph_captured"]),
                    ("replayed", entry[key]["graph_replayed"]),
                    ("max_abs_err", entry[key]["max_abs_err"]),
                    ("us", {col: {k: entry[key][col][k] for k in ("slope_us", "intercept_us")}
                            for col in ("eager", "graph")}),
                    ("window_bound_share", entry[key]["window_mb"] * 1e6 / HBM_BYTES_PER_S
                     * 1e6 / entry[key]["graph"]["slope_us"]))}}

    def probe_entry(name, fn, line, err, us, plain_us, library_us, bound, loop):
        # ms: per call of the kernel alone, many calls replayed from one CUDA
        # graph (one call between an event pair would time the ~5 us floor
        # of the method); eager_ms: per call of the entry point's loop issued
        # from Python; launches: eager calls and graph captures, captured:
        # the calls the captures recorded (they run nothing), replayed: the
        # launches the graphs' replays ran
        return {"name": name, "route": "cuda", "source": "cogview_tpu_torch/csrc/probes.cu",
                "replaces": line, "launches": probe_launches[fn], "max_abs_err": err,
                "ms": us / 1000.0, "plain_ms": plain_us / 1000.0, "bound_ms": bound[0],
                "bound_by": bound[1],
                "library_ms": None if library_us is None else library_us / 1000.0,
                "eager_ms": loop["eager_us"] / 1000.0, "captured": loop["graph_captured"],
                "replayed": loop["graph_replayed"],
                # the kernel's own time per launch, torch.profiler over graph
                # replays (null when the profiler saw no launch of it)
                "device_us": loop["device_us"]}

    lpr, ssr = entry["launch_probe"], entry["seal_scatter_probe"]
    L, NW, B, N, D, W = lp.CONVENTION_SHAPE
    # P1b: the window rows and their scales copied, q read, ctx written
    p1b_bytes = 2 * 2 * N * D * W + 2 * 2 * N * W * 4 + 2 * B * N * D * 2
    # P2: qc, oh and lane0 read, out written; G products for each of the G
    # lanes of the group
    p2_bytes = (ssp.G * ssp.HB * ssp.DC * 4 + ssp.G * ssp.W * 4 + 4
                + ssp.HB * ssp.DC * ssp.W)
    probe_rows = [
        probe_entry("probe_add_one", "add_one", "scripts/pallas_launch_probe.py:51",
                    probe_err["add_one"], lpr["tiny"]["graph_us"],
                    # the plain version is x + 1.0, the library call itself
                    lpr["torch_add"]["graph_us"], lpr["torch_add"]["graph_us"],
                    _bound(2 * 8 * 128 * 4, 8 * 128, "f32"), lpr["tiny"]),
        probe_entry("probe_decode_convention", "decode_convention",
                    "scripts/pallas_launch_probe.py:73", lpr["convention"]["max_abs_err"],
                    lpr["convention"]["graph_us"], lpr["convention"]["plain_graph_us"], None,
                    _bound(p1b_bytes, B * N * D, "f32"), lpr["convention"]),
        probe_entry("probe_seal_scatter", "seal_scatter", "scripts/seal_scatter_probe.py:49",
                    probe_err["seal_scatter"], ssr["kernel_graph_us"], ssr["plain_graph_us"],
                    None, _bound(p2_bytes, 2 * ssp.HB * ssp.DC * ssp.G * ssp.G, "f32"), ssr),
    ]

    # P1a beside torch.add, P1b beside its bound, per call from a graph and
    # per launch on the device
    p1a, p1b = probe_rows[0], probe_rows[1]
    add = lpr["torch_add"]

    def us(v):
        return "not measured" if v is None else f"{v:.3f} us"

    print(f"probe P1a [8,128]: {p1a['ms'] * 1e3:.3f} us/call in a graph, torch.add "
          f"{add['graph_us']:.3f}; eager {p1a['eager_ms'] * 1e3:.2f} us/call, torch.add "
          f"{add['eager_us']:.2f}; device {us(p1a['device_us'])} a launch, torch.add "
          f"{us(add['device_us'])}; bound {p1a['bound_ms'] * 1e3:.4f} us")
    share_dev = (None if p1b["device_us"] is None
                 else f"{p1b['bound_ms'] * 1e3 / p1b['device_us']:.3f}")
    print(f"probe P1b B={B} N={N} D={D}: {p1b['ms'] * 1e3:.3f} us/call in a graph (bound share "
          f"{p1b['bound_ms'] / p1b['ms']:.3f}), device {us(p1b['device_us'])} a launch (bound "
          f"share {share_dev}), plain {p1b['plain_ms'] * 1e3:.3f} us/call; bound "
          f"{p1b['bound_ms'] * 1e3:.3f} us ({p1b_bytes / 1e6:.2f} MB)")
    # P2: its bound share on the graph time and on the device time
    p2 = probe_rows[2]
    p2.update(design="a thread per 16 output bytes; oh by cp.async, lane0 and qc loaded "
                     "together; masked in registers",
              bound_share=p2["bound_ms"] / p2["ms"],
              device_bound_share=(None if p2["device_us"] is None
                                  else p2["bound_ms"] * 1e3 / p2["device_us"]))
    share_dev = (None if p2["device_bound_share"] is None
                 else f"{p2['device_bound_share']:.3f}")
    print(f"probe P2 [40,64,128]: {p2['ms'] * 1e3:.3f} us/call in a graph (bound share "
          f"{p2['bound_share']:.3f}), device {us(p2['device_us'])} a launch (bound share "
          f"{share_dev}), plain {p2['plain_ms'] * 1e3:.3f} us/call; bound "
          f"{p2['bound_ms'] * 1e3:.4f} us ({p2_bytes / 1e3:.0f} KB)")

    fk, fp, fl, fc, fbound, fby = k3["times"]["bfloat16"]
    tdrop, tnodrop, tl_, tc, tbound, _ = k3["times"]["train"]
    kernels = [
        {**decode_entry("decode_attention_int8", k1,
                        sum(n for n, _, _ in t2i) + i2t + llsr_launches + sr_launches
                        + ckpt_launches + tut_launches,
                        k1["max_abs_err"], "int8"),
         # device ms of K1 per decode step of the bf16-weight request
         # (torch.profiler over PROFILED_STEPS)
         "step_ms": t2i[1][2]["k1_ms"]},
        decode_entry("decode_attention_int4", k2, k2_launches, k2["max_abs_err"], "int4"),
        # ms, plain_ms, library_ms and bound_ms at post-selection's shape
        # (B=4, N=40, S=1058); train_* at the tutorial's training shape
        # (B=16, N=16, S=1088), train_ms with dropout 0.1 as the train step
        {"name": "flash_attention_fwd", "route": "cuda",
         "source": "cogview_tpu_torch/csrc/flash_attention.cu",
         "replaces": "cogview_tpu/ops/flash_attention.py:163",
         "launches": flash_launches + train_launches[0], "max_abs_err": k3["max_abs_err"],
         "ms": fk / 1000.0, "plain_ms": fp / 1000.0, "bound_ms": fbound, "bound_by": fby,
         "library_ms": fl / 1000.0, "library_causal_ms": fc / 1000.0, "design": "wgmma",
         "bound_share": fbound / (fk / 1000.0), "train_ms": tdrop / 1000.0,
         "train_nodrop_ms": tnodrop / 1000.0, "train_bound_ms": tbound,
         "train_library_ms": tl_ / 1000.0, "train_library_causal_ms": tc / 1000.0,
         # sr_*: super-resolution finetuning's shape (B=2, N=40, S=1344),
         # sr_ms with dropout 0.1 as the train step (phase 21)
         **{f"sr_{key}": value for key, value in k345_sr["fwd"].items()},
         "sr_max_abs_err": k345_sr["max_abs_err"]},
    ] + [{
        "name": f"flash_attention_bwd_{name}",
        "route": "cuda",
        "source": "cogview_tpu_torch/csrc/flash_attention.cu",
        "replaces": f"cogview_tpu/ops/flash_attention.py:{line}",
        "launches": n,
        "max_abs_err": k45["max_abs_err"],
        "ms": k45["times"][name][0] / 1000.0,
        "plain_ms": k45["times"][name][1] / 1000.0,
        "bound_ms": k45["bounds"][name][0],
        "bound_by": k45["bounds"][name][1],
        # one autograd.grad through SDPA without dropout computes dq, dk and
        # dv together: hold it against the sum of both entries' nodrop_ms,
        # not against one entry's ms (timed with dropout 0.1)
        "library_ms": k45["library_us"] / 1000.0,
        "library_covers": "dq+dkv",
        "library_causal_ms": k45["library_causal_us"] / 1000.0,
        "nodrop_ms": k45["nodrop_us"][i] / 1000.0,
        "design": "wgmma",
        "bound_share": k45["bounds"][name][0] / (k45["times"][name][0] / 1000.0),
        # sr_*: super-resolution finetuning's shape, with dropout 0.1 (sr_ms)
        # and without; sr_library_ms covers dq + dk/dv, as library_ms does
        **{f"sr_{key}": value for key, value in k345_sr["bwd"][name].items()},
        "sr_library_ms": k345_sr["library_ms"],
        "sr_library_causal_ms": k345_sr["library_causal_ms"],
        "sr_rel_err": k345_sr["rel_err"],
    } for i, (name, line, n) in enumerate((("dq", 212, train_launches[1]),
                                           ("dkv", 249, train_launches[2])))] + probe_rows
    print(f"chip_smoke: all phases passed in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--checkpoint-child"]:
        sys.exit(checkpoint_child(sys.argv[2]))
    if sys.argv[1:2] == ["--write-checkpoint"]:
        sys.exit(write_checkpoint_child(sys.argv[2]))
    if sys.argv[1:2] == ["--sr-train-child"]:
        sys.exit(sr_train_child(sys.argv[2]))
    sys.exit(main())
