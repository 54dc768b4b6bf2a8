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
   58,240), depth cut to SR_LAYERS, int8 cache, batch 1, on the same PNG:
   nine magnify windows, 4,096 codes in [0, 8192), a finite 512 x 512
   image in sr-0.png, K1 launched once per decode step and layer.
   Phases 15 and 16 run between the int8- and the bf16-weight text->image
   requests.

The next-to-last line is the kernels' JSON record (each kernel's launches
on the main path, error, time, plain version's time, bound and library
time), the last line ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import math
import os
import re
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
    B, S, N, D = 16, 1088, 16, 64
    pairs = _attn_pairs(S, 0) * B * N
    io = B * S * N * D * 2  # one bf16 [B, S, N, D] tensor
    bounds = {"dq": _bound(5 * io + 2 * B * N * S * 4, 6 * D * pairs, "bf16"),
              "dkv": _bound(6 * io + 2 * B * N * S * 4, 8 * D * pairs, "bf16")}
    for name, (us_k, us_p) in times.items():
        print(f"flash backward {name} time bf16 B=16 N=16 S=1088 dropout 0.1: kernel "
              f"{us_k:.1f} us/call, plain {us_p:.1f} us/call (CUDA events, median of 25); "
              f"bound {1000.0 * bounds[name][0]:.2f} us ({bounds[name][1]})")
    del args

    # the yardsticks: one torch.autograd.grad through SDPA on the same inputs
    # without dropout, with the boolean mask and with is_causal (the same
    # function at sep 0), against dq + dk/dv without dropout
    import torch.nn.functional as F

    args, kw = _backward_inputs(torch, fa, torch.bfloat16, 16, 1088, 16, 0, 0.0, gen)
    nodrop = [_device_time_us(torch, lambda: fa.flash_bwd_dq(*args, 0)),
              _device_time_us(torch, lambda: fa.flash_bwd_dkv(*args, 0))]
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
    shares = [bounds[k][0] * 1000.0 / us for k, us in zip(("dq", "dkv"), nodrop)]
    print(f"flash backward without dropout, bf16 B=16 N=16 S=1088: dq {nodrop[0]:.1f} + dk/dv "
          f"{nodrop[1]:.1f} = {sum(nodrop):.1f} us/call (bound shares {shares[0]:.3f}, "
          f"{shares[1]:.3f}); torch.autograd.grad through scaled_dot_product_attention with the "
          f"boolean mask {library['boolean mask']:.1f} us/call, with is_causal "
          f"{library['is_causal']:.1f} us/call (CUDA events, median of 25); kernels / boolean-mask "
          f"call = {sum(nodrop) / library['boolean mask']:.3f}")
    del args, qt, kt, vt
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


def phase_super_resolution(torch, da, cfgmod, cli, magnify, sampling, png, png_dir: str,
                           work: str):
    """Super-resolution through the CLI with ``--preset cogview-sr`` at its
    published widths (hidden 2560, 40 heads, 1,345 positions, the full
    vocabulary), depth cut to SR_LAYERS, int8 cache, batch 1, on the prompt
    and the first PNG of the int8-weight text->image request: nine magnify
    windows -> K1 launches."""
    import numpy as np

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

    argv = ["--preset", "cogview-sr", "--dtype", "bfloat16", "--weights", "bfloat16",
            "--kv-cache", "int8", "--top_k", "200", "--seed", "1234", "--device", "cuda",
            "--generation-task", "super-resolution", "--input-source", query,
            "--output-path", out_dir]
    da.decode_attention_quant.launches = 0
    da.decode_attention_quant.launches_int4 = 0
    da.decode_attention_quant_reference.calls = 0
    cli.super_resolution, magnify.filling_sequence = timed_sr, counted_fill
    cli.PRESETS["cogview-sr"] = lambda: cfgmod.cogview_sr(num_layers=SR_LAYERS)
    try:
        rc = cli.main(argv, txt_tokenizer=WordTokenizer())
    finally:
        cli.super_resolution, magnify.filling_sequence = orig_sr, orig_fill
        cli.PRESETS["cogview-sr"] = orig_preset
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
          f"the windows' prefills included)")
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


def _device_busy(torch, prof, wall_s: float):
    """(device kernel seconds by category, busy share, the 8 longest
    kernels, the flash kernels' (seconds, launches) by instantiation) of a
    profile."""
    cats = {"flash kernels": 0.0, "matmuls": 0.0, "elementwise": 0.0, "reductions": 0.0,
            "copies / casts": 0.0, "other": 0.0}
    top, flash = [], {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        if us <= 0 or e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        top.append((us / 1e6, e.count, e.key[:90]))
        name = e.key.lower()
        if "flash" in name:
            cat = "flash kernels"
            short = re.search(r"flash_\w+<[^>]*>", e.key)
            flash[short.group(0) if short else e.key[:90]] = (us / 1e6, e.count)
        elif any(t in name for t in ("gemm", "cutlass", "xmma", "nvjet", "sm90")):
            cat = "matmuls"
        elif "reduce" in name or "norm" in name or "softmax" in name:
            cat = "reductions"
        elif "copy" in name or "memcpy" in name or "memset" in name or "cast" in name:
            cat = "copies / casts"
        elif "elementwise" in name or "vectorized" in name or "unrolled" in name:
            cat = "elementwise"
        else:
            cat = "other"
        cats[cat] += us / 1e6
    return cats, sum(cats.values()) / wall_s, sorted(top, reverse=True)[:8], flash


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
    cats, busy, top, flash = _device_busy(torch, rec["prof"], rec["prof_wall"])
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
    iters = [ln.split("/")[0].split()[-1] for ln in lines if ln.startswith(" iteration")]
    print(f"pretrain resume: loaded at iteration {PRETRAIN_STEPS}: {resumed}; iterations run "
          f"{iters}")
    _check(rc == 0 and resumed and iters == [str(PRETRAIN_STEPS + 1), str(PRETRAIN_STEPS + 2)],
           "the --load run did not resume at the saved iteration")
    return launches, {"step_ms": step_ms, "busy": busy}


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
        from cogview_tpu_torch.models import gpt
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
    # phase 6: the probes against their plain versions, then the three
    # measurement entry points
    probe_err = phase_probes(torch, probes, ssp)
    _check_async_copy(sos[names.index("probes")])
    _check_seal_stores(sos[names.index("probes")])
    entry, probe_launches = phase_probe_entry_points(torch, da, probes, lp, ssp, dkm)
    # phases 7-8: small input
    phase_small_input(torch, gpt, cfgmod, da, fa)
    phase_small_training(torch, cfgmod, fa, tl, optim)

    with tempfile.TemporaryDirectory() as work:
        # phase 12 first: the folder-watcher server, int4 cache, runs before
        # phase 9's profiled decode steps, whose tracing leaves a cost on
        # every later launch
        k2_launches = phase_serve_int4(torch, da, serve, tasks, sampling, png, work)
        # phase 9: text->image with int8 weights; its PNGs feed phases 15
        # (low-level SR) and 16 (super-resolution), which also run before
        # the profiled request; then the bf16-weight request (profiled),
        # whose PNGs feed 10, 11
        t2i = [phase_main_path(torch, da, gpt, cli, tasks, sampling, png, "int8", work)]
        llsr_launches = phase_low_level_sr(torch, da, cli, tasks, sampling, png, t2i[0][1], work)
        sr_launches = phase_super_resolution(torch, da, cfgmod, cli, magnify, sampling, png,
                                             t2i[0][1], work)
        t2i.append(phase_main_path(torch, da, gpt, cli, tasks, sampling, png, "bfloat16", work))
        png_dir = t2i[1][1]
        # phase 10: image->text; phase 11: post-selection; phase 13: fidelity
        i2t = phase_image2text(torch, da, fa, cli, tasks, sampling, png_dir, work)
        flash_launches = phase_post_selection(torch, fa, cli, tasks, scoring, png_dir, work)
        phase_cache_fidelity(torch, gpt, cfgmod, tasks, sampling, tokenization)
        # phase 14: pretraining at the tutorial width, then a resumed run
        train_launches, _ = phase_pretrain(torch, fa, pretrain, losses, optim, work)

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
                        sum(n for n, _, _ in t2i) + i2t + llsr_launches + sr_launches,
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
         "train_library_ms": tl_ / 1000.0, "train_library_causal_ms": tc / 1000.0},
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
    } for i, (name, line, n) in enumerate((("dq", 212, train_launches[1]),
                                           ("dkv", 249, train_launches[2])))] + probe_rows
    print(f"chip_smoke: all phases passed in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
