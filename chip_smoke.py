#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each prints its lines; any failure exits non-zero and prints no
result):

1. device: require CUDA, print the card's name and power limit, turn TF32 off;
2. build: compile the seven kernel sources from cogview_tpu_torch/csrc/ with
   nvcc, one process per source, in parallel (the flash kernels' tile
   widths in five libraries, ``ops/flash_attention.py::LIBRARIES``);
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
   Then the SASS of all 48 decode instantiations (6 tile widths, each
   exact and not) holds LDGSTS (cp.async), their registers are printed,
   and at D=64 they spill nothing;
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
   kernels (26 each: the exact library's 4 tile widths and the other
   libraries' 9, with and without dropout) holds HGMMA (wgmma) and LDGSTS
   (cp.async), their registers and spills are printed, and at D=64 they
   spill nothing;
5b. head dims: K1 and K2 (B=2, N=4, 3 windows, indices 135 and 300, f32
   and bf16 q) and K3, K4, K5 (B=2, N=4, S=200, sep 40 on fused-QKV views,
   f32 and bf16, dropout 0 and 0.1, and with dropout on a shard with its
   batch and head offsets) against their plain versions at
   HEAD_DIMS_CHECKED and at the odd D = 33 (K2 refuses it with its plain
   version's message), with phases 3-5's tolerances, two launches
   bit-equal; D = 264 refused by name; all five at D = 100, 128 and 256
   (HEAD_DIM_TIMED: K3-K5 at the pretraining shape B=2, N=32, S=1,088
   at D = 100; K1/K2 at batch 4, index 600 and 1031) and K1/K2 at
   text->image's batch 1, 32 heads, index 1031 and 1087 held against their
   plain versions on the inputs they are then timed on, beside their plain
   versions, bounds and SDPA; then
   D = 100 through the entry points: ``cli.pretrain --preset tutorial``
   at 2 layers, hidden 3,200, 32 heads, 2 steps at batch 2 x 1,088 (the
   first batch's loss after the steps below its loss before, K3-K5
   launched, no plain call) and one text->image request at that width and
   depth through ``cli.generate`` (``generation.tasks``), batch 1, on the
   int8 cache (K1 once per step and layer) and the int4 cache (K2): the
   1,024 codes' checksum and the request's seconds;
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
   (random weights from a seed), int8 KV cache, batch 4, one request of 30
   words, first with int8 weights at CUT_LAYERS layers, then with bf16
   weights at MAIN_LAYERS layers.
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
12. serve: ``cogview_tpu_torch.cli.serve.main`` at cogview-base width, depth
   cut to CUT_LAYERS, with the int4 cache, bf16
   weights, batch 4, one query file of the 30-word prompt: the file reaches
   done/ and failed/ stays empty, four PNGs, ids in [0, 8192), 1024 x
   CUT_LAYERS K2 launches, no K1 launch and no plain call;
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
15. low-level super-resolution: the CLI at cogview-base widths, depth cut
   to CUT_LAYERS, int8 cache, batch 4, on the
   prompt and the int8-weight request's first PNG read at 128 pixels (the
   bilinear resize): 256 context codes, 4 x 1024 ids in [0, 8192), four
   finite PNGs, 1024 x CUT_LAYERS K1 launches;
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
   tokens per second, peak memory, and the last step under torch.profiler
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
23b. image formats on the card's host, without Pillow: one lossless
   file of each newly read format written here from a seeded 192 x 240
   picture by the script's own writers (TGA raw and RLE, PCX, SGI RLE,
   DIB, ICO holding a BMP and one holding a PNG, PSD raw and PackBits,
   uncompressed DDS, gray PFM), named .jpg and .png as a crawl mislabels
   files: each decodes to its source array (``decode_image``'s host ms
   printed per format), and ``cli.preprocess --task text2image --device
   cuda`` over the folder writes as many rows as files, skips none, and
   every row's codes equal the card's img2code of the source arrays (this
   path launches no kernel of the port: the VQ-VAE encoder's convolutions
   are PyTorch's);
23c. damaged files on the card's host: a seeded 96 x 128 picture as a
   baseline JPEG, as one with a restart marker every 2 MCUs and as a GIF,
   written by the script's own writers, then damaged (bytes overwritten
   from seeds, and one edit each for a marker inside the scan data, a lost
   or forged restart marker, a lost end of image, GIF sub-blocks zeroed,
   lengthened or cut): each of the 24 ends as the script's table of
   Pillow's outcomes says (skipped, or the SHA-256 of the array read),
   ``decode_image``'s host ms printed per file, and ``cli.preprocess
   --task text2image --device cuda`` over the folder writes a row for each
   file the table reads, skips the rest, and every row's codes equal the
   card's img2code of the arrays read;
23d. TIFF files on the card's host: the same picture written by the
   script's own writers as 14 TIFFs named .jpg and .png (BigTIFF, 4-bit
   and 16-bit gray, FillOrder 2, 16-bit RGB big-endian, floating point with
   predictor 3, Group 3 2-D and Group 4 fax, JPEG strips in YCbCr 2 x 2,
   JPEG in RGB, JPEG tiles past the image's edges, LZMA, and two damaged
   directories): each ends as ``TIFF_OUTCOMES`` (Pillow's outcomes) says,
   ``decode_image``'s host ms printed per file, and the folder through
   ``cli.preprocess`` as in 23c;
23e. TIFF codecs on the card's host: the same picture as Zstandard (from
   constants made with Pillow's libzstd; with predictor 2 as well),
   ThunderScan, YCbCr LZW at 2 x 2 and 4 x 2 and YCbCr JPEG in planes
   (libtiff's RGBA interface), CIELab under LZW, old-style JPEG with its
   header in JPEGInterchangeFormat and with its tables in tags, in three
   planes and in tiles side by side, and an LZMA strip whose check is
   damaged after its data: each ends as ``TIFF_CODEC_OUTCOMES`` says and the
   folder goes through ``cli.preprocess`` as in 23c; then a 2048 x 1536
   progressive JPEG from the script's writer is decoded in a child
   process, whose peak host RSS growth must stay within
   ``JPEG_BYTES_PER_PIXEL`` bytes a declared pixel;
23f. the rarer formats on the card's host: the same kind of picture as
   FLI and FLC (every chunk type of a first frame), IPTC raw and holding a
   JPEG, Kodak PhotoCD upright and rotated, DDS in BC6H unsigned and
   signed, PSD in Lab, IM in YCC and at 12 bits a sample, BLP1 holding a
   YCCK JPEG (read as CMYK), and two damaged files (an FLI run past its
   row, a PCD cut short), all by the script's own writers: each ends as
   ``RARE_OUTCOMES`` (Pillow's outcomes) says, ``decode_image``'s host ms
   printed per file, and the folder through ``cli.preprocess`` as in 23c;
24. VQ-VAE training: ``cli.vqtrain.main`` at the released geometry, batch
   32 x 256^2 on phase 23's images, 20 straight-through + EMA iterations
   (the recon MSE at the last log below the first, the codebook's
   cluster_size moved) and 10 with --gumbel --gumbel-hard; ms per
   iteration (CUDA events), images/s and peak memory of each;
25. FID and IS: ``cli.fid.main`` with the seeded random InceptionV3 on the
   card: FID(A, A) below 1e-3, between a TSV of A's images and A's folder
   (whose statistics agree to 1e-5), and FID(A, B) > 0 for two sets of 32
   smooth 160 x 200 PNGs, --inception-score, --extractor vq on phase 23's
   VQ-VAE;
   then pool3 alone at batch 50, 299 x 299 (images/s);
26. native host runtimes: ``g++`` builds csrc/spm and csrc/dataio into the
   build directory; on a SentencePiece BPE model written here (2,248
   pieces of every type), the native runtime, which ``make_text_tokenizer``
   picks, gives the pure-Python runtime's ids over 4,000 captions, its
   decodes and piece lookups, each one's encode rate printed; native
   ``dataio`` batches equal the Python loader's rows of phase 23's corpus;
27. K3, K4 and K5 of a shard: at the tutorial's training shape (B=16,
   N=16, S=1,088, dropout 0.1), rows 8-15 and heads 8-15 with their batch
   and head offsets, float32 and bf16: within tolerance of the plain
   versions with the same offsets and bit-equal to the block of the
   unsharded kernels' o, lse, dq, dk and dv (so the shard's keep mask is
   the block of the unsharded one), the forward's time with and without
   the offsets;
28. two ranks on the one card (``parallel/spawn.run_ranks``; the ranks of
   phases 28-30 run in one spawn for each world size, 1, 2 and 4, each
   function of RANK_RUNS after the other): a one-rank
   NCCL group checks its collectives on CUDA tensors and computes the
   references; then two gloo ranks (NCCL refuses two ranks on one device)
   report which collectives gloo took on CUDA tensors and which went
   through host memory, run 2 tutorial train steps (batch 4 x 1,088,
   dropout 0.1, the flash kernels) at (dp, mp, fsdp) = (2, 1, no), (1, 2,
   no) and (2, 1, yes) against the one-rank run (losses, grad norms, every
   param), and cogview-base (48 layers, hidden 2560, 40 heads) at TP=2,
   20 heads a rank: a 64-token prefill and 16 decode steps on the int8
   (K1) and int4 (K2) caches against the one-rank logits (max |diff|,
   argmax agreement, ids under fixed gumbel draws); step times only under
   the label "two ranks share one card"; then the dry run's six passes on
   four ranks;
29. ring attention and GPipe, two ranks on the one card the same way: a
   one-rank NCCL group times K3 at the ring's global shape and computes
   the references, then two gloo ranks report the ``comm.ppermute`` route
   gloo takes on CUDA tensors (an all-gather: its send/recv aborts on
   them) and check one shift and its backward; ring attention at
   cogview-base widths (B=2, S=1,088, N=40, D=64, bf16, seq 2, sep 0 and
   64, dropout 0 and 0.1) against dense attention on the whole sequence
   (o, dq, dk, dv, and the 2 x 2 blocks' keep masks equal to the dense
   mask), and its forward's time; 2 SP = 2 train steps of cogview-base at
   SP_LAYERS (4) layers, float32, dropout 0.1, against one rank on the
   dense route; 2 PP = 2 train steps at the full 48 layers, float32, 2
   microbatches, dropout 0, against one rank (each rank's K3/K4/K5
   launches, no plain version, its peak memory), then a bf16 step with
   dropout 0.1; losses, grad norms and strided samples of every param and
   Adam moment against the one-rank run; one SP = 2 step at SP_LAYERS
   with ``max_memory_length`` SP_MEM and a seeded memory, whose layers
   attend over the sequence gathered over 'seq', against one rank (also
   the new memory); then ``dryrun_multichip(8)``, its six passes, on the
   card;
30. the data axis of the last slice, ranks sharing the card the same way:
   the VQ-VAE step at the released geometry (channel 512, embed 256,
   8,192 codes, global batch 8 x 256^2, float32, TF32 off) on two gloo
   ranks against one rank alone, 2 ST + EMA steps and a gumbel-hard step
   (each rank its rows of one global gumbel draw): losses, sampled
   encoder/decoder params and the EMA buffers within VQ_DP_TOL, ms a step
   of each; then the data 2 x pipe 2 train step (tutorial width, 4 layers,
   batch 8 x 1,088, float32, every dropout at 0.1, 2 microbatches, each
   data rank its shard of each microbatch) on four gloo ranks against data
   1 x pipe 2 on two: losses and sampled params within PP_DP_TOL, each
   rank's K3/K4/K5 launches.
30b. the same step at one row a microbatch (batch 2 in 2 microbatches): on
   a data axis of 2 the first data rank holds empty shards of both
   microbatches, as GSPMD pads them, and runs its layers on no rows (no
   flash launch there); four gloo ranks against data 1 x pipe 2 on two,
   within PP_DP_TOL.

The next-to-last line is the kernels' JSON record (each kernel's launches
on the main path, error, time, plain version's time, bound and library
time), the last line ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
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


def _live_children() -> list:
    """The command lines of this process's children that are still running
    (zombies left out): the script must stop every process it starts."""
    pids = []
    for task in os.listdir("/proc/self/task"):
        with open(f"/proc/self/task/{task}/children") as f:
            pids += f.read().split()
    alive = []
    for pid in pids:
        try:
            with open(f"/proc/{pid}/stat") as f:
                if f.read().rsplit(")", 1)[1].split()[0] == "Z":
                    continue
            with open(f"/proc/{pid}/cmdline", "rb") as f:
                alive.append(f"{pid}: {f.read().replace(bytes(1), b' ').decode()[:200]}")
        except FileNotFoundError:
            continue
    return alive


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
    events behind a queued sleep (``scripts/_timing.py::median_device_us``,
    the timer of the port's measurement scripts)."""
    from cogview_tpu_torch.scripts._timing import median_device_us

    return median_device_us(fn, reps)


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


# ---------------------------------------------------------------------------
# phase 5b: the head dims past {16, 32, 64, 128}
# ---------------------------------------------------------------------------

# the head dims phase 5b holds every kernel to beside D = 64: tile widths
# (8, 96, 160, 192, 256) and dims between them (24, 40, 72, 80, 100, 112),
# and an odd one (33), which the int4 cache cannot hold
HEAD_DIMS_CHECKED = (8, 24, 40, 72, 80, 96, 100, 112, 160, 192, 256)
ODD_HEAD_DIM = 33
# the end-to-end width of phase 5b: 3,200 wide with 32 heads is D = 100, the
# width of LlamaGen's 3.1B GPT (24 layers), cut to 2 layers
WIDE_HIDDEN, WIDE_HEADS, WIDE_LAYERS = 3200, 32, 2
# phase 5b's timed shapes: (B, N, D) of the decode kernels at index 600 over
# 9 windows, (B, N, D, S) of the flash kernels at sep 0: D = 100 at the
# text->image batch and the pretraining batch of that width, D = 128 at the
# same shapes (the exact kernels of D = 100's tile width), and D = 256
HEAD_DIM_TIMED = {100: ((4, 32, 100), (2, 32, 100, 1088)),
                  128: ((4, 32, 128), (2, 32, 128, 1088)),
                  256: ((4, 16, 256), (2, 16, 256, 1088))}


def _wide_decode_inputs(torch, da, packed: bool, B: int, N: int, D: int, NW: int, seed: int):
    """One layer of a random cache at any head dim -> (kv, scales, ring,
    float32 q); int4 bytes are those the packer makes."""
    dev = torch.device("cuda")
    W, G = da.WRITE_WINDOW, da.SEAL_GROUP
    gen = torch.Generator(device=dev).manual_seed(seed)
    if packed:
        hi, lo = (torch.randint(-7, 8, (NW, B, 2, N, D // 2, W), generator=gen, device=dev)
                  for _ in range(2))
        kv = (16 * hi + lo + 8).to(torch.int8)
        sc = torch.rand((NW, B, 2, N, W), generator=gen, device=dev) * 0.3
    else:
        kv = torch.randint(-127, 128, (NW, B, 2, N, D, W), generator=gen, device=dev,
                           dtype=torch.int8)
        sc = torch.rand((NW, B, 2, N, W), generator=gen, device=dev) * 0.02
    ring = torch.randn((G, B, N, 2 * D), generator=gen, device=dev)
    return kv, sc, ring, torch.randn((B, N, D), generator=gen, device=dev)


def _decode_against_plain(torch, da, packed: bool, call, what: str) -> float:
    """One decode call ``(q, ring, kv, scales, index)`` of K1 or K2 against
    the plain version on copies of the cache: ctx within phase 3's
    tolerances (float32 q 1e-4; bf16 q: K1 2e-2, K2 1e-4 + one bf16 ulp of
    the value), cache bytes bit-equal (and changed only on a seal step), two
    launches bit-equal -> the largest error."""
    q, ring, kv, sc, idx = call
    kv_k, sc_k, kv_2, sc_2, kv_r, sc_r = (t.clone() for t in (kv, sc) * 3)
    ctx = da.decode_attention_quant(q, ring, kv_k, sc_k, idx)
    ctx2 = da.decode_attention_quant(q, ring, kv_2, sc_2, idx)
    want = da.decode_attention_quant_reference(q, ring, kv_r, sc_r, idx)
    torch.cuda.synchronize()
    diff = (ctx.float() - want.float()).abs()
    err = diff.max().item()
    if q.dtype == torch.float32:
        ok = err <= 1e-4
    elif packed:
        ok = bool((diff <= 1e-4 + want.float().abs() * 2.0 ** -7).all())
    else:
        ok = err <= 2e-2
    name = "K2 int4" if packed else "K1 int8"
    what = f"{what} index {idx} {str(q.dtype)[6:]}"
    _check(ctx.shape == q.shape and ok, f"{name} differs at {what}: {err}")
    _check(torch.equal(kv_k, kv_r) and torch.equal(sc_k, sc_r)
           and torch.equal(kv_k, kv) == (idx % da.SEAL_GROUP != da.SEAL_GROUP - 1),
           f"{name} cache differs from the plain version at {what}")
    _check(torch.equal(ctx, ctx2) and torch.equal(kv_k, kv_2),
           f"two launches of {name} differ at {what}")
    return err


def _check_wide_decode(torch, da, packed: bool, D: int) -> float:
    """K1 or K2 at head dim D (B=2, N=4, 3 windows, a seal on a window
    boundary and a step mid-window), float32 and bf16 q, against the plain
    version (:func:`_decode_against_plain`) -> the largest error."""
    kv, sc, ring, q32 = _wide_decode_inputs(torch, da, packed, 2, 4, D, 3, seed=D)
    return max(_decode_against_plain(torch, da, packed, (q32.to(dtype), ring, kv, sc, idx),
                                     f"D={D} B=2 N=4")
               for dtype in (torch.float32, torch.bfloat16) for idx in (135, 300))


def _flash_against_plain(torch, fa, qkvd, sep: int, rate: float, tol: float, what: str,
                         offsets=None) -> dict:
    """K3, K4 and K5 on ``(q, k, v, do)`` against their plain versions: o
    within ``tol`` and lse within 1e-4, dq, dk and dv within ``tol`` of their
    largest magnitude, two launches bit-equal.  With ``offsets`` (b0, n0, N,
    rows, heads) the kernels run on the block (rows, heads) with its batch
    and head offsets, and each result must also equal the block of the
    unsharded kernels' result -> {kernel: largest error}."""
    q, k, v, do = qkvd
    kw = dict(dropout_rate=rate, dropout_seed=1234 if rate else None)
    o, lse = fa.flash_attention(q, k, v, sep, **kw)
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    full = None
    if offsets is not None:
        b0, n0, n_all, rows, heads = offsets
        full = (o, lse, fa.flash_bwd_dq(q, k, v, do, lse, delta, sep, **kw),
                *fa.flash_bwd_dkv(q, k, v, do, lse, delta, sep, **kw))
        q, k, v, do = (t[rows, :, heads] for t in (q, k, v, do))
        lse, delta = lse[rows, heads].contiguous(), delta[rows, heads].contiguous()
        off = (b0, n0, n_all)
        o, blse = fa.flash_attention(q, k, v, sep, batch_offset=b0, head_offset=n0,
                                     num_heads=n_all, **kw)
        _check(torch.equal(blse, lse), f"the shard's lse is not the block at {what}")
    else:
        off = (0, 0, None)
    o2, _ = fa.flash_attention(q, k, v, sep, batch_offset=off[0], head_offset=off[1],
                               num_heads=off[2], **kw)
    ro, rlse = fa.flash_attention_reference(q, k, v, sep, rate, kw["dropout_seed"], off)
    args = (q, k, v, do, lse, delta, sep)
    dq = fa.flash_bwd_dq(*args, offsets=off, **kw)
    dk, dv = fa.flash_bwd_dkv(*args, offsets=off, **kw)
    dq2 = fa.flash_bwd_dq(*args, offsets=off, **kw)
    rdq = fa.flash_bwd_dq_reference(*args, rate, kw["dropout_seed"], off)
    rdk, rdv = fa.flash_bwd_dkv_reference(*args, rate, kw["dropout_seed"], off)
    torch.cuda.synchronize()
    err = (o.float() - ro.float()).abs().max().item()
    lerr = (lse - rlse).abs().max().item()
    _check(o.shape == q.shape and err <= tol and lerr <= 1e-4,
           f"flash forward differs at {what}: o {err}, lse {lerr}")
    _check(torch.equal(o, o2) and torch.equal(dq, dq2),
           f"two launches of the flash kernels differ at {what}")
    worst = {"fwd": err, "dq": 0.0, "dkv": 0.0}
    for i, (name, got, want) in enumerate((("dq", dq, rdq), ("dkv", dk, rdk), ("dkv", dv, rdv))):
        gerr = (got.float() - want.float()).abs().max().item()
        scale = want.float().abs().max().item()
        _check(gerr <= tol * scale, f"flash {name} differs at {what}: {gerr} > {tol} x {scale}")
        if full is not None:
            _check(torch.equal(got, full[2 + i][rows, :, heads]) and torch.equal(
                o, full[0][rows, :, heads]), f"flash {name} on the shard is not the block of "
                   f"the unsharded result at {what}")
        worst[name] = max(worst[name], gerr / scale)
    return worst


def _check_wide_flash(torch, fa, D: int) -> dict:
    """K3, K4 and K5 at head dim D on strided views of a fused QKV tensor
    (B=2, N=4, S=200, sep 40), float32 and bf16, without dropout and with
    0.1, against the plain versions at phases 4 and 5's tolerances; with
    dropout also on the shard of row 1 and heads 2-3, with its batch and
    head offsets (:func:`_flash_against_plain`) -> {kernel: largest
    error}."""
    gen = torch.Generator(device="cuda").manual_seed(D)
    B, N, S, sep = 2, 4, 200, 40
    worst = {"fwd": 0.0, "dq": 0.0, "dkv": 0.0}
    for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
        for rate in (0.0, 0.1):
            qkv = torch.randn((B, S, 3, N * D), generator=gen, device="cuda").to(dtype)
            q, k, v = (qkv[:, :, i].reshape(B, S, N, D) for i in range(3))
            do = torch.randn((B, S, N, D), generator=gen, device="cuda").to(dtype)
            what = f"D={D} {str(dtype)[6:]} dropout={rate}"
            cases = [(None, what)]
            if rate:
                cases.append(((1, 2, N, slice(1, 2), slice(2, 4)), what + " offsets (1, 2, 4)"))
            for offsets, label in cases:
                errs = _flash_against_plain(torch, fa, (q, k, v, do), sep, rate, tol, label,
                                            offsets)
                for name, e in errs.items():
                    worst[name] = max(worst[name], e)
    return worst


def _wide_flash_times(torch, fa, B, N, D, S):
    """K3 (dropout 0.1 and none), K4 and K5 (dropout 0.1 and none), first
    held against their plain versions on the same inputs (phases 4 and 5's
    bf16 tolerances), then timed beside the plain versions, SDPA with the
    boolean mask and autograd.grad through it, bf16 on fused-QKV views at
    sep 0 -> ({kernel: {field: value}}, {kernel: largest error})."""
    gen = torch.Generator(device="cuda").manual_seed(5)
    qkv = torch.randn((B, S, 3, N * D), generator=gen, device="cuda").to(torch.bfloat16)
    q, k, v = (qkv[:, :, i].reshape(B, S, N, D) for i in range(3))
    do = torch.randn((B, S, N, D), generator=gen, device="cuda").to(torch.bfloat16)
    err = {"fwd": 0.0, "dq": 0.0, "dkv": 0.0}
    for rate in (0.0, 0.1):
        for name, e in _flash_against_plain(torch, fa, (q, k, v, do), 0, rate, 2e-2,
                                            f"D={D} B={B} N={N} S={S} bf16 dropout={rate}"
                                            ).items():
            err[name] = max(err[name], e)
    torch.cuda.empty_cache()
    drop = dict(dropout_rate=0.1, dropout_seed=2024)
    with torch.no_grad():
        o, lse = fa.flash_attention(q, k, v, 0)
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    args = (q, k, v, do, lse, delta, 0)
    fwd_bound = _flash_bound(B, N, D, S, 0, 2, "bf16")
    bwd_bounds = _bwd_bounds(B, N, D, S)
    sdpa_fwd, _ = _sdpa_time_us(torch, q, k, v, 0)
    sdpa_bwd = _sdpa_backward_us(torch, (q, k, v, do))["boolean mask"]
    out = {"fwd": dict(
        ms=_device_time_us(torch, lambda: fa.flash_attention(q, k, v, 0)) / 1000.0,
        drop_ms=_device_time_us(torch, lambda: fa.flash_attention(q, k, v, 0, **drop)) / 1000.0,
        plain_ms=_device_time_us(torch, lambda: fa.flash_attention_reference(q, k, v, 0))
        / 1000.0, bound_ms=fwd_bound[0], bound_by=fwd_bound[1], library_ms=sdpa_fwd / 1000.0)}
    for name, fn, ref in (("dq", fa.flash_bwd_dq, fa.flash_bwd_dq_reference),
                          ("dkv", fa.flash_bwd_dkv, fa.flash_bwd_dkv_reference)):
        out[name] = dict(
            ms=_device_time_us(torch, lambda: fn(*args)) / 1000.0,
            drop_ms=_device_time_us(torch, lambda: fn(*args, **drop)) / 1000.0,
            plain_ms=_device_time_us(torch, lambda: ref(*args)) / 1000.0,
            bound_ms=bwd_bounds[name][0], bound_by=bwd_bounds[name][1],
            # one autograd.grad through SDPA computes dq, dk and dv together
            library_ms=sdpa_bwd / 1000.0)
    return out, err


def phase_head_dims_kernels(torch, da, fa, smi: str) -> dict:
    """K1 and K2, and K3-K5, against their plain versions at every head dim
    of HEAD_DIMS_CHECKED and at D = 33 (K2 refuses it as its plain version
    does); a head dim past 256 refused by name; then at the main path's
    shapes: K1/K2 at text->image's batch 1, and at HEAD_DIM_TIMED each
    kernel against its plain version on the inputs it is then timed on ->
    {"dims": ..., "err": ..., "times": ...}."""
    t0 = time.perf_counter()
    err = {"int8": 0.0, "int4": 0.0, "fwd": 0.0, "dq": 0.0, "dkv": 0.0}
    dims = {"int8": [], "int4": [], "fwd": [], "dq": [], "dkv": []}
    for D in HEAD_DIMS_CHECKED + (ODD_HEAD_DIM,):
        for packed, key in ((False, "int8"), (True, "int4")):
            if packed and D % 2:
                kv, sc, ring, q = _wide_decode_inputs(torch, da, True, 2, 4, D, 3, seed=D)
                msgs = []
                for fn in (da.decode_attention_quant, da.decode_attention_quant_reference):
                    try:
                        fn(q, ring, kv, sc, 135)
                        msgs.append(None)
                    except ValueError as e:
                        msgs.append(str(e))
                print(f"head dims: K2 at D={D}: {msgs[0]}")
                _check(msgs[0] is not None and msgs[0] == msgs[1],
                       f"K2 at odd D={D} did not refuse as its plain version does: {msgs}")
                continue
            err[key] = max(err[key], _check_wide_decode(torch, da, packed, D))
            dims[key].append(D)
        for name, e in _check_wide_flash(torch, fa, D).items():
            err[name] = max(err[name], e)
            dims[name].append(D)
        print(f"head dims: D={D} (tiles: decode {da.tile_width(D)}, flash {fa.tile_width(D)}): "
              f"K1{'' if D % 2 else ', K2'}, K3, K4, K5 agree with their plain versions")
    wide = torch.zeros((1, 8, 2, 264), device="cuda")
    for what, call in (("K3", lambda: fa.flash_attention(wide, wide, wide)),
                       ("K1/K2", lambda: da.tile_width(264))):
        try:
            call()
            _fail(f"{what} took head_dim 264")
        except NotImplementedError as e:
            print(f"head dims: {what} refuses D=264: {e}")
    print(f"head dims: largest errors K1 {err['int8']:.3e}, K2 {err['int4']:.3e} (ctx), K3 "
          f"{err['fwd']:.3e} (o), K4 {err['dq']:.3e}, K5 {err['dkv']:.3e} (of the largest "
          f"gradient); tolerances: decode float32 1e-4, bf16 K1 2e-2, K2 1e-4 + one bf16 ulp; "
          f"flash float32 1e-4, bf16 2e-2")

    # the main path's shapes: each timed shape's inputs are first held
    # against the plain versions (index 600 and the seal at 1031, float32
    # and bf16 q), and at D = WIDE_HIDDEN / WIDE_HEADS also text->image's
    # batch 1 past index 1024
    timed_err = {"int8": 0.0, "int4": 0.0, "fwd": 0.0, "dq": 0.0, "dkv": 0.0}
    t2i_D = WIDE_HIDDEN // WIDE_HEADS
    for packed, key in ((False, "int8"), (True, "int4")):
        kv, sc, ring, q32 = _wide_decode_inputs(torch, da, packed, 1, WIDE_HEADS, t2i_D, 9,
                                                seed=3)
        for dtype in (torch.float32, torch.bfloat16):
            for idx in (1031, 1087):
                timed_err[key] = max(timed_err[key], _decode_against_plain(
                    torch, da, packed, (q32.to(dtype), ring, kv, sc, idx),
                    f"D={t2i_D} B=1 N={WIDE_HEADS}"))
        del kv, sc, ring
    times = {}
    for D, ((db, dn, dd), (fb, fn_, fd, fs)) in HEAD_DIM_TIMED.items():
        row = {}
        for packed, key in ((False, "int8"), (True, "int4")):
            kv, sc, ring, q32 = _wide_decode_inputs(torch, da, packed, db, dn, dd, 9, seed=1)
            for dtype in (torch.float32, torch.bfloat16):
                for idx in (600, 1031):
                    timed_err[key] = max(timed_err[key], _decode_against_plain(
                        torch, da, packed, (q32.to(dtype), ring, kv, sc, idx),
                        f"D={dd} B={db} N={dn}"))
            q, idx = q32.to(torch.bfloat16), 600
            call = (q, ring, kv, sc, idx)
            bound_ms, by = _decode_bound(db, dn, dd, dd // 2 if packed else dd,
                                         da.SEAL_GROUP, idx, 2)
            row[key] = dict(
                ms=_device_time_us(torch, lambda: da.decode_attention_quant(*call)) / 1000.0,
                plain_ms=_device_time_us(torch, lambda: da.decode_attention_quant_reference(
                    *call)) / 1000.0, bound_ms=bound_ms, bound_by=by, library_ms=None)
            del kv, sc, ring
        flash_times, flash_err = _wide_flash_times(torch, fa, fb, fn_, fd, fs)
        row.update(flash_times)
        for name, e in flash_err.items():
            timed_err[name] = max(timed_err[name], e)
        times[D] = row
        for key, r in row.items():
            drop = f", with dropout 0.1 {r['drop_ms']:.4f} ms" if "drop_ms" in r else ""
            lib = ("" if r["library_ms"] is None
                   else f", library {r['library_ms']:.4f} ms")
            print(f"head dims: time D={D} {key}: kernel {r['ms']:.4f} ms{drop}, plain "
                  f"{r['plain_ms']:.4f} ms{lib}; bound {r['bound_ms']:.4f} ms ({r['bound_by']}) "
                  f"(CUDA events, median of 25; decode B={db} N={dn} index 600 bf16 q, flash "
                  f"B={fb} N={fn_} S={fs} bf16; {smi})")
        torch.cuda.empty_cache()
    print(f"head dims: at the timed shapes and text->image's (D={t2i_D} B=1 N={WIDE_HEADS} "
          f"index 1031 and 1087) the kernels agree with their plain versions: largest errors "
          f"K1 {timed_err['int8']:.3e}, K2 {timed_err['int4']:.3e} (ctx), K3 "
          f"{timed_err['fwd']:.3e} (o), K4 {timed_err['dq']:.3e}, K5 {timed_err['dkv']:.3e} "
          f"(of the largest gradient), the tolerances above")
    for key, e in timed_err.items():
        err[key] = max(err[key], e)
    print(f"head dims: kernels phase {time.perf_counter() - t0:.1f} s")
    return {"dims": dims, "err": err, "times": times}


def phase_head_dims_main_path(torch, da, fa, cli, cfgmod, tasks, sampling, pretrain, losses,
                              optim, work: str) -> dict:
    """D = 100 through the entry points: ``cli.pretrain`` at the tutorial
    preset, WIDE_LAYERS layers WIDE_HIDDEN wide with WIDE_HEADS heads, two
    steps at batch 2 x 1,088 (K3-K5), then one text->image request at that
    width and depth, random weights, batch 1, through ``cli.generate`` and
    ``generation.tasks`` on the int8 cache (K1) and on the int4 cache (K2)
    -> each kernel's launches."""
    import contextlib
    import io

    import numpy as np

    t0 = time.perf_counter()
    corpus = os.path.join(work, "wide_t2i.bin")
    _write_corpus(corpus, 16, seed=11)
    counters = (fa.flash_attention, fa.flash_bwd_dq, fa.flash_bwd_dkv)
    plains = (fa.flash_attention_reference, fa.flash_bwd_dq_reference, fa.flash_bwd_dkv_reference)
    for c in counters:
        c.launches = 0
    for c in plains:
        c.calls = 0
    rec = {"metrics": []}
    orig_make = pretrain.make_train_step

    def recording_make(cfg, opt, **kw):
        step = orig_make(cfg, opt, **kw)
        rec.update(cfg=cfg, kw=kw)

        def recorded(state, batch):
            if not rec["metrics"]:  # the first batch and the params before any step
                rec["batch"] = batch
                rec["params0"] = optim.tree_map(lambda t: t.detach().clone(), state["params"])
            state, metrics = step(state, batch)
            rec["metrics"].append(metrics)
            rec["state"] = state
            return state, metrics

        return recorded

    argv = ["--preset", "tutorial", "--device", "cuda", "--train-data", corpus,
            "--num-layers", str(WIDE_LAYERS), "--hidden-size", str(WIDE_HIDDEN),
            "--num-attention-heads", str(WIDE_HEADS), "--batch-size", "2",
            "--split", "1.0,0.0,0.0", "--lr", "1e-3", "--warmup", "0.0", "--seed", "1234",
            "--log-interval", "1", "--eval-interval", "1000", "--train-iters", "2"]
    out = io.StringIO()
    pretrain.make_train_step = recording_make
    try:
        with contextlib.redirect_stdout(out):
            rc = pretrain.main(argv, txt_tokenizer=WordTokenizer())
    finally:
        pretrain.make_train_step = orig_make
    print(out.getvalue(), end="")
    _check(rc == 0, f"pretrain.main at D=100 returned {rc}")
    train = [c.launches for c in counters]
    plain_calls = [c.calls for c in plains]
    cfg, kw = rec["cfg"], rec["kw"]
    lm = [m["lm_loss"] for m in rec["metrics"]]
    # the first batch's loss before and after the two steps, on the same
    # dropout seeds
    batch = {k: torch.as_tensor(v).cuda() for k, v in rec["batch"].items()}
    seeds = list(range(1, cfg.num_layers + 2))
    with torch.no_grad():
        before, after = (float(losses.lm_loss(p, cfg, batch, img_vocab=kw["img_vocab"],
                                              txt_loss_scale=kw["txt_loss_scale"],
                                              seeds=seeds)[0])
                         for p in (rec["params0"], rec["state"]["params"]))
    print(f"head dims: pretrain D={cfg.head_dim} ({cfg.hidden_size} wide, {cfg.num_heads} heads, "
          f"{cfg.num_layers} layers, {str(cfg.compute_dtype)[6:]}): step losses "
          f"{', '.join(f'{x:.4f}' for x in lm)}; the first batch's loss {before:.4f} before, "
          f"{after:.4f} after; flash launches (K3, K4, K5) {train}, plain-version calls "
          f"{plain_calls}")
    _check(cfg.head_dim == 100 and len(lm) == 2 and np.isfinite(lm).all()
           and np.isfinite([before, after]).all() and after < before,
           "pretraining at D=100: losses not finite or not falling")
    _check(all(n > 0 for n in train) and plain_calls == [0, 0, 0],
           "pretraining at D=100 did not run K3-K5")
    del rec, batch
    torch.cuda.empty_cache()

    query = os.path.join(work, "wide_query.txt")
    with open(query, "w") as f:
        f.write(PROMPT + "\n")
    orig = cli.PRESETS["cogview-base"]
    cli.PRESETS["cogview-base"] = lambda: cfgmod.cogview_base(
        num_layers=WIDE_LAYERS, hidden_size=WIDE_HIDDEN, num_heads=WIDE_HEADS)
    decode = {}
    try:
        for kv in ("int8", "int4"):
            da.decode_attention_quant.launches = 0
            da.decode_attention_quant.launches_int4 = 0
            da.decode_attention_quant_reference.calls = 0
            captured = {}
            argv = _cli_argv("bfloat16", "text2image", query, os.path.join(work, f"wide_{kv}"))
            argv[argv.index("--kv-cache") + 1] = kv
            argv[argv.index("--batch-size") + 1] = "1"
            _run_cli(cli, tasks, sampling, torch, argv, captured)
            k1, k2 = da.decode_attention_quant.launches, da.decode_attention_quant.launches_int4
            res, ctx, steps = captured["res"], captured["ctx"], captured["steps"]
            codes = res.tokens[:, ctx:ctx + 1024]
            ok = (codes.shape == (1, 1024) and bool(((codes >= 0) & (codes < 8192)).all())
                  and len(res.images) == 1 and bool(np.isfinite(res.images[0]).all()))
            launched = k2 if kv == "int4" else k1
            print(f"head dims: text->image D=100 {kv} cache: 1024 codes, checksum "
                  f"{int(codes.astype(np.int64).sum())} (crc32 "
                  f"{zlib.crc32(codes.astype(np.int32).tobytes())}), in [0, 8192) with a finite "
                  f"image: {ok}; {captured['request_s']:.3f} s per request (batch 1, "
                  f"{WIDE_LAYERS} layers); K1 launches {k1}, K2 launches {k2}, plain-version "
                  f"calls {da.decode_attention_quant_reference.calls}")
            _check(ok and steps == 1024 and launched == 1024 * WIDE_LAYERS
                   and (k1 if kv == "int4" else k2) == 0
                   and da.decode_attention_quant_reference.calls == 0,
                   f"the D=100 request on the {kv} cache did not run its kernel once per step "
                   f"and layer")
            decode[kv] = launched
    finally:
        cli.PRESETS["cogview-base"] = orig
    print(f"head dims: main path phase {time.perf_counter() - t0:.1f} s")
    return {"int8": decode["int8"], "int4": decode["int4"], "fwd": train[0], "dq": train[1],
            "dkv": train[2]}


def _cuobjdump(so, flag):
    from cogview_tpu_torch.ops import _kernels

    cuobjdump = os.path.join(os.path.dirname(_kernels._nvcc()), "cuobjdump")
    return subprocess.run([cuobjdump, flag, str(so)], capture_output=True, text=True,
                          check=True).stdout


FLASH_TC_KERNELS = {"fwd": "flash_fwd_wgmma_kernel", "dq": "flash_bwd_dq_wgmma_kernel",
                    "dkv": "flash_bwd_dkv_wgmma_kernel"}


def _check_tensor_core_kernels(sos, libraries: dict) -> None:
    """The bf16 flash kernels (K3 forward, K4, K5) run their products on the
    tensor cores and copy asynchronously: in the flash libraries ``sos``
    (``libraries``: each one's tile widths), each instantiation of each
    (every library's tile widths, with and without dropout; ``EXACT`` the
    exact library's) holds HGMMA and UTMALDG or LDGSTS in its SASS; and at
    D = 64, the exact library's D = 64 kernels, none spills (no stack, no
    local memory in cuobjdump's resource usage).  Prints every one's
    registers and every spill."""
    pat = r"ILi(\d+)ELb([01])ELb([01])E"  # tile width, dropout, exact
    found, usage = {}, {}
    for so in sos:
        for section in _cuobjdump(so, "-sass").split("Function : ")[1:]:
            name = section.split(None, 1)[0]
            if "wgmma_kernel" in name:
                found[name] = (section.count("HGMMA"),
                               section.count("UTMALDG") + section.count("LDGSTS"))
        for fn, line in re.findall(r"Function (\S+?):\s*\n\s*(REG:.*)",
                                   _cuobjdump(so, "-res-usage")):
            if "wgmma_kernel" in fn:
                usage[fn] = {k: int(v) for k, v in re.findall(r"(REG|STACK|LOCAL):(\d+)", line)}
    n = 2 * sum(len(widths) for widths in libraries.values())
    widths = {w for ws in libraries.values() for w in ws}
    for kind, kernel in FLASH_TC_KERNELS.items():
        mine = {fn: hc for fn, hc in found.items() if kernel in fn}
        keys = {fn: (int(d), drop == "1", x == "1") for fn in usage if kernel in fn
                for d, drop, x in re.findall(pat, fn)}
        regs = {keys[fn]: u["REG"] for fn, u in usage.items() if fn in keys}
        spills = {keys[fn]: u["STACK"] + u["LOCAL"] for fn, u in usage.items()
                  if fn in keys and u["STACK"] + u["LOCAL"]}
        print(f"flash {kind} SASS (cuobjdump): {len(mine)} bf16 instantiations, HGMMA "
              f"{sorted({h for h, _ in mine.values()})}, UTMALDG + LDGSTS "
              f"{sorted({c for _, c in mine.values()})}; registers (tile width, dropout, "
              f"exact) {dict(sorted(regs.items()))}; stack + local bytes where not 0 "
              f"{dict(sorted(spills.items()))}")
        _check(len(mine) == n and all(h > 0 and c > 0 for h, c in mine.values())
               and {d for d, _, _ in keys.values()} == widths,
               f"a bf16 {kind} kernel lacks tensor-core products or asynchronous copies, or "
               f"a tile width is missing")
    d64 = {fn: u for fn, u in usage.items() if re.search(r"ILi64ELb[01]ELb1E", fn)}
    print(f"flash SASS at D = 64: {len(d64)} bf16 instantiations, stack and local bytes "
          f"{sorted({u['STACK'] + u['LOCAL'] for u in d64.values()})}")
    _check(len(found) == 3 * n, f"{len(found)} bf16 flash instantiations, expected {3 * n}")
    _check(len(d64) == 6 and all(u["STACK"] == 0 and u["LOCAL"] == 0 for u in d64.values()),
           "a bf16 flash kernel at D = 64 spills")


def _check_decode_kernels(so, tile_widths) -> None:
    """K1 and K2 stream their windows with cp.async: each of the
    instantiations (int8 with bf16 or float32 q, int4 with either, at every
    tile width, exact (D = the tile width) and not) holds LDGSTS in its
    SASS, and at D = 64 (the exact D = 64 kernels) none spills (no stack,
    no local memory).  Prints every one's registers."""
    pat = r"decode_attention_kernelI(f|13__nv_bfloat16)Lb[01]ELb([01])ELi(\d+)ELb([01])E"
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

    def key(t, packed, d, exact):
        return (f"{'int4' if packed == '1' else 'int8'} {'f32' if t == 'f' else 'bf16'} D={d}"
                f"{' exact' if exact == '1' else ''}")

    regs = {key(*k): u["REG"] for k, u in sorted(usage.items(), key=lambda kv: int(kv[0][2]))}
    spills = {key(*k): u["STACK"] + u["LOCAL"] for k, u in usage.items()
              if u["STACK"] + u["LOCAL"]}
    print(f"decode SASS (cuobjdump): {len(copies)} instantiations, LDGSTS "
          f"{sorted(set(copies.values()))}; registers {regs}; stack + local bytes where not "
          f"0 {spills}")
    d64 = [u for (_, _, d, x), u in usage.items() if d == "64" and x == "1"]
    print(f"decode SASS at D = 64: {len(d64)} instantiations, stack and local bytes "
          f"{sorted({u['STACK'] + u['LOCAL'] for u in d64})}")
    _check(len(copies) == 8 * len(tile_widths) and all(copies.values())
           and {int(d) for _, _, d, _ in copies} == set(tile_widths),
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


def phase_main_path(torch, da, gpt, cli, cfgmod, tasks, sampling, png, weights: str,
                    work: str, layers: int):
    """One text2image request through the CLI at cogview-base widths and
    ``layers`` layers -> (kernel launches, PNG dir, the decode-step profile
    of the bf16-weight request or None)."""
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
        with _cut_depth(cli, cfgmod, layers):
            _run_cli(cli, tasks, sampling, torch,
                     _cli_argv(weights, "text2image", query, out_dir), captured)
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
    want = steps * layers
    print(f"main path weights={weights}, {layers} layers: kernel launches {launches} == decode "
          f"steps x {layers} = {steps} x {layers} = {want}: {launches == want}; plain-version "
          f"calls {plain_calls}")
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
        _check(profile["k1_launches"] == layers, f"the profiled decode steps did not launch K1 "
               f"{layers} times each")
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


# the depth of the text->image-shaped decode requests, cut from
# cogview-base's 48 layers to keep the script inside its time limit: their
# 1,024 decode steps at batch 4 are host-bound, about 6 ms a step plus 1.9
# ms a layer on an H100 host (98 s a request at 48 layers, 28 s at 12, 14 s
# at 4), and the script at 12 layers for the three below and 48 for the
# profiled one ran past 1,200 s on a slow host.  MAIN_LAYERS: the profiled
# bf16-weight text->image request; CUT_LAYERS: the int8-weight one, the
# int4 server's and low-level super-resolution's
MAIN_LAYERS, CUT_LAYERS = 12, 4


@contextlib.contextmanager
def _cut_depth(cli, cfgmod, layers: int):
    """The generate and serve CLIs' ``cogview-base`` preset (one dict)
    at its widths with ``layers`` layers, for the block."""
    orig = cli.PRESETS["cogview-base"]
    cli.PRESETS["cogview-base"] = lambda: cfgmod.cogview_base(num_layers=layers)
    try:
        yield
    finally:
        cli.PRESETS["cogview-base"] = orig


def phase_low_level_sr(torch, da, cli, cfgmod, tasks, sampling, png, png_dir: str, work: str):
    """Low-level super-resolution through the CLI at cogview-base widths,
    depth cut to CUT_LAYERS, int8 cache, batch 4, on the prompt and the
    first PNG of the int8-weight text->image request, read at 128 pixels
    (the bilinear resize, 256 -> 128) -> K1 launches."""
    import numpy as np

    query = os.path.join(work, "llsr.txt")
    with open(query, "w") as f:
        f.write(PROMPT + "\t" + os.path.join(png_dir, "0.png") + "\n")
    out_dir = os.path.join(work, "llsr")
    captured = {}
    da.decode_attention_quant.launches = 0
    da.decode_attention_quant.launches_int4 = 0
    da.decode_attention_quant_reference.calls = 0
    with _cut_depth(cli, cfgmod, CUT_LAYERS):
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
    L = CUT_LAYERS
    print(f"low-level SR: K1 launches {launches} == decode steps x {L} = {steps} x {L} = "
          f"{steps * L}: {launches == steps * L}; plain-version calls {plain_calls}")
    _check(steps == 1024 and launches == steps * L and plain_calls == 0,
           "low-level SR did not run K1 once per step and layer")
    print(f"low-level SR: {captured['request_s']:.3f} s per request (batch 4, cogview-base "
          f"widths, {L} layers); filling {captured['fill_s']:.3f} s = "
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


def phase_serve_int4(torch, da, serve, cfgmod, tasks, sampling, png, work: str):
    """One request through the folder-watcher server with the int4 cache at
    cogview-base widths, depth cut to CUT_LAYERS -> K2 launches."""
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
    with _cut_depth(serve, cfgmod, CUT_LAYERS):
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
    L = CUT_LAYERS
    print(f"serve int4: K2 launches {k2} == 1024 x {L} = {1024 * L}: {k2 == 1024 * L}; K1 "
          f"launches {k1}; plain-version calls {plain_calls}")
    _check(steps == 1024 and k2 == 1024 * L and k1 == 0 and plain_calls == 0,
           "the int4 request did not run K2 once per step and layer")
    print(f"serve int4: {captured['request_s']:.3f} s per request (batch 4, {L} layers); filling "
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
SR_FULL_STEPS = 5
SR_FULL_PROFILED = (4,)  # the 0-based steps under torch.profiler; 1-3 are timed


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
    print(f"sr full depth: step(s) {', '.join(str(i + 1) for i in SR_FULL_PROFILED)} under "
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
# phases 23-25: preprocessing -> pretraining, the image formats, VQ-VAE
# training, FID / IS
# --------------------------------------------------------------------- #

CORPUS_IMAGES = 64  # 256 x 320 images of phase 23's sources
SR_IMAGES = 4  # 512 x 640 images of its super-resolution task
VQ_ST_ITERS, VQ_GUMBEL_ITERS, VQ_BATCH = 20, 10, 32
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


FORMAT_SIZE = (192, 240)  # phase 23b's pictures, h x w


def _le_header(fmt: str, *values) -> bytes:
    import struct

    return struct.pack("<" + fmt, *values)


def _rle_runs(row: bytes, px: int, most: int):
    """A row of ``px``-byte pixels -> (run length, pixel bytes, literal)
    pieces: runs of equal pixels (2 or more), literals of the rest, at most
    ``most`` pixels each."""
    n, i, out = len(row) // px, 0, []
    while i < n:
        j = i + 1
        while j < n and j - i < most and row[j * px:(j + 1) * px] == row[i * px:(i + 1) * px]:
            j += 1
        if j - i > 1:
            out.append((j - i, row[i * px:(i + 1) * px], False))
        else:
            while j < n and j - i < most and (j + 1 >= n or row[j * px:(j + 1) * px]
                                                != row[(j + 1) * px:(j + 2) * px]):
                j += 1
            out.append((j - i, row[i * px:j * px], True))
        i = j
    return out


def _format_files(png, rng):
    """The files of phase 23b -> {name: (bytes, the [h, w, 3] uint8 they hold)},
    each written by a few lines here (the port imports no Pillow)."""
    import struct

    import numpy as np

    h, w = FORMAT_SIZE
    pic = [_gradient_image(rng, h, w) for _ in range(10)]
    pic[1][:, ::3] = pic[1][:, ::3] // 16 * 16  # runs for the run-length coders
    files = {}
    bgr = pic[0][..., ::-1]
    files["tga_raw.jpg"] = (_le_header("BBBHHBHHHHBB", 0, 0, 2, 0, 0, 0, 0, 0, w, h, 24, 0x20)
                            + bgr.tobytes(), pic[0])
    body = b""
    for row in pic[1][..., ::-1]:
        for n, px, literal in _rle_runs(row.tobytes(), 3, 128):
            body += bytes([(n - 1) | (0 if literal else 0x80)]) + px
    files["tga_rle.png"] = (_le_header("BBBHHBHHHHBB", 0, 0, 10, 0, 0, 0, 0, 0, w, h, 24, 0x20)
                            + body, pic[1])
    pcx = bytes([10, 5, 1, 8]) + _le_header("HHHHHH", 0, 0, w - 1, h - 1, 72, 72) + bytes(49)
    pcx += bytes([3]) + _le_header("HH", w, 1)
    pcx = pcx.ljust(128, b"\0")
    for row in pic[2]:
        for plane in row.T:
            for n, v, literal in _rle_runs(plane.tobytes(), 1, 63):
                if literal:  # a byte of the form 11xxxxxx goes as a run of one
                    pcx += b"".join(bytes([b]) if b < 0xC0 else bytes([0xC1, b]) for b in v)
                else:
                    pcx += bytes([0xC0 | n]) + v
    files["pcx.jpg"] = (pcx, pic[2])
    rows = []  # SGI: each channel's rows bottom-up, RLE
    for c in range(3):
        for row in pic[3][::-1, :, c]:
            out = b""
            for n, v, literal in _rle_runs(row.tobytes(), 1, 127):
                out += bytes([0x80 | n]) + v if literal else bytes([n]) + v
            rows.append(out + b"\0")
    table_end = 512 + 8 * len(rows)
    starts = np.cumsum([table_end] + [len(r) for r in rows[:-1]])
    sgi = struct.pack(">HBBHHHH", 474, 1, 1, 3, w, h, 3).ljust(512, b"\0")
    sgi += struct.pack(f">{len(rows)}I", *starts) + struct.pack(f">{len(rows)}I",
                                                               *map(len, rows))
    files["sgi_rle.png"] = (sgi + b"".join(rows), pic[3])

    def dib(img, extra_rows=0):
        ih, iw = img.shape[:2]
        stride = (iw * 3 + 3) & ~3
        rows = np.zeros((ih, stride), np.uint8)
        rows[:, :iw * 3] = img[::-1, :, ::-1].reshape(ih, -1)
        return (_le_header("IiiHHIIiiII", 40, iw, ih + extra_rows, 1, 24, 0, 0, 0, 0, 0, 0)
                + rows.tobytes())

    files["dib.jpg"] = (dib(pic[4]), pic[4])
    icon = pic[5][:128, :128]
    mask = bytes(((128 + 31) // 32 * 4) * 128)
    payload = dib(icon, extra_rows=128) + mask
    files["ico_bmp.png"] = (_le_header("HHH", 0, 1, 1) + bytes([128, 128, 0, 0])
                            + _le_header("HHII", 1, 24, len(payload), 22) + payload, icon)
    icon2 = pic[6][:128, :128]
    payload = png.encode_png(icon2)
    files["ico_png.jpg"] = (_le_header("HHH", 0, 1, 1) + bytes([128, 128, 0, 0])
                            + _le_header("HHII", 1, 32, len(payload), 22) + payload, icon2)
    head = b"8BPS" + struct.pack(">H", 1) + bytes(6) + struct.pack(">HIIHH", 3, h, w, 8, 3)
    head += bytes(12)
    files["psd_raw.png"] = (head + b"\0\0" + pic[7].transpose(2, 0, 1).tobytes(), pic[7])
    packed = []
    for plane in pic[8].transpose(2, 0, 1):
        for row in plane:
            out = b""
            for n, v, literal in _rle_runs(row.tobytes(), 1, 128):
                out += bytes([n - 1]) + v if literal else bytes([257 - n]) + v
            packed.append(out)
    files["psd_packbits.jpg"] = (head + struct.pack(">H", 1) + struct.pack(
        f">{len(packed)}H", *map(len, packed)) + b"".join(packed), pic[8])
    dds = b"DDS " + _le_header("IIIIIII", 124, 0x1007, h, w, 0, 0, 0) + bytes(44)
    dds += _le_header("II4sI4I", 32, 0x40, bytes(4), 24, 0xFF0000, 0xFF00, 0xFF, 0)
    files["dds.png"] = (dds.ljust(128, b"\0") + pic[9][..., ::-1].tobytes(), pic[9])
    gray = pic[0][..., 1]
    pfm = b"Pf\n%d %d\n-1.0\n" % (w, h) + gray[::-1].astype("<f4").tobytes()
    files["pfm.jpg"] = (pfm, np.repeat(gray[..., None], 3, axis=2))
    return files


def phase_image_formats(torch, vqvae, work: str, smi: str) -> None:
    """Phase 23b: the newly read formats on the card's host, then through
    the preprocess CLI on the card (see the module docstring)."""
    import contextlib
    import io

    import numpy as np

    from cogview_tpu_torch.cli import preprocess
    from cogview_tpu_torch.models import convert
    from cogview_tpu_torch.models.vqvae import decode_image, to_model_input
    from cogview_tpu_torch.utils import png

    t0 = time.perf_counter()
    files = _format_files(png, np.random.RandomState(31))
    folder = os.path.join(work, "formats")
    os.makedirs(folder)
    host_ms = {}
    for name, (data, want) in files.items():
        with open(os.path.join(folder, name), "wb") as f:
            f.write(data)
        t = time.perf_counter()
        got = decode_image(data)
        host_ms[name] = (time.perf_counter() - t) * 1000.0
        _check(got.shape == want.shape and np.array_equal(got, want),
               f"{name} does not decode to its source array")
    names = sorted(files)
    caps = os.path.join(work, "formats.tsv")
    with open(caps, "w") as f:
        for i, name in enumerate(names):
            f.write(f"{name}\t" + " ".join(f"word{(i + k) % 50}" for k in range(5)) + "\n")
    vq_path = os.path.join(work, "vqvae_released.pt")
    out = os.path.join(work, "formats.bin")
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        rc, log = _run_quiet(preprocess.main, [
            "--task", "text2image", "--image-source", folder, "--text-source", caps,
            "--img-tokenizer-path", vq_path, "--output", out, "--batch-size", "32",
            "--device", "cuda"], txt_tokenizer=WordTokenizer())
    print(err.getvalue(), end="")
    _check(rc == 0, "preprocess text2image over the format folder failed")
    _check("skipped" not in err.getvalue(), "the format folder skipped an image")
    rows = np.fromfile(out, np.int32).reshape(-1, 64 + 1024)
    _check(rows.shape[0] == len(files), f"{rows.shape[0]} rows from {len(files)} files")
    params = convert.load_vqvae_checkpoint(vq_path, torch.device("cuda"))
    x = torch.from_numpy(np.stack([to_model_input(files[n][1], 256) for n in names])).cuda()
    own = vqvae.img2code(params, x).cpu().numpy()
    _check(np.array_equal(own, rows[:, 64:]),
           "the format folder's codes differ from the card's img2code of the sources")
    h, w = FORMAT_SIZE
    print(f"image formats ({smi}; host decode of {h} x {w}, ms): "
          + ", ".join(f"{n} {host_ms[n]:.1f}" for n in names))
    print(f"image formats: {len(files)} files -> {rows.shape[0]} rows, 0 skipped, codes equal "
          f"to img2code of the sources; phase {time.perf_counter() - t0:.1f} s")


DAMAGE_SIZE = (96, 128)  # phase 23c's pictures, h x w
# phase 23c's files as Pillow 12.1 ends them (Image.open(...).convert("RGB")
# on this script's files): "skip" where it raises, else the SHA-256 of the
# RGB array it reads; tests/test_torch_image_damage_other.py holds this
# table to live Pillow
DAMAGED_OUTCOMES = {
    'gif_data_cut.png': 'skip',
    'gif_longer_block.jpg': 'skip',
    'gif_seed1001.png': 'skip',
    'gif_seed1006.jpg': '7ebdf0edec4d0a366ace3bb5dfb8d4f2902735a54c3c662159d80c2319abfbb2',
    'gif_seed1019.png': '89593fdde738dc968e74a49955661eaef2dc7c82478fe42cbc0409df2eeaacf7',
    'gif_trailer_lost.jpg': 'ece876e1140627815a50d96f5439973c0c6d44adddfd18c01739c558db189a79',
    'gif_zero_block.png': 'skip',
    'jpeg_dht_in_scan.png': 'skip',
    'jpeg_eoi_in_scan.jpg': 'cdfd42ff2434f265f67260ab635d7491ad1d66f853d489e7d773606abd426528',
    'jpeg_eoi_lost.jpg': 'skip',
    'jpeg_rst_in_scan.jpg': 'cdfd42ff2434f265f67260ab635d7491ad1d66f853d489e7d773606abd426528',
    'jpeg_seed1004.jpg': 'skip',
    'jpeg_seed1011.png': '3a43fc74bee812d35264d3364c514f7f0acc325b31d45113ac3bb38b335bf4ce',
    'jpeg_seed1023.png': '2aa9755b5a9921b3c96edd91324a30fe320da295a6cc338aadba21c50001d9aa',
    'jpeg_seed1042.jpg': '3ac404aa6388d2ab3028258a7b77bb7cc28430a017cdf22ff3ea616a3ac2c4af',
    'rst_forged_far.jpg': 'dee07e45b74093bdf66c93d0ea06d7b9123f397025cd8fc47d2e193a8f90ebad',
    'rst_forged_next.png': '94a846e9af8b4d5346a28809cfb9d09e7cbf69b9aa7045b0f9dab820b52ddffb',
    'rst_forged_prior.jpg': '9a47fd555c8c41c276769f2b0be96b88a17584338d46ea79e63c68957da3a1fd',
    'rst_lost.jpg': '9a47fd555c8c41c276769f2b0be96b88a17584338d46ea79e63c68957da3a1fd',
    'rst_reserved_marker.png': '2fb9a16938d5ee389c17ead7ab87793c687197938303c3f3998042e137e6a9fb',
    'rst_seed1002.jpg': 'd5dc8ae98bbf5618ba32a57750e086eec88311b12ff52a973eadfdf117bccd81',
    'rst_seed1017.png': '42c9f2bc0d176cac1b32c01f038156049ede3d14e160181edda0eef5746ccbf9',
    'rst_seed1030.jpg': 'ff96cdb358c2445b6f8c39a3644e5bce4b586a18940e67bc6ddc9ddc200df8a2',
    'rst_seed1055.png': 'eef85a6dd36f79529231844968f50df4ef528ccfa2c06232fd5529313f63590e',
}


def _huffman_codes(counts, symbols):
    """A DHT table's canonical codes -> {symbol: (code, length)}."""
    codes, code, k = {}, 0, 0
    for length in range(1, 17):
        for _ in range(counts[length - 1]):
            codes[symbols[k]] = (code, length)
            code += 1
            k += 1
        code <<= 1
    return codes


def _jpeg_file(img, restart: int = 0, sampling=(2, 2), ycc: bool = True,
               abbreviated: bool = False, progressive: bool = False,
               adobe: int = None) -> bytes:
    """A baseline JFIF JPEG of ``img`` [h, w, 3] uint8 (or [h, w], one
    component, or [h, w, 4], four taken as they are): the first component's
    ``sampling`` factors (h, v) over the others at 1 x 1 (4:2:0 by
    default), of its YCbCr (``ycc``) or of its samples as they are;
    ``adobe``: an Adobe marker with that transform after the JFIF marker;
    T.81's K.3 Huffman tables, quantizers 2 + 3 (u + v) / 2 (luma) and
    twice those (chroma), and a restart marker every ``restart`` MCUs where
    it is not 0; ``abbreviated``: without its tables (and JFIF marker), as
    a TIFF strip whose tables are in JPEGTables (:func:`_jpeg_tables`);
    ``progressive``: SOF2 with spectral selection only, an interleaved DC
    scan and then each component's AC scan (1..63, an EOB a block)."""
    import struct

    import numpy as np

    from cogview_tpu_torch.utils.jpeg import _STD_TABLES, _ZIGZAG

    h, w = img.shape[:2]
    f = img.astype(np.float64)
    if f.ndim == 2:
        comps = [f]
    elif ycc and f.shape[2] == 3:
        comps = [0.299 * f[..., 0] + 0.587 * f[..., 1] + 0.114 * f[..., 2],
                 128 - 0.168736 * f[..., 0] - 0.331264 * f[..., 1] + 0.5 * f[..., 2],
                 128 + 0.5 * f[..., 0] - 0.418688 * f[..., 1] - 0.081312 * f[..., 2]]
    else:
        comps = [f[..., c] for c in range(f.shape[2])]
    sh, sv = sampling
    mh, mw = -(-h // (8 * sv)), -(-w // (8 * sh))
    n = np.arange(8)
    dct = np.sqrt(np.where(n == 0, 1, 2) / 8)[:, None] * np.cos(
        (2 * n[None, :] + 1) * n[:, None] * np.pi / 16)
    quant = 2 + np.add.outer(n, n) * 3 // 2
    zz = list(_ZIGZAG)
    blocks = []
    for k, p in enumerate(comps):
        p = np.pad(p, ((0, 8 * sv * mh - h), (0, 8 * sh * mw - w)), mode="edge")
        if k:
            p = p.reshape(8 * mh, sv, 8 * mw, sh).mean(axis=(1, 3))
        t = (p - 128).reshape(p.shape[0] // 8, 8, p.shape[1] // 8, 8).transpose(0, 2, 1, 3)
        c = np.einsum("ij,abjk,lk->abil", dct, t, dct) / (quant * (1 + (k > 0)))
        blocks.append(np.round(c).astype(np.int64).reshape(c.shape[0], c.shape[1], 64)[..., zz])
    tables = [(_huffman_codes(*_STD_TABLES[0, t]), _huffman_codes(*_STD_TABLES[1, t]))
              for t in (0, 1)]
    out, acc, nacc = bytearray(), 0, 0

    def put(code: int, length: int) -> None:
        nonlocal acc, nacc
        acc, nacc = (acc << length) | (code & ((1 << length) - 1)), nacc + length
        while nacc >= 8:
            nacc -= 8
            out.append((acc >> nacc) & 0xFF)
            if out[-1] == 0xFF:
                out.append(0)
        acc &= (1 << nacc) - 1  # only the bits not yet written

    def value(v: int) -> None:  # the magnitude category's symbol bits
        s = abs(v).bit_length()
        put(v if v >= 0 else v + (1 << s) - 1, s)

    def dc_code(k: int, blk) -> None:
        dc = tables[k > 0][0]
        diff, pred[k] = int(blk[0]) - pred[k], int(blk[0])
        put(*dc[abs(diff).bit_length()])
        value(diff)

    def ac_code(k: int, blk) -> None:
        ac = tables[k > 0][1]
        last = max([i for i, c in enumerate(blk) if c and i] or [0])
        run = 0
        for i in range(1, last + 1):
            if not blk[i]:
                run += 1
                continue
            while run > 15:
                put(*ac[0xF0])
                run -= 16
            put(*ac[(run << 4) | abs(int(blk[i])).bit_length()])
            value(int(blk[i]))
            run = 0
        if last < 63:
            put(*ac[0x00])

    pred = [0] * len(comps)
    scans = []
    blocks = [b.tolist() for b in blocks]  # [block row][block column][64], Python ints
    for m in range(mh * mw):
        if restart and m and m % restart == 0:
            if nacc:
                put(0x7F, 8 - nacc)
            out += bytes([0xFF, 0xD0 + (m // restart - 1) % 8])
            pred = [0] * len(comps)
        my, mx = divmod(m, mw)
        units = [(0, blocks[0][sv * my + v][sh * mx + u]) for v in range(sv) for u in range(sh)]
        for k, blk in units + [(k, blocks[k][my][mx]) for k in range(1, len(comps))]:
            dc_code(k, blk)
            if not progressive:
                ac_code(k, blk)
    if nacc:
        put(0x7F, 8 - nacc)
    if progressive:
        for k in range(len(comps)):
            scans.append(bytes(out))
            out, acc, nacc = bytearray(), 0, 0
            across = -(-(w * (sh if k == 0 else 1)) // (8 * sh))
            for row in blocks[k][:-(-(h * (sv if k == 0 else 1)) // (8 * sv))]:
                for blk in row[:across]:
                    ac_code(k, blk)
            if nacc:
                put(0x7F, 8 - nacc)
        scans.append(bytes(out))

    def seg(marker: int, body: bytes) -> bytes:
        return bytes([0xFF, marker]) + struct.pack(">H", len(body) + 2) + body

    sof = struct.pack(">BHHB", 8, h, w, len(comps)) + bytes(
        [1, sh << 4 | sv, 0, 2, 0x11, 1, 3, 0x11, 1, 4, 0x11, 1][:3 * len(comps)])
    head = b"" if abbreviated else _jpeg_tables()[2:-2]
    sel = bytes([len(comps), 1, 0x00, 2, 0x11, 3, 0x11, 4, 0x11][:1 + 2 * len(comps)])
    if progressive:
        body = [seg(0xDA, sel + bytes([0, 0, 0])), scans[0]]
        for k in range(len(comps)):
            body += [seg(0xDA, bytes([1, k + 1, 0x11 if k else 0x00, 1, 63, 0])), scans[k + 1]]
    else:
        body = [seg(0xDA, sel + bytes([0, 63, 0])), bytes(out)]
    return b"".join([b"\xff\xd8", b"" if abbreviated else seg(0xE0, b"JFIF\0\x01\x01\0\0\x01\0\x01\0\0"),
                     b"" if adobe is None else seg(0xEE, b"Adobe\0\x64\0\0\0\0" + bytes([adobe])),
                     head[:head.find(b"\xff\xc4")], seg(0xC2 if progressive else 0xC0, sof),
                     head[head.find(b"\xff\xc4"):],
                     seg(0xDD, struct.pack(">H", restart)) if restart else b""] + body
                    + [b"\xff\xd9"])


def _jpeg_tables() -> bytes:
    """:func:`_jpeg_file`'s quantization and Huffman tables as a stream of
    tables only (SOI, DQT, DHT, EOI), a TIFF's JPEGTables."""
    import struct

    import numpy as np

    from cogview_tpu_torch.utils.jpeg import _STD_TABLES, _ZIGZAG

    n = np.arange(8)
    quant = 2 + np.add.outer(n, n) * 3 // 2
    zz = list(_ZIGZAG)
    dqt = b"".join(bytes([t]) + bytes((quant * (1 + t)).reshape(-1)[zz].tolist()) for t in (0, 1))
    dht = b"".join(bytes([(c << 4) | t]) + _STD_TABLES[c, t][0] + _STD_TABLES[c, t][1]
                   for t in (0, 1) for c in (0, 1))
    return (b"\xff\xd8\xff\xdb" + struct.pack(">H", len(dqt) + 2) + dqt + b"\xff\xc4"
            + struct.pack(">H", len(dht) + 2) + dht + b"\xff\xd9")


def _tiff_file(fields: dict, segments, bo: str = "<", big: bool = False,
               tiled: bool = False) -> bytes:
    """A TIFF (a BigTIFF where ``big``) of one image: the header,
    ``segments`` (its strips or tiles, in order), then its directory of
    ``fields`` {tag: (type, values)} (a list of ints, or bytes for types 1
    and 7), with the strip or tile offsets and byte counts of the
    segments added."""
    import struct

    off = "Q" if big else "L"
    head = (b"II" if bo == "<" else b"MM") + (struct.pack(bo + "HHHQ", 43, 8, 0, 0) if big
                                              else struct.pack(bo + "HL", 42, 0))
    offsets, pos = [], len(head)
    for s in segments:
        offsets.append(pos)
        pos += len(s)
    fields = dict(fields)
    fields[324 if tiled else 273] = (16 if big else 4, offsets)
    fields[325 if tiled else 279] = (16 if big else 4, [len(s) for s in segments])
    ifd_at = pos + (pos & 1)
    size, inline = (20, 8) if big else (12, 4)
    tail_at = ifd_at + (8 if big else 2) + size * len(fields) + (8 if big else 4)
    ifd = bytearray(struct.pack(bo + ("Q" if big else "H"), len(fields)))
    tail = bytearray()
    codes = {3: "H", 4: "L", 16: "Q", 5: "L", 8: "h", 9: "l", 11: "f", 12: "d"}
    for tag in sorted(fields):
        typ, vals = fields[tag]
        payload = bytes(vals) if typ in (1, 2, 7) else struct.pack(
            bo + codes[typ] * len(vals), *vals)
        count = len(vals) // 2 if typ == 5 else len(vals)
        if len(payload) <= inline:
            value = payload.ljust(inline, b"\0")
        else:
            value = struct.pack(bo + off, tail_at + len(tail))
            tail += payload + b"\0" * (len(payload) & 1)
        ifd += struct.pack(bo + "HH" + off, tag, typ, count) + value
    ifd += bytes(8 if big else 4)
    return (head[:4] + struct.pack(bo + off, ifd_at) if not big else
            head[:8] + struct.pack(bo + "Q", ifd_at)) + b"".join(segments) + bytes(
        ifd_at - pos) + bytes(ifd) + bytes(tail)


def _fax_rows(bits, comp: int, options: int = 0, k: int = 4) -> bytes:
    """CCITT-coded rows of ``bits`` [h, w] (1 = black): TIFF compression 2
    (modified Huffman, each row ending on a byte), 32771 (on a 16-bit
    word), 3 (Group 3: an EOL before each row, then the row 1-D, or where
    T4Options bit 0 is set a tag bit and every ``k``-th row 1-D, the others
    2-D; bit 2 pads each EOL to end on a byte) or 4 (Group 4: every row
    2-D, then EOFB)."""
    import numpy as np

    from cogview_tpu_torch.utils import ccitt

    h, w = bits.shape
    out = []

    def put(code: str) -> None:
        out.append(code)

    def length() -> int:
        return sum(len(c) for c in out)

    def run(n: int, colour: int) -> None:
        codes = ccitt.BLACK_CODES if colour else ccitt.WHITE_CODES
        while n > 2560:
            put(codes[2560])
            n -= 2560
        if n >= 64:
            put(codes[n // 64 * 64])
        put(codes[n % 64])

    def changes(line):
        """The changing elements of a line (an imaginary white pixel before
        it), then w twice."""
        d = np.flatnonzero(np.diff(np.concatenate([[0], line])))
        return [int(x) for x in d] + [w, w]

    def one_d(line) -> None:
        c = changes(line)
        a, colour = 0, 0
        for x in c[:-2] + [w]:
            run(x - a, colour)
            a, colour = x, 1 - colour
            if x == w:
                break

    def two_d(line, ref) -> None:
        cl, cr = changes(line), changes(ref)
        a0, colour = -1, 0
        while a0 < w:
            a1 = next(x for x in cl if x > a0)
            # b1: the first change on the reference line right of a0 whose
            # colour is not a0's (an even index starts black)
            b1 = next(x for i, x in enumerate(cr) if x > a0 and (i % 2 == colour or x == w))
            b2 = next(x for x in cr if x > b1) if b1 < w else w
            if b2 < a1:
                put(ccitt.MODE_CODES[ccitt.S_PASS, 0])
                a0 = b2
            elif abs(a1 - b1) <= 3:
                d = a1 - b1
                put(ccitt.MODE_CODES[(ccitt.S_V0, 0) if d == 0 else (ccitt.S_VR, d) if d > 0
                                     else (ccitt.S_VL, -d)])
                a0, colour = a1, 1 - colour
            else:
                a2 = next((x for x in cl if x > a1), w)
                put(ccitt.MODE_CODES[ccitt.S_HORIZ, 0])
                run(a1 - max(a0, 0), colour)
                run(a2 - a1, 1 - colour)
                a0 = a2

    ref = np.zeros(w, np.uint8)
    for y in range(h):
        line = bits[y].astype(np.uint8)
        if comp == 3:
            if options & 4:
                put("0" * ((4 - length()) % 8))
            put(ccitt.EOL)
            if options & 1:
                put("1" if y % k == 0 else "0")
        if comp in (2, 32771) or (comp == 3 and (not options & 1 or y % k == 0)):
            one_d(line)
        else:
            two_d(line, ref)
        if comp in (2, 32771):
            put("0" * ((-length()) % (8 if comp == 2 else 16)))
        ref = line
    if comp == 4:
        put(ccitt.EOL * 2)
    code = "".join(out)
    code += "0" * (-len(code) % 8)
    return int(code, 2).to_bytes(len(code) // 8, "big") if code else b""

def _gif_file(img) -> bytes:
    """A GIF of ``img`` [h, w, 3] uint8 on a fixed palette of 4 levels a
    channel (64 colours), LZW-coded with an 8-bit minimum code size."""
    import struct

    h, w = img.shape[:2]
    idx = ((img[..., 0] >> 6) * 16 + (img[..., 1] >> 6) * 4 + (img[..., 2] >> 6)).reshape(-1)
    palette = bytes(85 * ((i >> s) & 3) for i in range(256) for s in (4, 2, 0))
    clear, end = 256, 257
    table, nxt, size = {bytes([i]): i for i in range(256)}, 258, 9
    codes, cur = [(clear, 9)], b""
    for p in idx.tolist():
        grown = cur + bytes([p])
        if grown in table:
            cur = grown
            continue
        codes.append((table[cur], size))
        if nxt < 4096:
            table[grown] = nxt
            nxt += 1
            if nxt > (1 << size) and size < 12:
                size += 1
        cur = bytes([p])
    codes += [(table[cur], size), (end, size)]
    acc = nacc = 0
    data = bytearray()
    for code, length in codes:
        acc, nacc = acc | (code << nacc), nacc + length
        while nacc >= 8:
            data.append(acc & 0xFF)
            acc, nacc = acc >> 8, nacc - 8
    if nacc:
        data.append(acc)
    blocks = b"".join(bytes([len(data[i:i + 255])]) + data[i:i + 255]
                      for i in range(0, len(data), 255))
    return (b"GIF89a" + struct.pack("<HHBBB", w, h, 0xF7, 0, 0) + palette
            + b"," + struct.pack("<HHHHB", 0, 0, w, h, 0) + b"\x08" + blocks + b"\x00;")


def _damaged(data: bytes, seed: int) -> bytes:
    """``data`` with 1 to 3 bytes at offsets 20 and on overwritten, from a
    seed."""
    import numpy as np

    rng = np.random.RandomState(seed)
    out = bytearray(data)
    for _ in range(rng.randint(1, 4)):
        out[rng.randint(20, len(out))] = rng.randint(256)
    return bytes(out)

def _damaged_files() -> dict:
    """The files of phase 23c -> {name: bytes}: a seeded 96 x 128 picture
    (a smooth gradient and noise) as a baseline JPEG, the same with a
    restart marker every 2 MCUs, and a GIF, each damaged by the script: 1
    to 3 bytes overwritten from seeds, as in a crawl, and one edit each
    for a rule of libjpeg-turbo's or Pillow's the readers follow (a marker
    inside the scan data, a lost or forged restart marker, a lost end of
    image, a zero-length or lengthened GIF sub-block, GIF data cut short).
    Named .jpg and .png as a crawl mislabels files."""
    import numpy as np

    rng = np.random.RandomState(37)
    h, w = DAMAGE_SIZE
    img = _gradient_image(rng, h, w)
    img = np.clip(img.astype(np.int64) + rng.randint(-20, 21, img.shape), 0, 255)
    img = img.astype(np.uint8)
    jpeg, rst, gif = _jpeg_file(img), _jpeg_file(img, 2), _gif_file(img)

    def edit(data: bytes, at: int, new: bytes) -> bytes:
        return data[:at] + new + data[at + len(new):]

    def scan_start(data: bytes) -> int:
        i = data.index(b"\xff\xda")
        return i + 2 + (data[i + 2] << 8 | data[i + 3])

    mid = (scan_start(jpeg) + len(jpeg)) // 2
    rsts = [m.start() for m in re.finditer(rb"\xff[\xd0-\xd7]", rst)]
    blocks, at = [], 13 + 768 + 10 + 1  # GIF: the sub-blocks' size bytes
    while gif[at]:
        blocks.append(at)
        at += 1 + gif[at]
    files = {
        "jpeg_rst_in_scan.jpg": edit(jpeg, mid, b"\xff\xd3"),
        "jpeg_eoi_in_scan.jpg": edit(jpeg, mid, b"\xff\xd9"),
        "jpeg_dht_in_scan.png": edit(jpeg, mid, b"\xff\xc4"),
        "jpeg_eoi_lost.jpg": edit(jpeg, len(jpeg) - 2, b"\x00\x00"),
        "rst_lost.jpg": edit(rst, rsts[4], b"\x37"),
        "rst_forged_next.png": edit(rst, rsts[4] + 1, bytes([0xD0 + 5 % 8])),
        "rst_forged_prior.jpg": edit(rst, rsts[4] + 1, bytes([0xD0 + 3 % 8])),
        "rst_forged_far.jpg": edit(rst, rsts[4] + 1, bytes([0xD0 + 8 % 8])),
        "rst_reserved_marker.png": edit(rst, (rsts[6] + rsts[7]) // 2, b"\xff\x05"),
        "gif_zero_block.png": edit(gif, blocks[len(blocks) // 2], b"\x00"),
        "gif_longer_block.jpg": edit(gif, blocks[len(blocks) // 2], bytes([255 if gif[
            blocks[len(blocks) // 2]] < 255 else 254])),
        "gif_data_cut.png": gif[:blocks[2 * len(blocks) // 3]] + b"\x00;",
        "gif_trailer_lost.jpg": gif[:-2],
    }
    for kind, base, seeds in (("jpeg", jpeg, (1004, 1011, 1023, 1042)),
                              ("rst", rst, (1002, 1017, 1030, 1055)),
                              ("gif", gif, (1001, 1006, 1019))):
        for seed in seeds:
            files[f"{kind}_seed{seed}.{'png' if seed % 2 else 'jpg'}"] = _damaged(base, seed)
    return files


def _outcomes_phase(torch, vqvae, work: str, label: str, files: dict, outcomes: dict) -> tuple:
    """Phases 23c and 23d: each of ``files`` decoded on the card's host,
    without Pillow, ending as Pillow 12.1 ends it (``outcomes``: "skip",
    or the SHA-256 of the RGB array it reads), then the folder through
    ``cli.preprocess --task text2image --device cuda``: a row for each file
    read, the rest skipped, every row's codes the card's img2code of the
    arrays read -> (the host ms of each file's decode, rows, skipped)."""
    import contextlib
    import hashlib
    import io

    import numpy as np

    from cogview_tpu_torch.cli import preprocess
    from cogview_tpu_torch.models import convert
    from cogview_tpu_torch.models.vqvae import decode_image, to_model_input
    from cogview_tpu_torch.preprocess.raw_datasets import DECODE_ERRORS
    from cogview_tpu_torch.utils.image_errors import UnsupportedImageError

    _check(sorted(files) == sorted(outcomes), f"{label}'s files are not its table's")
    folder = os.path.join(work, label)
    os.makedirs(folder)
    host_ms, read = {}, {}
    for name, data in files.items():
        with open(os.path.join(folder, name), "wb") as f:
            f.write(data)
        t = time.perf_counter()
        try:
            got = decode_image(data)
        except UnsupportedImageError as e:
            _fail(f"{name}: named as a format the port does not read ({e})")
        except DECODE_ERRORS:
            got = None
        host_ms[name] = (time.perf_counter() - t) * 1000.0
        outcome = "skip" if got is None else hashlib.sha256(
            np.ascontiguousarray(got).tobytes()).hexdigest()
        _check(outcome == outcomes[name],
               f"{name}: the port's outcome is not Pillow's ({outcome[:12]})")
        if got is not None:
            read[name] = got
    names = sorted(files)
    caps = os.path.join(work, f"{label}.tsv")
    with open(caps, "w") as f:
        for i, name in enumerate(names):
            f.write(f"{name}\t" + " ".join(f"word{(i + k) % 50}" for k in range(5)) + "\n")
    vq_path = os.path.join(work, "vqvae_released.pt")
    out = os.path.join(work, f"{label}.bin")
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        rc, log = _run_quiet(preprocess.main, [
            "--task", "text2image", "--image-source", folder, "--text-source", caps,
            "--img-tokenizer-path", vq_path, "--output", out, "--batch-size", "32",
            "--device", "cuda"], txt_tokenizer=WordTokenizer())
    print(err.getvalue(), end="")
    _check(rc == 0, f"preprocess text2image over the {label} folder failed")
    skipped = re.search(r"skipped (\d+) undecodable", err.getvalue())
    skipped = int(skipped.group(1)) if skipped else 0
    rows = np.fromfile(out, np.int32).reshape(-1, 64 + 1024)
    _check(rows.shape[0] == len(read) and skipped == len(files) - len(read),
           f"{rows.shape[0]} rows and {skipped} skipped from {len(read)} files Pillow reads "
           f"and {len(files) - len(read)} it does not")
    params = convert.load_vqvae_checkpoint(vq_path, torch.device("cuda"))
    kept = sorted(read)
    x = torch.from_numpy(np.stack([to_model_input(read[n], 256) for n in kept])).cuda()
    own = vqvae.img2code(params, x).cpu().numpy()
    _check(np.array_equal(own, rows[:, 64:]),
           f"the {label} folder's codes differ from the card's img2code of the arrays read")
    return host_ms, rows.shape[0], skipped


def phase_damaged_files(torch, vqvae, work: str, smi: str) -> None:
    """Phase 23c: damaged JPEG and GIF files on the card's host, without
    Pillow, each ending as Pillow 12.1 ends it (DAMAGED_OUTCOMES:
    skipped, or the SHA-256 of the RGB array it reads), then through the
    preprocess CLI on the card (see the module docstring)."""
    t0 = time.perf_counter()
    files = _damaged_files()
    host_ms, rows, skipped = _outcomes_phase(torch, vqvae, work, "damaged", files,
                                             DAMAGED_OUTCOMES)
    h, w = DAMAGE_SIZE
    print(f"damaged files ({smi}; host decode of {h} x {w}, ms): "
          + ", ".join(f"{n} {host_ms[n]:.1f}" for n in sorted(files)))
    print(f"damaged files: {len(files)} files as Pillow ends them, {rows} rows, "
          f"{skipped} skipped, codes equal to img2code of the arrays read; mean host decode "
          f"{sum(host_ms.values()) / len(host_ms):.1f} ms; phase {time.perf_counter() - t0:.1f} s")


TIFF_SIZE = (96, 128)  # phase 23d's pictures, h x w
# phase 23d's files as Pillow 12.1 ends them (Image.open(...).convert("RGB")
# on this script's files): "skip" where it raises, else the SHA-256 of the
# RGB array it reads; tests/test_torch_image_tiff.py holds this table to
# live Pillow
TIFF_OUTCOMES = {
    'bigtiff.png': '65bd03b5d09052b2f7b2b54089e648dfc8fc89ec94da7d74048e9b39ae99c52e',
    'dir_counts_lost.png': '65bd03b5d09052b2f7b2b54089e648dfc8fc89ec94da7d74048e9b39ae99c52e',
    'dir_planar_3.jpg': 'skip',
    'fill_order2.jpg': '65bd03b5d09052b2f7b2b54089e648dfc8fc89ec94da7d74048e9b39ae99c52e',
    'float_predictor3.png': '85e62a8d9b01786f1fd3f7c8cc2a194b7214c7f9a7f84bd344f47ba212dff479',
    'gray16_predictor2.jpg': '93c11643664e45d5c0698eb690c9162789f01ba58f36b09ba1bc9cd3b9d49603',
    'gray4.jpg': '74cd85aa38e6a7fbf01eb17cc1544e6217101b8dec9a583f8877b8bfa47520d2',
    'group3_2d.png': '52fb64ae19cfed462fae8706a230308432e9ab74e52bdd11c6fb894455100d73',
    'group4.png': '52fb64ae19cfed462fae8706a230308432e9ab74e52bdd11c6fb894455100d73',
    'jpeg_rgb.jpg': 'aff0af3b3f84feaa41c20cb5b4028d09013ffb24ea18e52cc648705b051fbe6d',
    'jpeg_tiles.png': 'd0c3f559caaabfb5a00eb0d76a198e2ecb668abe28311b2fff85a787d527bf0f',
    'jpeg_ycbcr.jpg': 'bac860735c29ef9cb6a1066a7601d5c892c3fd61cebee97abd72811aec5a282c',
    'lzma.jpg': '65bd03b5d09052b2f7b2b54089e648dfc8fc89ec94da7d74048e9b39ae99c52e',
    'rgb16_big_endian.png': '42f17fbb64d792acc8e8fa967d8c78e422e8f8cdfb90dc2de77430fcf144a7cf',
}


def _tiff_files() -> dict:
    """The files of phase 23d -> {name: bytes}: a seeded 96 x 128 picture
    (the gradient and noise of phase 23c) in the TIFF layouts and codecs
    the port reads, written by the script's own writers:
    BigTIFF, 4-bit grayscale, FillOrder 2, 16-bit grayscale (predictor 2),
    16-bit RGB (big-endian), floating point with predictor 3, Group 3 2-D
    and Group 4 fax, JPEG in YCbCr 2 x 2 (strips, the last short), in RGB
    and in tiles that pass the image's edges, LZMA, and two damaged
    directories (a PlanarConfiguration of 3, which libtiff refuses, and a
    StripByteCounts lost, which libtiff estimates)."""
    import lzma
    import struct

    import numpy as np

    rng = np.random.RandomState(41)
    h, w = TIFF_SIZE
    img = _gradient_image(rng, h, w)
    img = np.clip(img.astype(np.int64) + rng.randint(-20, 21, img.shape), 0, 255)
    img = img.astype(np.uint8)
    gray = img[..., 1]

    def fields(photo, bits, spp, comp, more=None):
        f = {256: (4, [w]), 257: (4, [h]), 258: (3, [bits] * spp), 259: (3, [comp]),
             262: (3, [photo]), 277: (3, [spp])}
        f.update(more or {})
        return f

    def be16(a):
        return a.astype(">u2").tobytes()

    def deflate_rows(rows: np.ndarray, pred: int = 1, n: int = 1, bo: str = "<") -> bytes:
        """Rows of native samples, differenced (predictor 2), as Deflate."""
        if pred == 2:
            rows = rows.copy()
            rows[:, n:] = rows[:, n:] - rows[:, :-n]
        return zlib.compress(rows.astype(rows.dtype.newbyteorder(bo)).tobytes())

    files = {}
    g16 = gray.astype(np.uint16) * 257 // 3 + (np.arange(w, dtype=np.uint16) * 7)[None]
    files["gray16_predictor2.jpg"] = _tiff_file(
        fields(1, 16, 1, 8, {317: (3, [2])}), [deflate_rows(g16, 2)])
    files["rgb16_big_endian.png"] = _tiff_file(
        fields(2, 16, 3, 8), [zlib.compress(be16(img.astype(np.uint16) * 257 + 100))], bo=">")
    f32 = (gray.astype(np.float32) * 1.3 - 20).reshape(h, w)
    planes = f32.astype("<f4").view(np.uint8).reshape(h, w, 4)[..., ::-1].transpose(0, 2, 1)
    planes = planes.reshape(h, 4 * w).astype(np.int16)
    planes[:, 1:] -= planes[:, :-1].copy()
    files["float_predictor3.png"] = _tiff_file(
        fields(1, 32, 1, 8, {317: (3, [3]), 339: (3, [3])}),
        [zlib.compress((planes & 255).astype(np.uint8).tobytes())])
    g4 = (gray >> 4).astype(np.uint8)
    files["gray4.jpg"] = _tiff_file(fields(1, 4, 1, 1), [
        ((g4[:, 0::2] << 4) | g4[:, 1::2]).tobytes()])
    rev = np.array([int(f"{i:08b}"[::-1], 2) for i in range(256)], np.uint8)
    files["fill_order2.jpg"] = _tiff_file(fields(2, 8, 3, 8, {266: (3, [2])}), [
        rev[np.frombuffer(zlib.compress(img.tobytes()), np.uint8)].tobytes()])
    files["bigtiff.png"] = _tiff_file(fields(2, 8, 3, 8), [zlib.compress(img.tobytes())],
                                      big=True)
    files["lzma.jpg"] = _tiff_file(fields(2, 8, 3, 34925), [
        lzma.compress(img.tobytes(), format=lzma.FORMAT_XZ, check=lzma.CHECK_NONE)])
    bits = (gray > 128).astype(np.uint8)
    files["group3_2d.png"] = _tiff_file(fields(0, 1, 1, 3, {292: (4, [5])}),
                                        [_fax_rows(bits, 3, 5)])
    files["group4.png"] = _tiff_file(fields(0, 1, 1, 4), [_fax_rows(bits, 4)])
    tables = _jpeg_tables()
    strips = [_jpeg_file(img[y:y + 40], abbreviated=True) for y in range(0, h, 40)]
    files["jpeg_ycbcr.jpg"] = _tiff_file(
        fields(6, 8, 3, 7, {278: (3, [40]), 347: (7, tables), 530: (3, [2, 2])}), strips)
    files["jpeg_rgb.jpg"] = _tiff_file(fields(2, 8, 3, 7, {347: (7, tables)}), [
        _jpeg_file(img, sampling=(1, 1), ycc=False, abbreviated=True)])
    padded = np.pad(img, ((0, 128 - h), (0, 160 - w), (0, 0)), mode="edge")
    tiles = [_jpeg_file(padded[y:y + 64, x:x + 80], abbreviated=True)
             for y in (0, 64) for x in (0, 80)]
    files["jpeg_tiles.png"] = _tiff_file(
        fields(6, 8, 3, 7, {322: (3, [80]), 323: (3, [64]), 347: (7, tables)}), tiles,
        tiled=True)
    files["dir_planar_3.jpg"] = _tiff_file(fields(2, 8, 3, 8, {284: (3, [3])}),
                                           [zlib.compress(img.tobytes())])
    lost = bytearray(_tiff_file(fields(2, 8, 3, 8), [zlib.compress(img.tobytes())]))
    at = struct.unpack_from("<I", lost, 4)[0]
    for i in range(struct.unpack_from("<H", lost, at)[0]):
        if struct.unpack_from("<H", lost, at + 2 + 12 * i)[0] == 279:  # StripByteCounts
            struct.pack_into("<H", lost, at + 2 + 12 * i, 65000)  # now a tag nobody reads
    files["dir_counts_lost.png"] = bytes(lost)
    return files


def phase_tiff_files(torch, vqvae, work: str, smi: str) -> None:
    """Phase 23d: TIFF layouts, codecs and damaged directories on the
    card's host, without Pillow (TIFF_OUTCOMES), then through the
    preprocess CLI on the card (see the module docstring)."""
    t0 = time.perf_counter()
    files = _tiff_files()
    host_ms, rows, skipped = _outcomes_phase(torch, vqvae, work, "tiff", files, TIFF_OUTCOMES)
    h, w = TIFF_SIZE
    print(f"tiff files ({smi}; host decode of {h} x {w}, ms): "
          + ", ".join(f"{n} {host_ms[n]:.1f}" for n in sorted(files)))
    print(f"tiff files: the LZMA strip read to its table's hash by the stdlib lzma in "
          f"{host_ms['lzma.jpg']:.1f} ms")
    print(f"tiff files: {len(files)} files as Pillow ends them, {rows} rows, {skipped} "
          f"skipped, codes equal to img2code of the arrays read; mean host decode "
          f"{sum(host_ms.values()) / len(host_ms):.1f} ms; phase {time.perf_counter() - t0:.1f} s")


# phase 23e's Zstandard strips, made with Pillow 12.1's libzstd 1.5.7 (the
# card's host has no zstd writer): the green channel of phase 23d's picture
# as one frame streamed at level 3 (no content size, no checksum), and the
# same with predictor 2 applied, in one frame at level 19 with its content
# size and checksum; tests/test_torch_image_tiff_codecs.py holds both to
# Pillow's libzstd
ZSTD_GRAY = (
    "KLUv/QBYHXUBCgB7ujcwhBj4ATXDzN/uC6U/lP5QOrYj613XdejDONIvzLsOVHR4/tHnYeZcfBZXSnEHAAAAAAAAAAAC"
    "uguTC3oLIT8cGQ8hDxYHLiASdBiQIQAQComEBIqGDYsQoB6pTxBUVViVWV2bG59eXZ+43WWk5/ma8T6ECPPNt3sPh6/v"
    "dETAxUcyYeDe2FjZ3hVaNi0LZQXS7mCfZIimVCOdoWeQzkcNEAfNT4k0BsgGZirH6sn6Bad9szsDvDNchM9RXHpsRqIZ"
    "GQw+Li42NhQQLFQQUIAD4wJCg8bFJqbGKnW0RdK6xvHZdQ+9huDu2VzOo9lzCHXKv91uNssfJdfmM9iwcRBukC2Mjw2M"
    "60yLJTOSJl2TcKZALUXRlJkRD56QGBMQEJggGqgQUBJQdScri2SlshubWxPss8uDG8GclGDQPFMSJDgbNBYAAACFAhwi"
    "SkoeTihQnNChmJ6koenRElocm5yYXBiQrzy45pfN63WaUg7X+yXpfUrKN979jfeFw3+Hh2Bab1RXZ15dWqEfoOwViuiH"
    "aGYFpobjGZX5AIGZSekAkjmiUnWSmLBbs7A2trqyRLw9bxhm50VG5mnhRClh8JgYoMKDAYMFxUcCDwuJFRYdoJqf6pI1"
    "qAq7zaaRvcUtMjbKy+QyeIxvEN+EozHP/3c+3qe/zYOBjOi4Rba+ry8yLLitVlZ2ysen50WGpYWlJIdmBwqNfsi4jKBA"
    "d1ZWUlaKrEA/0q4wrq3VmR9cHTnR58bl5EOmwuKjgsFHiAIBCQQgQIQCEAYLFAcUaAuKUI4Mz5Tnyjq1xaZmt3fHd4hI"
    "Nuvv7bJczZbv4WvJBv91P95/M6q7euNAwzo/Nbs0Nu4YlHbIOsREU4ME9MTB4XliiNzMbMzEtOSUrMzUxPBMn6RUWaMl"
    "La+3PcG+vr0omB0gHJGQjQwVBQgaGBwAISDBB0UBEgZEUCIwMmY4ep461BsiLTOqKi46vcM4Qb7zG/+XFI/9lZJ3TEtK"
    "B5qZmWr0eO+eMwbO0b0FxnHp1WmxYNyipSUkqJyUmJsc58wHDkcKiAnKBA2NiAwIDw1MyozS1bqtXrXe1uTIGu1+omCS"
    "Vk5yXCJSQBAkLEjgYQABiQEYeCQwOGxMdKi8wEB7okHarZSbXcsaC5QjTAQ/wtX/ddv9tsf3mXjIf16vNo/b78VBQEc8"
    "tkU/MDwu96p1pboSRTG5zOgYvYyohKxcYFRgQGMeZGJAYGZKTHiGmIBqoI6krtirO0HDPyykqemQDsjKRlQCJYEiwcAF"
    "BgQHhwAiB0pMJjpaPlBCjKJMRVDcpigssTbCwj44RUFDNPo+GR/T+ZvwCJHytjwPzzOKu2E+tF2jnR6hmFXaU1VLq8jJ"
    "Z8eIhgjnA4fFIuaZseF8eaJslMhkrISMyOTEsEQlYbO0ZGpUe905JKolHCjOTYkzZeVDA0GJQoMDxUYBjwoRCRKJhxSN"
    "lxmoztFTDRPV6sSVplXY/YbZ4Xo4UXxZxps1HRxQfyCpSY6zz+AyWj3YCH6T27vbmrs6w2q7pqg0LUpF0GgLDoWTAsVE"
    "ZEHhydLgQBKtAQGBGikBDfn8aGnN6uDK9KaIlpp+kmB+dkxWXBhCEiAIccggQKBiAI2GDYenx8vISckKDJTo6AdrCq2q"
    "TjBODXzYeK6/GyPd9s3LTTuEfJ0fx7P1f7dhvexF3xUuhnmpaXWVVRkZIRG50LTk7OiQwFRkuHScTDwfQhQoSp4gTgyd"
    "HphojJHVUlfYl1uW15YY98cHaWmmY6VFwiQKcoDigIEDAjgjEjoWFjAoYHDQvNwY1QQRPWGzW2xXfHZ4gYfotddLHs/z"
    "+0r5na6H39F7thy/mBh3POyG/bp1cnlaVl5dVUJRRVMkoqOdE52REhGJqIKTI0MC+gFVkfig4QDKyYHeICURkXllcdW+"
    "vLqShJakMUM+MTYmFwkiEQsiLiYqDjAY4EHBAkUFFGPkxAMmKcYGCIiKCo3tDs/NMXCxPLjohu/ndkx/e1OvrsvVd0v0"
    "/jGxvHe4B5gYaCfHFmbdJkUV1RAdreTYvGjEaIRkSECfC0ycDScQHBUeThSemRlqFPUqe+UV1XVWrSLxSAklHaG4QGWc"
    "TgkJAzgcDFRIdHQsEGDg7NhwmXHhePmx4XGyPnG1xXHdzryJY7TXvJfPKf+U+EtJuuQc0t6nDI/n4kQyIOAhXGJaXF7Y"
    "k1KSUBFO0FHPUU3OjMrHBQRHA4MIjBMQE4UPFwoMlZKdHh+nph+gqxhVnFVZF1Q26chnqGYmJKfkY2EhZKThIwEAEggk"
    "EGGA4JiQiNCAeYb8DF2ZptIpq5tdWZrceDy4aEi/4/V+yMoHek03G813X0be8d/DRr/yWI6MsO5qak0pC+kI6EnIB4WD"
    "YyOlY4MiwcRIgsIGgxQQiA4oRYYMNBrDU1VS8tpauWWtZSUxTU093UCFRm6iz+dTI8TCQEKFAkfExQIPBc+Hh6jOR8yK"
    "TA61qnoWx2b35xc4WBaMG8Yl0+i8g/k+fonvV+L9bsc0PEzYuEjnCNdGBjc39lQ1xaPVsZmJgmR8uIi4QB9QFDYYLpwP"
    "CUhSJlQwNFheiISqRtkpLa24L6sur6srLBCQj0lI1PkioZHivBjgQyHBhYPGRMWCQohKynPFp8iGKtWRmoZlv84KF/vo"
    "xoRxL/qRLp5v2iHU6fp0/6+f+9fyRkPFRj5DPb22MrkoLjdqiicGKfpzMvKC4rxISQmZ0MiQoMDwYJBIid48dVh8fqhI"
    "R1Zu2ljZHJkYdsoJh8boZMXjwwVCQoLAAoIKADgZHIgA4RDpAHkpCQFBCcIx2glqkhrjbq3x9d017s0R5ek9OX65Rle2"
    "Hzy4vPf9ekg04+B3DZ7DWzurIzNj6nLCosrcqMjshKCwlFxcODgLgHBAJEBQKKBAQZmReQGpyXGJ0T5hBcXU5ryqtqqe"
    "hqBUZn6cGCvQDAynQgOIRgNHhgAiLCAUPkJWLFRMcKJH16UmsCtrV52eH5ubV/HxfSh3k9PseSU/c96+5NvfanbjXXAR"
    "T6+RcYy714U1NQ1Kmi651EBBMC5INB4UMCJEIgxAIIAwedCAeKK00DxVlHKcrkF4bWF+ZU9lVVc7UTo0Nz0nKTDPDQ+M"
    "AwUMsCACwUUCBAoJDicRKBoyPCMvM1FCUktUqrW5NjPFrp2hY3x/V8v3mfN65maDf2Y+bZc3ih8JzY2NbWZqbG5ZLa4s"
    "qhsonSEglA4aEoeLExGFhoeQBRwWDAkpDiwlFi46KEFBRlSlRbhCOi2uFcqIyCZnRkdnB3oS0vIAQkFiUSCBwUMBjYwJ"
    "D5AOjYuYmZcfGyds1lXZlkwOLA0P0Y7PfMeX2/j3vQGEteZa0v2nxyHRkG27oKOf97s3VoalLeOK2laRlI5kTG5SMiIy"
    "MC4YRHBEDHBRUTEx4mxwkjxpRJCEamz8/tD8wsC20rKsVKHqDpGKjo0MiEqDAQqFBQYDMKDIcKAowOCD4mTl4iYmBZpE"
    "JdWVFaWWtvUnKCafy2ZFct0yU47uY87f+Ht/j2kmswvrXm/j4aAZHzer9YWkZHUimtFh6ZAhAdnoKAm52JgAYRAhQdGA"
    "4KIDWlJDE3KSNIOGu/OC9cWxhS1l8UTp/EBJMp4xzxKngQMfC84FADBwQGxkmIi0oFh0cBDNKDlFEW01YeG27OraBslv"
    "9BfMPtfbdUvMy0t5Gw13W97H4XAYsC98+AbI12WGrcoi2lmqSZHB8XixEHlSLDidFAVsWCgcSDBBIdJQopETckOdKooH"
    "1dL+7MayXlcnIycYpCKakpIVEoYMAxISJCA6PBJoSESQmGicRNTQ/Bjt6NAcaavX7FZbXqHjYyMiIR5Or0u2zftNtd6u"
    "eWmfjHxU/Hq96scx4l8YnJ3UFFMVSPqjw6Iio3LiLKkw4EyIoJhYUEGAxkIJxIRLCEyHyEuNo5gRjNhFi5u7Vp+mPUXS"
    "oyCWDafFgwNGSYaC8yLhYcGDRUgCBUoE9GbE5eaFRkhJKqktjK6tjHCRDo1+PN/RenWlZb9uCVl/oPmO/9dkvNdRsEx4"
    "VtfHF4b2ZeXkFAPE8uSo0fgYSTCRmBBxCLlIkFFAQuGAw0nUQuPkxyYXDgrPFZenyknQEA8RFNGSlxod3NpgXJ5iISIj"
    "Hh0Xa+rllnf55gM3JOX4LAk/392Jiop9bXV3eHJt2azYE5GW0ZEQzw6O9SoERJWyTlkZPTVZs9SqLy7WFerLjSzOTIuO"
    "7MxQMVGQELDRsX7oX5flmev9/4DK9rkOz4shEiicGtAUExQaEZQhJCYlqinu2NYLr7EusFFNqAaT5fjLSko83c+ffOPH"
    "5Lx7PH7cExx0c6OjQxMrW9tikbKepLJYP0xUQ1drkxUrzSYhVcGmVVFZryTuNWoLSzbGtXeGJud1O+zykdHkrlgNGZ6f"
    "33pLyks6v+5nOycUEnxAgDxPXoB0XqRYqqLq9mwujQ8tj+ztvt3tvz89P7MjL/VufvqtJvPVjGHyISDjHR4f2Fxd2JYX"
    "FfeIayqKKiV0JYoSGvIBQpoqOqpa+sqyGmOybqOqpqS2ZlmurbEvsre7biBeoHyQzEZPovGQDfzzBnr9ZSaaQAEFHhAJ"
    "CgxQYnpQglp6iIqIrmVgem5leIN/5sMwvgzZx8fxcPsafsD/8p8+k8H1xHA3jSe4BsZmV4amVfbUVb3iWoN+tqKOsEFM"
    "UFUtqC6sJyxSFlhXE5qTWRUY1lhWVRvXjM3NsPvmmFfumsPtsny/V//5+8jKPya/AaMABpKUBRIkLDUuMDpDTVis7dYa"
    "G1xfGuDiHN/iOFxum/WYlJLqd39yH6nG++uN63U80NEvES0tzO8LritrDCpsus3STrdYRVNsExarBDWV9PSVBDXNktL6"
    "umrigsVZadO40PjiEL95d+AyHHKvGHmJRle673kI8Lml0wGByEdFSgbDCgxLSImKzpHQUdaY2TburuuFC6PH4LtYMtNM"
    "Z1vm7w/w9/xd0v8+K57RacTuYWHgXh1WGRsUlBmYFWt65ZIaEvISyuLCJk0tUaXbLquupywrqbK1KSk0sbQzrrsztL03"
    "QkY2OtyId9//fPplPo2v+9sCaIDoMOBh5CJqsUKSo1LC4uOj1VKvaVvbuL/vYLoQ0Y3vR5L3dLo+zZ73zWdK9xo8p8cB"
    "vY52eH5jenBdblm27VKT1koLS6poCnsVtUXkRG2CwlYpSXGVoqjbMajrlkrsCm3ODs7NT9DND8/P8ItIp1tWQubxDTb9"
    "mH2IiQcOCQgDEhgUG1AY50kLEJUq9DXFVYV1J1j4tneWdx3P833k5bw+eQB9zsZs28d8c9xLqHf4R0hHZnZ3pdXC+qpy"
    "+qJuXUmPtFlKU2DaqXWbBIb1wi5ZPU1RSZmdeaFxwdDMusjC3vbwFL1dPkPE8deNNldeQujL55kCZGhocIBQfCwokaBI"
    "cUJdVpiWrk1P26irvUG4wPE5j844Bk8+0uV/S3y//0//15BuyXeh4V9iupBRz0u3pVXGlbWVhXZlvcLKWuKaOhFlFXFd"
    "JXE1XZW4WNSl7VUs6opqzI0rDs0LjxBsDW5OrFYfGur3bnibEh7Bvt8X0BBAR0YCjwaNCBQPBhQmHiM8TVBYUExQUVu9"
    "sMK4QEPz/FDeCPmWPP8dVE765ZOberVe3iY/DibSES66FX7hadF5YaHarKyywJyUsJS4S0VbVScwq7WqiAkJLGur5GUF"
    "pjQmdcVWbevGwODm1BK96jT8UB73S9LR8kxIucdFgoUHjQUXHQ0kCyQrFyUeJT9KRVJXStkrm9gfYpdP7P6+weLxWs/X"
    "VN8h55oO4HH0t6wui9uLhmA7uz29tSwvM7K2Ma6oKqmrL2sU1xWS1BDUVEq1Yru2hqyuhpqmmqpbJq0tNiurrTNBQ7ju"
    "XmHbW+hOR0ZaVubvkBQKDmBERBR4SCDxoRHyAoOT8xLdkcEJqmbL4trc5ujEfOXANXo+yS5jsiXxENJ3PN38Vrv3iobp"
    "Lx4YD7CPsOxMa22q6goLu2XliuKqcquwWC8mq6ApJKOtIyoqLSQkrinr0lXV6Wwu7E4tjy/wb05tDhOu2fE9HDLT8sGG"
    "AgMXGAQGIGBABAcEQ3TjCQJyU1QkFbpCbYGpufGdCS6K14zeMLstt8/df8zKB2g9uqx3JJcXFwfbeXh9jXlqZ1hmbnRh"
    "W1BYYWJPU9etbdFT1NEUF9dJioopCki7rcISaa9ITdwv65bZGZhcHVpeOP2oyN6365hmSPW9YySBQoSHAAkRHAwuNCJM"
    "IkKgJSQ/N0PTqtTUU7aMbu/r/WscixffenV9DvnnR6jj5w0o8Y+KdXYd7S0M9AKWvfXRyanRtaVVqcjMssS2rmFNU1RC"
    "XK0lIamqFmuq6UqElMVquZiUsF/ZOT4yM28eHN4jnLCch6/R8778YkFHh4TGR4bGxMZEwwRIBQQGz/PIx+ZHy0SFpX2r"
    "i6MLXAxkH+7Zjmt85V6zj2+Qh7P9lvK2HRE+7zOc4/ui9XXD6vK+4Ny4WU1ZSVhGWVtLTU5b1Kwkp50eapGV1NVVKetT"
    "lZWiJkVls2dXb3hzenaJ7rIZ/5ecrDxDWoRkHFBY0NjAIOD0iEigSIlpcZpEU4yuVFJOUFo6LcC2NTo/8p/43Wg/y/H9"
    "fHwzQmV73m+LyfG8e7CLLuwjVMQDw9t+vX1ptbhdUEtbRVRTJCMlHyAfnZ2mIZulqaoUduony0QlxY5pdY1Vxemt6bWZ"
    "+xgLH81gfmRZEuJkIYNBBQIMAwK4EOnY8OBwgHDejADZxERJqbZdcFV0aXqIcHuAie07Y7k8uenAEv+g/8Bcl+/hYX55"
    "3T2jw3l6gnF7cFu7MTmxKpPVk3bq6EpIqslnWjXKkfpcj5Z4pElMPDhPVkNVYtuusjWwMTS9xThAw6878TsG9/sMHiIM"
    "EwcIoOgYwOGiwuMCo0SFRUamBkcFClsk1ZLS4q4RliUKqsVsRXx4vM9ks+eS+UnIvX2vFs/pi4uLYbq9QDNBuTA3urg0"
    "sa0XVBeVy2qoCIvFY2VzpEQUhLR0I3RUUyQkRK2qKnFlsbykuGJecW6NgIN9h4fytZs/DqFQwKBERKKAhowDHA4HGD5G"
    "HCIsbGp2TnqsUyMj67WqDa5L53YOu+Pg/9ndvnTgVvfl7DkanhnOkxm/Y0NyN5Fuzu3LTG6rzoqbdQaVhPTEtETF+uH5"
    "6ZGS8lEioony4CTRSKF4ioq2SVhUTGRTcWFrenbiRsO2Oy0O20E+GBYoYCzAiDDAAsODIQJkQUZLicwIyI0Rj8wNkvUq"
    "Lbv2NpYWaIdutLsbxZOTcMjNfdoycr/WPIv198e7Y98fWI9wzvAMbY4bxxUzw4ppUVX5aEVBOf0URTE5KQERSX2iSy7T"
    "KdUp+3PVVMX14jrTC7tzAxwEP3YTxf0xjYXFBYrGxMUFiAMADFRQhIAgUPBQskJjYyRTLar+SMegxM7Q4vwC/xTref5f"
    "/JZDojPl+v+Dd4O2m5KvxjOa8xgfA98K8+TCzOq4X9gtVWsoaikJS3S0BJVkEyWaUcF5qsQIUXGAlJqAeqqsjqrWLTg8"
    "Pje9ukTvOH5WQ8bQVGxskDgTDKC48EjgXMh4cIqIkFTQ3Nw8j2hylqimTVxwYGdlbXp3XUF73PFvh+/reH96H9/T0Ws7"
    "us742PXuBQKa0b25ucW5bcu6yKbUKukTDpL0hknqsyREI/TiMuPzTILKTG2mRNcpUxUVDXvHffNDexNcGzIWtn00Xig8"
    "GEgkCGxgILAYYGMBA8SD4ZliYmIi49I0pJQ9SuKeeW2ppXkLy9/7mMyOqzfVc81K+d9+SUlZ90O2xX966T1GPG8d3djW"
    "Fts1S0U9wiIyugpCCvKpiao8cX6MojU8LCdFMixLOjo8WawnrdKUm9VfWp0bYPos9n6hHBxQCRWQCRACFEAYcIFAAAWc"
    "ChYcLk4oojw0UJugqyExLLg6O8IyOW+fuTsn+/lpeT3frtTE09f7O7q/CAlXfH/DXUDGQS8ubtsXGhQal1RVmsWhkQpV"
    "daAxR1LoTIuKTggKC5HLjc0UaggJyQpJKiotTw3OUBFQr5vYGG1bZGRrfoSG4i4b8Z1+Xz5Yu+Oa+f6/XVfv+YyLie00"
    "3B7eWZkYF9ZIu3TEA6RCs8KRAUHygWDhAQFIiEeChgyJFmjU6QTxeSGK8fmxXtnO2rYA69QK68Bj91o/n3z3/21Iyn/k"
    "5P9S0++OXFQ0oxkb1fDu8Kqyrkk+VFhsmN4fHGLYEfDr9kuO3WlK/b4SrylZObdbwuGFeLGh311eYV3dFZZMqnojXYoh"
    "EuHxsEh5sEhpiIhIyGCoUDCxAnKRMlICc8S0dIOlxBVVDdsT8+tTFBxcXLsLx5PuygaW+0i/XS4Jl7S0z9uG68M+8tcu"
    "b48tq/1qquJi48b5Bbq9gfkCEb93uzu/1sz84xu415KUlGRy+/uYiAYsHERbO4tiy26vsEk4RjIiJSkeUBYSDAmICo2G"
    "i5QNBhseHzMrLDoxTtIcLC1VlxXaVV1aGzhwvf7C6fB4ZCb+v2nvxyXPkWVL/Bmxbng+/BbW7clxs2NU0iilsGwdnNjb"
    "Y96h4/d+/6Ytz+y5Xx0hfqnHPIfr77gY0FuImCfmVve1DasqNfXk9Kh0oMRgYJiILEiAMZLB0BAiEeK08CCBGv20CCVR"
    "JS2hcams3gTvGA+7iX/hdnjuaHnGq9eYlZNpB5pqPlm8JgQko79/gV9ndFBm0yySU1Zrra3NrfHRa1iY5zv2z/03pgM3"
    "ZaUdbZ7723F7epFw/GcnhlZnvR79MPXIPH+gOxoWHyApKB4bHwo+Rhg4PDJYYJ7QF52aGSlQFZcLbWrrJRf2xvZI2F5s"
    "hx0dIfls/X3TcpLuoAGc7ujGr91/f319g31t2zAqMquXlxqWmNhc2d4XbY435vdvuKQDB+lICHL6eW9/jxv3jOFEvL23"
    "t7m9tGuWa91x+nlp+VHJiHlxLpykWIx0KEQ3NCRKNFp+bqJBTEBPVqwtFNcrjgturlsohxeIZiysx/P4d2Ves5+v3OT3"
    "x5WOiOU5Gu8PsK2t72xrCglLlMVGVRZHdmf4SLhmn9Vh+qZkJBxTMwJeT6fErJy70Y6PXb2/M0KyOzetsivr0RFL0EoJ"
    "FAPqlHj5iKo8oERXYKAoODnRFyIXl52hpeoUiwyr/VoTq8ubm3MUZDTH3ZKXa815W52OsG5gf/sl2+guGf0FpEOkU5PD"
    "wim6qmJ6u/MKmyt89At0JGS/KeOTdvuasv+OZ25CUrrFZLaiIh6jIJwX92tLTawrW12SieYEaVisZDhhXJ4ZJiElHyUu"
    "NyM1LiZIP1KlJKOrJC0yuLKxv0HCPEGvoNmQES92xIRDZsol5/UH9zw5jo/kh79evS/iGZdeVo1QUxSTWlkenlfPGwf2"
    "Ozx0ZJvxZvSlXDKeqY5EY6bzcsW6fLHxDQ/Qjo7qjIoFJfWZ6tz8BM08nx0jHycVTyfExAqKDE1OTI3RSw9QjY6Tkdap"
    "S2wbF3i4R1he9L6/hWN+5HjTQR9fSf9Lyudn82Tjo+L4HNiHh8b3tSRjVMU1S+O6Wxuk64oBCb9s8DyeKXmPTFtGuGzv"
    "73k+277oNTSD3+729tLYxsi6uDlRU5qTGB4aKMuERstGdOOk4nmysiMiIp3yAEEVWadWLC7ulWq75qe4Nw7rjb+OiY/p"
    "P90fv1vm9w02HaTlkOw9o/dRTy6MJ8eXstOzM31KCmvjSzukw/seBq7fYrM/HVmZCb9k++vs/frOvy+Sw+NunuKYGRlW"
    "k5JWaupIqUgoB+i54kEDnWFxtnSwoHyMRGtucqbUIiFslYoJi0Wzm1Pjm1NrezSjC81dumPkZHxSD7e7M+/+eOYd0vFw"
    "HTfEC9u18cXkNEl5jpzItFZ9fn+DY8UyuE1nkyfrmJjz/SWkA8lN+qX5T0ZMKw7W7a0BdllVnWVVVXuCmmJ+iE6gPTcX"
    "KCUxJSgmKxsfPiDQ6Y0Oz48UT9OWmFqZ2hp360sub66P3BbTveXy35+28/v1v6TlHFNy8r2mu9Ngcx4hnoeKzVQo6Wj6"
    "lJVj+4qri8MbKzZ+y5LsciVfrt7bIfP5u5hfdhPKvYh53TI4uiycVRvlROXzE+TzMuKR0hLTgXECreGJ5qQ8jWqWimCC"
    "qqZIStUnLy1VHBna2xnfo6AX0a04HvPxbrIm2gFac7P+f+Mh4/Pv4+IeXl7ezY1KVNqTBXvC6oJzk2PUIwwzkg3VaXfk"
    "/L+OUNfvISfPdLmbrx409JoFA//S9rSoyJCoSzY1P9CjFhoejucKjUkKCXQlCiUh8aFKqztTU1ZYpCuxsqs6Ll+dXhud"
    "YN73j9Fc9vPP/Xem+oH8HamvS74h3Xi3d3xoCCfSEkMkRK1uccukzMb0DPnwFgsPFcPzSDV+89//8w/Q6+HmObxeP0wE"
    "q8vdvzgvNrm2Ja6lnqafIJuhmKCTEZkfHJcUHpCcqI4LVIqDw3SD3YpqKoMS0wrLQoNLm1vDa+yewXFFsp6t9+cj45Hv"
    "+OQ9c5MMeV57G8ngbzQkZidaM+ND9MV13eqN0c0JDjKWF8eOZnn/DCHC2oElJX5ft0fm8132l09uDhHQqw5Kq43aSqF2"
    "pDFIPDo/JCUl0RicnhIaoxWYHh+bIWvSE9aUWJL2TI5blhY2F/fn+BX7iRPH7nA6r/nux9Nqv/x9/5fDfTm8bUgHEeV4"
    "ygAhMWFphT2NcfF9tTV612yxPu1fazZIO5BrNmgAl1vCL79+duMfojjRcM6tyywrWwb1FKTzRAVy6TkyUTE6wVExMqEZ"
    "ihr5AEmfmLBJRFhiVGhkb3Fycm53dl4+uMDH7/r7GP/v3ZB3f3r9l6sjLzPX4TQZTBaztKD0lMz4DDlVbbuutO4Cw/Ta"
    "EsWHb3bZ3caEY77VeMsG6kn+pbtdp6/VfX2Mc3dpeGZaWUdVSEROS1QWJJ0WoJboT8vMj4ySzgoVyaZmRwlb1ER9MvNC"
    "u5aVdXX9kb39+REWJi66z/u7I54Nqdej8ZRoSjj8/33jveSVFY+QHqMYoSBp1WkbttYGiNj21v0q4uX4t9wy3b7E09Vt"
    "PL2tB/cTweau1+4N8Y6MCy5NzUmI6YmKB6dGKp3uoPC4zEBfdnh4dIKOplWhrCArKi7Y09TVmlmXHBifYhufoN77ETx+"
    "97/ny0x3Jn1/Wbe8x8fvx/e9HKFRQVGSUgQEZbQjNGYFhgen183L61tsI+bT+vW5X6l5H0ClHK2WtBST6/ZAvjOY8K1r"
    "F1amtfrKTrNAVxommpbpylJONBqzU0NkNFVkQwVVncpSWX2NkY25ZaHJcZWlLX4FwePG9rqNp7/dlw4aVLLlDir9bHZ4"
    "fkf0NihcjNjg5LA0wQAtfY1ht1Z6ed05L3jQEXIeibbEVGPe83S4mxKOaU6b3/U/9h4f3N3amtucGncrCls0LWKqsTb5"
    "RIWYemZ+cGRislorJq2TVdeWq0VGZiXTSnOjAyw063v7G3zsG2yvFfVqPDsTwiYbE99G98n8MBw8kUCj44OEBzrT8tM0"
    "JdpCU9tTo9vTOysKuttotJvSASY+fq8/iPAgDr9//Y2O470/wLMyt7i7qbAtJCvRTtBNjU1ONWdqTZJpSmKKKkLCiaJO"
    "BU2ZpLDWrjO0bNwcG9lZWNcv8RDd6A6T9+D7/Q9ppmzT+eg1nm9+tJ9JLB5AYExuQnqoPDlW2zCs7NxYnqAboSF5XK7z"
    "I+Pu89uB3x7Pp/Xv/iP6aza3H//k+rxpZmNqYlNbLFWbtTYpSYF2cmykP09W603R0bQHymq7FYZFpQWLuvrqEkvj+ypb"
    "A4ybMyMWmg8ZwXV/n89G4/NrOf3NJ7/LCTIYhERMOHeiQM8XoyYq2LWNLkxubk9PkNFsd+T79ZJ2t6UcPkn3//18yUTx"
    "YHdx8I+Njs/vq+7K6/qkxb2yTnWoTTVRODNVoKefKyt16MoklaSFpYZJdZ3BRWnHuGyBbIaEandfxi74Pn7/6Wo4PA1/"
    "y9vx9ple5geREDQPkMPv67Rj3s2+/+UZguvu0sjAzLRbPTUzzxsQlJORZ0lIR0gBHRUIEAjgceDCpGFkgkTiQkXlRMrD"
    "ZPWqOsGZvREugufMcTrdX5bsu9N4egR15T69CReXz2x1Ww9MWOaXN/fFtJUiekJ6OYm+WIyMPDwgKEAAEh4LG5YRHNgn"
    "/xDUarwcjshmPKu/3jU6vrqsMa0lIRmlmRGYEI9oBIMCZ4MBEAU6KhoGmIgAQUl5eKgB4TgxYsohWqqqwsGBteUNNioC"
    "BprP4TF+Lzmv29f1fSRf8xI/jrcF0YeMjN7AOrIxq2oQUc0RdCgII0Sko6TBgEUCB0QB+8t+PFPTknKezoTT5/J5uPxX"
    "COeWVaXlZq9TPi8+O0EZKRMqGxkKCSAeFjgoMKBYMABRkUESMfISk5KzhNVyTbHWtmeAZH5/guvGeTj/vtzU1zX3lXoI"
    "/nTm3w8us9VtOzk7uT8wNKcsaU+VSMbHJcVZ8zEioeDRweAAhPnBJN6NKY/QPtsnv2+3PNEPL2zXLfPSojVVlXxqjICC"
    "VJwvFSIMFi4WEhBoWMgoUGBDAchEB0VMDIiPClV6hLSl1ES35mV4KK47o7uN67x6/K8/eFfm1xHykma1P193Jz4GMrLF"
    "fZmBnTkJGT3VyPSIhGiMOJ/OkQgQAj7ecr36QeUBbjQkZWTYvCfPw3d9eoZlf2xu2+qWVXo0fbLs3GR8bHQ4WCAg0BER"
    "AIuEkIaQEJEVFxgUkh6pk5QqqIgszcpsTG2vznyWx9+Rfv5lXK1f/y/r+kp/Ol9Ho9dvQ+/indhWqy07JXUk1eRCg3PS"
    "0iGygKHBAEbDPTOfPiCul4wQGXmWLC/ixY2KhYh3gYJ8cmRpXUc7PdGhFRcXjwuLkIQLjo4LigUCDhwFIhJITFKgIT08"
    "NDw20ivsERob1VfdXd3XvE5M9891duabTsmP8GbXH6zN/D5ennYEL97VDbqhoWGlU1VJODFGLTvPqAkGSYVFA16/btBv"
    "Y/7VcEjKPP2vh9e76/JfXdsXXxlZFJe1xylqRAODcQETTdFIqFgY4AADAQRgGKmwMFHByKggETISEspGXR1tsVx5bnmC"
    "h2tEM2TdLKmXVMvhmRH6bX5/3uevEwkTEctwcXhoeGRqZ1ztVNWHZ4aDg2WFwblBYGIc+Thph5x8IHn3/yHrdPC8LPgV"
    "VGxkjOPKitJCZadBPUkyIB42KCcaHRMlDx4JChQMGHAowACOj4cXCSiJSspUyBqEZHb1uguLQwwMdDRci/V2siU+jf9D"
    "DmDSwfxS76d/y2XFO8C1RDK5sqywKtO22sOEoiLSAZOCQcExAubj+2h7H6+ZZ+8x43hJshj8yIjo5xiHJkcXNaYd2t5U"
    "ozwrOR4rHhQWIiUdEg4ELGQQwHHABKPjwqVCJcpj4/PTlNVSr9bu7MgGBRkVG9F3OuT8nF7b5QOg+/X3fCQ+/5UnvseE"
    "hHB3YtkxLVTWSecJOpKTMUMhkqFgkf7/43VMtN++uXcQuemn4/XyRUc3oiJh4Fme3PYsiyiIJ+nIpIRG5sQjwpmAQcBC"
    "IgACVFgoZDBwLqAo+Yg5MeopuiJlJU1lseLO+t4U/woN1XFGRzNmJluupr/vdXf7/l6Pz2I/wTq7tLw6raklIi1W2lRU"
    "hCLy8sCgYwLNaK+U3G++5/XIOGT8XbeEJMvphIJ5j412amVZWKmtlXrTAwRkQiJxMYEBgUCBQoEGBo0CDSMkIikhHRY1"
    "Li5ToelU9YmqdY1zM/P6DToeshP58TRm3B+B0r/OfABfY/rdasb0mM+c59blc3MDM7sm1exAfUhWQmA4Oj4E7XdyffKe"
    "vmzwtoxwt8RsX/rZ6MHH9eDcHxogGJlXE9O2+sJSxMLyXIFOQDAwWCgggEKAjgIsJBacDSQmGyMdRUrWHawPFUuNC43v"
    "7S6RL1GQsP1nm+H3eIT75v+uicckq+now0E/Ozs4Qi+XnNRV09TaI7T0I4QDjWhoIEyDxWg/HVMeSanXP9h8w+t2vNmc"
    "ducJxvXtxXGfnrq0qIxykqIxUJIMjQUUFwoTBmAsdCi4QABy8pHAEn15DrEgxRhJNVlhXbdkgol9dX3d8PzOH781LeWS"
    "lZF1B34H6zf5bu4u7qXDdYGD2zqssKnskMzOkE/IjgqJy/sdd6fVkPe9nx8hDiHCg/gaU38eu8llMF4bWl0b2hoYVpP1"
    "6QZmZQXnY8Lj5LnAQEMABUg0XHhccKSQSGhM1ISIFKlMqdempymqL727tL1HMxysNoPRku52vg53cNmPn8ePc746zrhG"
    "4wHCreVtvZ6kemyoMSsoTxOKmEC1uNz456vLmXoIl/f7ZTufp8fvdzYhYiLiYuAdGNyZGJNWDRPNM4VFBCZkQsHCYUMB"
    "g8UECAUBBkooRJ5Pm4yUl5seHaaqllfVTM2rzW/Pi06vx2C04xkev2SrD9DM3EO643fFNd3vXAbjvZF1iWnJuLZKOCs2"
    "IlASkztCRfe67Bip2Y6c9PP59XY/83EfRzyzvYF0cmhrYXRdYGFBVEtETCUfLSIXGysqDQ0KGA44ODGcCj5QNp4hEBo4"
    "MzA6Vh/tEtnYNS0MTXBtr6sGVIfFdjs6km65l2ygGanO7Ke/dsRDxTvCOj27Mja5qLAioZ4lajQKg9FnJ7hGxL/p4sx+"
    "gwfy+QH/NL/fT7PnkIGFf9+0ur8zMuwT1lWnejPNIRkBYUF5PkgQUKBQYQCBgosRBhAoHdEalZoVE+mLtkirKsvtis0r"
    "Z5eoNwjG8/tweGbdwZ3SPZ90l/+S/8a1mN4tk98K+fi0zpqQkIiIbo5wYloYw3eO4jaimGyZ2QBfx//f9b888tzXIyIC"
    "+o3HhWeAX15UWmqUUZHOzEgHSVTGAgJFwgGjQEYCCBGPAhEMIxMyzqeQkM5LNYmLpIV2NddFt6YoSFasm79vPHlN38/p"
    "Ef6Y+TimWu7oDj8m3hECjt1poV3HwJiapISeIzl6foJ6iOb0Yptdp+81Iwcwv+vp6z1d/war5Wk7xMQ1rzc5syiin5qe"
    "npihFmhNylOFQ0ECDg0EHxEIIk5KODIyoicq0BmamuwT14pLhmWnRueXuAjYBcPpkvj5JpvPplRHyIyER1JGggvtXbAi"
    "XeBbnxYaVhi1yYdJCQZIba8bGE679X83mc2eS1biH0BogNn3V+LJ7MdHR8Y7QDi0q7ilrFJ1RyoDFKOh8oRmJCg0ODkS"
    "aIgsGAh5GNl4ZnREU2ig1SpUTxE2Lavt76vMTnDw21W3yfnKN7tO12+y/+zIf2VkI98syBhYR5eWl2YlhcVU5dT0JDWJ"
    "+/trDAQMg9fryjS6bxkJf7DHZ67Tdv8jvf5YNuuBAcm4qqy4UdUpIpmcnI+ZEJCHCQoEIgUKIICAhIsDBRBAPJRUVKjM"
    "CCHZ3GC5TNqstDHuoNmb2BBOz+PLfTU6Xsnn3yFUVkZuSlLqv2n6Hh7fnfeM+2aNOkIiug6pqI3RueU9Gp4VGx/t5Hxl"
    "Xq9eR4hLTqr3YcjxIeAf3tuZ1yxvLhuGdMU+TZ84OiAbzxGRiREFBRwjJBwGElCIeKS0dNj0nPgUSdVcsWBmWVV1fWaB"
    "cF3GcTnutz+a3ZZ2yT4/szKu75clE+nfQ7/BQL+yuiuwtaeunqInFq5dWJrc3dhRzfbv4W3I+Vqtv0eohETv5ZB/t+C6"
    "MJFQUO6PqwrLtZKigmKS5jxLMFowSERMFiBEEj4yGD44HlI8TGxyWqQqUymOFCuGndsS+xP8GySLCRsTGeNuvLrBPB8J"
    "IYIlZqW8HOY7qhsB/xgVB7nY0Kq2SkBaJiq0Nrk/wnNbTaimo893+7+/2a7kN9C/Iych72T53iI4MC8QDW7t6tVFlZoK"
    "9aS00HRIbIyMpExAGNDRULGBQOFjpGJkJKYGqEiJaNrFxJVmlsVXeBiI6Jieow/dc0v7Pw5Jl9/b63cd07y4Rjy/yV3F"
    "NrM6N7OrV9LQUAA=")
ZSTD_GRAY_PREDICTOR2 = (
    "KLUv/WQALyUvAcr05pRO0JSkeQkhQ6vo0Cr0+Pj4+FGMUUettR5rXfkodACSVbAdmNGF0ilHbra6QDMABhQQuACjSQVU"
    "tzZz1hhDa61jjPjx//+/1MImtbCtFPYOPAksCTcJZsxy52p9Ntoyx4XEGrpuHW36JZsIxGrPdiUJ1so+lKjG4zsXzobG"
    "QUXhJYJCSaC8V1ocyVQPmhcD5pVwIFeMSgFiQwZx0kll7jRXSnf6EOK1Il/ywdLrqR9w89dRWzZUwRVK3nWl7jIOjEbx"
    "Umst+VgrIcj86vnyWCfs8R7Xu2Dsf12zFp6MDONp00tGZQm/brcQxcLNY7fhtng4Oeo50y3TRG+GMjJYIAxThKrF2VVH"
    "IQikFnEXG2Shmx7rgU+arXX5NDJiuaUZ0GWtOeIc4s091WLEoI1PPxEGjN66czB/xhj7TAydR4SfEqqOpKMXpD2kj5Gk"
    "b9PfxekIW8/kP/umbeA69BOm9Suv24Vib0PY3xYHr9afbOStBDG1Rgb2pjdyIZlruniWZ/A50aBlkivNfv3l/84G/You"
    "TUgGYl1EaD7YarF9kVHbmnCJSB8emss4PGRFkAfiOvUhjLNn8PFdZ+LoGv2eqcawISRb1HtLJ4ejKzQaVBdmdSI+nFGp"
    "d2yxJXEyDPmekUtdW5arglmOYuMuGrn0RLe/9eWEWa3lOaxtDqyN59Z24trILuMcxqK79U92zA7VcyHfvBzpU4/hu5ki"
    "l2hyGXLsp5eFt040yh06def9RDC48NKWA6qi80Ikd61iIcZopOlZ8Mb8Kw8K8jzJ9qIVf7zhayOlKnIs+wh/4VKWRlEs"
    "Qc8k2hqObmzc36g3VnaFKN0R8bPdSPhyH4FhXCbtxT3J4RnPkWJNWKtx9+pxtzPN3AkOFnAuYCKoMovQXJIaijIP0ckw"
    "VUb3rPWy869MsIPhEEqGCd9Kh868ZqnO6P+f99t+nlf+myTYj5iEPjSL7mEjeThXo7eIVhH07DI6GXMZX+qljCEDJJ79"
    "+5rZ7bKLbf2eV7z8kkFD7apL0oamhBPhalT5rfaZSAGiwxff84urDBAKTE1J/rovp2PbBePns7ogl8Ys5KLrNj1f8QPv"
    "WAbFgsZRwxJcCRGhz8QNpRdUtchFe1Aw0H+OFXGvKik1j87WRiFb4+rkjRRgUAVmR3YrNGJszVFkhaT/eYZQMPY7w+ni"
    "aWosZd1JJuJRp/WKEL3d1crRijdInCBFryMaTb7Q7n3N3T9cL9HjSaJ5QBve7TRHRaki3r8kyFYZTQ6ogq7wNzDceFwL"
    "1/r+HKxy3Vn5ghH2nwtZp8ZcY+BIoMroPp7Og8KtXEUzuzqSeYWprworM1a0X6XB4i9LhRxCuZzqUUNOsjZrKw06Ljyw"
    "rKDyAEjuV8tg4+mb5JXrIcc6qTUiPG4kpuNFaWxPG/q2ean5MiQngVxhgF4a4lD7pJS5h/SD/lWRXR1RqqOVxmx5/dyu"
    "8g+jDA2Uj2W0N54UUnmPQ1qas7kzPc4fIg14Tew4e9IMsWEIi5gfDe16Y3QeXvosF84/VZithR7sBqKhejwW9dUJFNXX"
    "E0CQ5HIrEt0bHXodBsRgPnnQFU+rhv9mdOurxDxo+LE8nfr9GMXnviNsevfq6AVWvO+VrHZ9MB9YK2E5+sWyicocK+P9"
    "vLV+WKXKgYHIV4WJKlxk3qXRWrDUcq4nE1/npuMQHQHEc22YMZYm4h0/Huz5Ll52Su4jZmrrJQ69x06Z1uRZUeiXHs8O"
    "9tOp1tbNsd08ybxCV8HLZTyxAyMhy42GBV19i+fsDWsq066q/bqf1Yo/cNCH2qQ0/p/Q9zelR0lBaoXckzCai0YMgyKf"
    "jW+YkE29eKVBtxgExZnrsqjLa0sotUH+6pjiCeFN6b/X+43DNRJNZaehsA+p+JeJKnAXHURlMYHzgCwTnBzaE62aVHVs"
    "Gvmohrk+dnXQlsvzt0M9lkryAHmGjRp+toTTSHC06Xk+WRN5q5ka9zYODpLHYn0oK3k2U+0C3nAMdV+SFZFL6oBS8xFn"
    "nY7P2/x18Ox1b+SoSEiX270HvCUXEpNkcdaMduueYCBQz6W564JmaETf6WWkamX0PiEAs/hfD/V4IshuQ06ErHI7woEx"
    "oVhb+QzSwNHv5txxqM2yVXyrfMG9qwK8eCgpNEQ3o+YBzWDpt+WKM1nVPXS5Z7NaDOrjdUm2eTAh04pt+3ysboYqX8/i"
    "vKFd7+TQz07Qe4qgi0LIckyoBO8+KuGf8KVSCcWmserEd0e3CZIvF5vxdeZYUJp+aiOeEMFcZ6PtRCRLw+KpvPlPELhl"
    "Lbs90NvEfl5Cw1BFCN3BsWSese7B1ojFtFlyzbHlw0ISuKmzfoLFNwAhx2M2V9iHCuB1MUwdSITqsJcVl04Rk6Yqjncb"
    "nV1uFhXzmGwrN3QN+g2PW8dlwug+o5ZLUhmsqrb3MCS8oy8hAFgXD5XVXTBUQ8yadkFspu21QsGO1VyOw8UwkTxvnyLc"
    "zAwKZJrFEbmA3gImQnXu8PDl1dW4JRfeThCiIRrD2HQXOLLWHcTyglSNTFUbqg6F0XdvMtyS3vRfiz2vnUj6fyX2SFS1"
    "9w9xn6gLFUgsQbJM2IDT/ejehHSqTKqQdMC8izteHnqGMCDhhBAf+i7iOjU/H9zUOnFuaUfKM8RlIMr10iRV/KRemDiW"
    "VK5lwXhFRW5Jfyi/l1z2CpQJR0Q1KQbRLcagijI8Nny3zetzvatPZGd+nyVDkOVdjbxET5RanhrzdkSh2n4EPqMjgaj1"
    "86hMZcQRdJrGFwJDs0+LJk1rs7immskZFFTWK1Aq3RsF6jh0tPfob2+adgbWgccphubIlYjkhoXEE1OUpBORxTyiz9H2"
    "zRy4+Saqy1NWWyzov7esc16rEyK5hsYDADCvFyzazh5KDJkITVoaCmMbe3wLiYLgiW5vxE6sFcrQCZ+GpkGLEbYgL5DV"
    "Md8q++xmLTn10DPuLUebTpSeJ5Q62COdJjGjpifX6ehcLjElrczA0MciLXujPPtXRkbrANF0pAvInwPqXGHIflX2Rmim"
    "D3zk68E25geO2P8oLcj0G8vIAL1zBlGmifEOny77dmpTGqz6t2PVWSPSbUpfG02uGns41teyh5Wb4LEOztbmJhibNPgL"
    "M2LcIY11VLwL2SkeStIqh4CnerUlsb9AeWyT/a/G8VMW9LKbd+6OV7PsPtyycWEZbGzRLPxqRtDOyqLEDg0PRavd+WG+"
    "daXa1kwQv46VacH1OqKElSHIfGXcA7GKm7tMeB2hjF8lyww0HehFwZjZUbOYKwIBGBee9gaUz91rixd7KXSX2W1Nh3Dh"
    "iBoDXupF/qfzZP+pLXlQh3fx4CkKkjA0GbXwxLmDnbrMpe60L6lcN4zXLWro8tPaO5MURKrlPKR1qjUodseNHFiuHJ2S"
    "5NeRVziX0qmVtTnDebgs69BonOVrBGnTG3ExHn+ZZQ/0mP/48EejOhetL9P1mkuo7KPcUp9D04tiTYRp0ewDhovWrIQq"
    "ivhhs4GZLkw9gWusPk5Ndt+oh7EFhz+4sAnjpbD0plS2OXujVVUXO8W08kEWCDohEtbokmvbKvJNacKOrrmLZfw6cnqx"
    "qrX4gcJJFzx2RFT828eq2DvepZrWSb1q8o7elXSjeKJfmZ2umELClCcMRPXopmm+x/URPvhc01mfZ1y3cRHV+UPmZme0"
    "63ynjAdvwrKmqtniGW3xzRUjkiiOROY4FWBG5sJf79yISbI8BKMNHYc6WC6h3Vlt/MvIUqODxEXYYm22M+DLfUYiO5hU"
    "a7XwA3YkiK63nGVwH22GnnjPN648HLfw/Hv661bktA+JlquynaIGvdIVzWBnzLE+fCIV24lvWSZpuF8HR2LzK3ADRWgV"
    "gx8urrm4M4EzjdZyzOvQqUTabK6ZaTgjyswv7Ccy8EnsO5N+UrqLImXlx3XgE1dzlKU45u1dhrOf7CDvrSEt5gnWymwR"
    "h4R89EqexbH/g7uOKIqarLPEc6EaLINdPRHSgMGi3jo2gygMvyZLwyXRhZqjDOP9UyvhdLKmCxbH0nVy3irBIBDWmpW0"
    "nW3j2Fybj4LRp/J076WTMmy6acbOgXmXbKxnBvv8Nr6FlLbySxW4G/EcwsHC9OEyit7ttISB5ufYGtFOnaZr8F0f8FW6"
    "jg5vdTvfTkVqLaoUh2XK8qBQBkEmpMWYhr7XLOJUPs3o3HDjs32yDN3ipRsu5YVoZTemuehZVgJVF0gcZhjvQ4StGO15"
    "PpWYtE0j2WzHN2dGi3ZgvDIuvrXT0oyuqcy/4I2Wo2uWWFcyKehyvUulVETx8qf9zoXyn15vroMi+g6X0hMHCLZqVoM3"
    "yGFa1hFFcMibQwQasZzjj2dwxlUzQ8i/3HScRRd8QO41+UgNt/b7USOZN8pDRTVeGLKW2eI3sZIBS+kLlheWcSu8dLeI"
    "HxHa8DkvccSLB39SyEgsNnttMI8+Lfpi0q5G8e92cGwg1TltJReykp0QTWtF05bK3pde+4pAmaFiyG53cDy1/NjlmGlc"
    "FyGUaTyvA6YqLIi0YO6kgvF9XVdASe2XxeZA8+MCsZ3TYE5nCcEC6doN1RnUQDAxY61mS1uhsbhKFMzy7mvTfujXvaz6"
    "FqLtFadL/pXJ9J7ccMeQLuRyFGPVJ1cxzOhpxWBFNJM4n1lJ4vIlbXx5NSw/2nh4i+GNEnM1j5/Zm4eGtKifwEll9Xzs"
    "1bKUnH75Y5N68TiNS3f69L9oXBgW6VUZVYdIB+NcYP/ExbtmJxoahyzNE8+hEtr/6gXNLx1Na3rWh/qw8SSKpHxmyFPh"
    "qI1ykIULdra105GGwkR1mU+/GrxKMmecyu+Yaq+626YQVezJsI/fHUnlcM2OmHeGPat1P11LG5Wl+MIZSp0I/bMHs2CA"
    "aJTspE+VeVh57vsdNNRKktVzKQuNnHMzeeHTRG6mbu7UDNT9Fdq3NBNX16l28ilhem0R+KSWWQts7HJyvzpk+lZQxXJn"
    "mfZ7Lte5xCp1jqrS/d5o5tIJ6VtjaeR1ueJt/BRNQWD2iiy4miRe1HOwtZmRuIZQRKRWbpi2LlmkUci/DYlVuw5xw19s"
    "l2xhJ6Z5bel9NSF4nEeTefUr2apmVttyhtECs2LLxta7wqfeulqF3OBtbtterEaZ4TWds7jjiaaX8I6xSUIpVzDrRxqF"
    "Ung2OhCLZ/hvNjoNTnrVylixpa2SC2miHw6Yifc8lZ3ro7L//uE8wb1I/tUvOSydu9zOO42vvC9QmqLquQNEQxjFsKZR"
    "smGmeznfVobOGvz9tN7K2YPviNgsi41NhKx6nOx9WHEgNiEkcc5H0y+3bfNWdIceF40lTxOruVeJu3U7QiSt2Nqi1BFL"
    "h83DivHPJHfG3VIded2lMC6wzaHr0PyUWGSp+njpt4Qj8FORfcV1PJWEVYI1z9LgjvJbjy9/cOaghKsHkdRMlr7NQ1mB"
    "rqxt7JXxOPjWdThd3ghmzbjMs06jZ2SV5ZSk+b54NJh1Q/aqDTyBwhHMa/707hmBHr1la72qmWy4MNcbUhpd00qeeb3g"
    "y1McvND/eB4+mTnk4n0tl6wqm8UTkrEivpwtdCgBrS1JphkvD1XpeVONwmhcBtd5OiWLrlPuc6n6+tABx8Uc6RPZlsx4"
    "mFzWjJqmgDhD07mmp6V5ppcfdYSK7WGFY4YyfDKZGjVnsqYEzXh5zq0gZ0C7m90GJmKWVgkWvVtC6lHmcbCWd6XTyThZ"
    "R/xYGJ2JuyA7ePA6VXa1+duCOkSAxsmvX1p5pZ9Frj7QTaaCUmbFMBqFW9OBqTW+yThoGQukK54QTrvQsvdHmaAy01g2"
    "Ro8y4K+M+G+jQ84147yqD7GBgyaQp5XfWt2vsAPE5ek1HLHwWLlH7+noXGhna4/HFogOJJ6PdlX9wOIInxALSby8kWGv"
    "ihdbG8oaHBv6x22P2j5huwxaMGKanVgmv1OFrOSFKGcR3HDVR6+P2pNHTsRpSStZ8xkbM82Xqd+P03eU3dqTLD4D/mhH"
    "rjl3d7bKYl09oU/wB77E6uzygwOuGTs/3uvQH89CpMs15BzTmyO5lVhJwwYtMMqt+kye2Wtp/eXax+z9jEMPdkNPlxgW"
    "espoI2nkbaxL1Tj6ZVBIxBvRpEyOXr8NjgwRcyXn80LySgMEEjSTV8yE4UUSUcjFx8aReAFJz7NOFVu8hh3jXpMKWX5q"
    "ZcQv05VFRMzZIYul0tPBe9PGXRFxkuwHfdeDTrr3tkbiMxPZki5MgtJ5hsCzZ1mEVIX4eArfZK+9eJxAuhV6iSgOtoH3"
    "qJBMxrEWYLjrhFW/kHWHUxGTWln7UiQoaBn6s5PWvC6iRYeJxLjX2oYGpyvdXafCBcbogJ3bbGYhglAufqho3s7Mienc"
    "auOTOdADTG00Ms8bMobMF+RPh2ShitrxTa1RL69rYHFhykxRDs0q01BsEfa4VoUEXz0U38wTvWs+2odyhn4JKCqnALzS"
    "F0nUJnY4SqsbLvZNV7kjvMYsX3rMbUWZfPjQFl0Ztt+kKZuHG7LMAl7oV1ItVVx92MLT99Lcs+/EALV++xZY6Fugs22j"
    "cOBBNXSXiSFQTdM+eTfm+vGGWh3sKvlEKBgaVnkWfCCosrEh6iw5LVgiLjMimw/0c6Uc3LWYDTspz25miIHCiPmmTMZx"
    "gVbsw2l/rBcjZ6YwOromFURrT6IanVHLVI/uu8hnH2wH1K/T9vBXjHTMM5D1chTosswHieMfiCf2aEyFzBOkTxGLyBxR"
    "XciKYa+zjYpomnvPTnPrz7k8e11gXIb938sML7SawrM83FlPX5U/+R3lLYVkIhbc51Ug0G++QH4xsvMjLYBdfBw2126I"
    "qHGUeR6uZULP7rhh0tHaiKqkvCfy3z+GO5MW/KDqcKpH7nUlzzpFotPNuN/xVIqKuWypwDJGwc5huzzmzDh74prZbqeo"
    "YZJy3yJFDwoJ4nRI8GPi1NnnJeTWhAuGC4AyHKP++Ra88xCH+oHC4HQaetL5HRe1LljTW3ehjEvkrQBo71LBLNuQqIUJ"
    "/jGETfQjUztQT3Hqy/N3R2ZVkb/7iGfzY6UUvkt4btCD6d86mVvqNFCkHld46xJP9HDKI+EONUHncUX3SblO+UbvaOnb"
    "R9+nwoaV+K2kKq26iKCtsGtPLYOR/oaNDuhFKCO8RAyw4kWWGjeIkGVqHNTSOmz3t7Sfo9lRP/I4s1UWkwxdHS3Vtsu5"
    "D6m4YLFsNjH/8FHJTdNASlLMx+luZ9p+mb87ZnIu6Nt43uiVWkvgpq7uZXTDAnFeo+tt2RMpGdY8lh9mEa7SA4ZDvJrO"
    "Tz6t/NYWhx09615nTT0Uz31fyaQjFAYlQRosWJCV2sdNonXmaR0SkyMfaDFRd4Ls6KjJMnrKYfr2ZBqq8xv/weTW5fAR"
    "OxoISvVWrb1dU6RiZQBMm7Fvogpkd01xN2aUVbYBk2loZ0bN62bRpf5ZXE+cj1sYUQoNeGWondcw/NjO8SSRMK1DTWQV"
    "CRC0LK82bBNiNXe8CN8nbikU9JRR/TYTjuNiolaOi9TwELGMRRKlBVPjLteTZM9pz8YnOex0Wsfs1tNWnTLYntGcrJNx"
    "6CyjylxsZtUFvNZM/ZDBd1T7ud77GmTBwC+4dkzbMyUliJgb+e0bRtt06SrW7sqV0abK4IYFvh7r9vUHRyqfWhJy/YD9"
    "+lUkAItGeu1rZV0yc0hTbMOOxNPIk6FzdemxV8xyiKNp82Q/jOS4UL6CZ472cnzdugr5CrHMqRHWCrEsIBQcg9JHK3xZ"
    "uGt4MdabyrLUHK0hN3Xt4EBO7FI/l1MSeOqfdpbQI277r66ka3b0TpPBlViGaHXVL+x92i1pY73c+2hY6UKvq2eofcVY"
    "4UHUyriFAWVuA3bIVfKIh5FcawxkzpW5cSXsKfxfn5hbrbNlUbjzGeN3O7OYcUZkIhvqXRz3yokLMrutjfU6YWkI2qQq"
    "oNLa9WgO6YoI1yLsvm8gZinLm/7eTMGZWDsj0AcDke38r9fXYUl9ccpkiFdrQcuaVix5eK6gNrSe5grWv2whqwsrs1Cq"
    "hp6IvDRiicWk/lyIt65wQUJMbXfyvdR1+51rBqXS7vyx4ad8mmtMLSLUuS+3T9nq2So1YV1zRvjJbAzbIMHBQsUn3y/2"
    "lydpC5T+44Kn6xesojLa+SLC6467EqJPrh05QPiP4kgbTWv4oKOTAUUkKlGhF+rfgGCSApnlCbbDX9/y/5H1WFbqZVQe"
    "vj9O272Lh0VFbzN7cb71hTIRyekyE4qIhFJUG74ajEHUDWqggK3P6KXPDzsyEofVppLyfT5ZBntmkZdM8smwVqKfiefu"
    "DikuZPk2QeP4zs9nLahKJrStMKszuXCrtivdw2l0eDvqArK55EuVK9hqOWfj5XRrTcmeCnqPoRPWjVimIBtsJ+zB0cs3"
    "SB3cgZFC63/hLJ5m12Vk+BYqqkirq/9aD4ZMJ2Kfg0lwADA/lAthHy652SL64T8xn2kIikZ4+61WteLWMiXSzsuAawuN"
    "2DOqyc71vlysppB1s365SXIM2RUtkhriCigg+7IxR7vcyFQXErbi2vwsA3ZEip+ggGz8E/EmyTGhIvS8F76kcX8xZ5UQ"
    "KKwy1QaurwW6ImF6lYl0bWAsP7f77SqL63Wm1/9niiEV01Jzsxy9rhPnSjLpS87icP+QxZviUg6+tYGkL822NbfqCgyh"
    "2SpxppGqGMI0No7NslxCQ8EOSIYuCOJJITW3ghsE6Yy7laAIS7edYWSC3N0yoNdhCiGesuMrzRYLhmwe66mAvCrEe+3N"
    "qtwNjcb+J1TdyEV81Ak0tpDu4Ok6JR5TiL9QCsP+hCW+804Uil/dlNSZbsL6O1Ws5OICl8XvVZgwtMzqV+haOo6YJPTp"
    "HcnhaIy7/4nm2cuehUQlimkGPXf2VYIXdbJyK8M20e4aAV94CGaUXzDtKM7dWhnkQbwhtKbsssvmI3TuxoJf7anVk6zw"
    "UG/izHSI2ULMb2oLPf0k7Mq1jZ1urMX+dl8K2VTAQCoLBMXIPRymVn+KnQZLmr33b/2hl1RhMq4pOrfSVRr5d9qQhkOV"
    "g2MsKny0s4aYZiCxbcf/jQJCZS+1KEsbIBc8X27FVKyj4h8qn99T1BE3El2KeQkXFb42a0+nrw7q6pHe8KMigSGnBTG3"
    "oiAUfvfajI2pOnqfyCVTae7OERxOrdEGt0RgxcdqFj5NLl62Ow+NRAVvwJW1pzEhTKEpRVmwfoYuOIwC7Yd34u1VPNL4"
    "SALNj4qJXkPq74jizks4qwjcXRyLftc40thyVHY9f/VXudxGTMu9KuHfsPCV1SmKqo1QDeXqzYPmiSmxwpjjsbc0YzK7"
    "HnTWeW6mg6J+0oYOZ1QHrxOLnXqFvCrXnlTJFe7asodqa4Rn8TNn5PbGEkmaLTG2thWypGlXO5JSq4SeCNv9toF7n7MJ"
    "WkcYjuj5lHBedn5DJ6EeDUGfm/1mHS/GAxM7Px938EqHzIGlSngxh5DKqPhp1qyNGJ3d+6GINiH+vIxNoSz7SQci/ibV"
    "U9vlnR1i8bApoDlabBRWXrKmwTbKmMKxBY5aaTlepkeriS5XI7qphvGnmqG+64lqu00GbKrodfUni6/k9IMD7J4n0axF"
    "WCaLXgBQaxzx3J74GJNgRZr6kKFp3tNUV7i4vgfjEDFVyOZDQ7p8pg7ZWXcYEApYXMb1w4a3P+/DMnl7nS4XMFdYAelq"
    "T0f9AmebaDYlQs4sVLNHNtcS9iEfjILKdkwNAEuMVlotPCwVOcrP7RsGieVK8mKk5mUcoQpK6gO1O162epXr+jaRKv/I"
    "c0Jjeiti8oVVLYXHa13YlbS/+VUva975n8EzPbVSN7LTgwakH2trH9RtX+/OSSYSAPy3/MBMrtxAxnttmz9FH3bhqCHo"
    "h7RDZkTkjuBM+pAuAClD80Xe9EYVnziNWSxdu+K5+uwsXf9KOKWoaiKZ3y8dJ9Rgm9qjSi7GTI+8uKCIeY66CVM9tRNZ"
    "Ao1gJQe6nqMGrw7UaW0JGTJkZYJa2wsoVD82CiNZIaqNM+Ep7kqp7/A4D6y4221TbbQ6HsyI4V7M4hEtSA7U/xdHTYRr"
    "Q+G/Ew6fhFe2qyyZZtLROA6MOFKX1FSRsNhK0OBMzRFdzU6k9wGyYGvt5FC1QHGAHn8UlztBobAUwTuNNYxwiZ3IhJ7h"
    "naD2/QS9ThLz7l8MbsrWsHAZsvP8t/bZdIFhrBOpUaBHVJpTiuK/UIRGEUxWqVfOIIcpUp22p9ePaCbHzJuSKOrWSoLX"
    "YhzSkfpjHc0C6nkZIOCZ7Z4HRpJVGFvaPYQ/hXG0BrF5cOOon9CC3MfKfyVhGatK0svie88okCVTqYYCT6gfbcdHmJgO"
    "05LBXpYHrVZnhBRrJjbnU9SFQRMZsSP1OEKUDsOqdLBibXWt9zEL3bPgPoxFchjOtrszekJDOTCLszAgRyqS5gUMOEUg"
    "y94e2Gad7I5Pqul+Sot/Ui3q6dFsuJGxWkv2xnMprubuLtXckCPNDH7qz14IDKsZYkn4s6eKXNIwqRKj6/Gc0UQKRUyL"
    "rY5fLZM/tSGy5EiWgzskGaeNV/y7JtYxRpgP4hopI+rV83b90kEOERhrjiisFJQzOFINqWquJ8U6WGaDFVy3ytSmgx+m"
    "VmcM+dHGeLzAwG5b/JBOb0RN6NfuYOAUzwigbE6yMoV+m+oyZvhBkupq0syIC/YlbEAHBQAYDCm4Pqxd5ttuaftjV4nF"
    "g6LjnJ5S8k/f350dFwIpkBt1d5V4pXn/ThcP7zR5+fqR8sHRwEc8wYpjjAwALk2FysSKeS0BOE9XnxCcq+xSDdayul8N"
    "emV4S3qgFUTtJtJeJQsQGnEX94qqgzM5PgZrxxalyq3iks8u02A9x2AdzrLJv5zJeq74Em7BW44qCK4pst7+pk6RLMM2"
    "URhnqoW/ZgHYMKtErZHau158RTzVSNZPRNeFcmh7u6S3o0jeH0kU0hNtab5fLrQ+3M2PZmuyOlTPxZIrjkYhWRcWvV4d"
    "kYNmURhsqm2xQj9sy/VNHUs9LBAZ5+Iejjs2koOlJNZQxvcH0PDDlNW4Ci3hwI7VQzJWODXQGOK5jA1ETTmg05uQNI5n"
    "d+gh7ef1sM2DAmIzWain8VpMnTDPDUpkNU3ONTfZ7NbLX06RgmeK4jCz6wTVChzWQGpbD2V6EzoXYo+KSdrtOtZF9mNh"
    "k/WZk5nk2q/npL8Hn06TEH9uhJHgY04VY7Ms7Ydt52CQw5mNNLTMViMDVFsXhqVRptXqL7itxJwly+xZ84eLmUS1T9qG"
    "YyXq7PxEGbTwAahM3tA3vljeEJawahvweGl/VaJ7dE4qP5JQlk2cXuxXjmy31u4Z9vUvqaiHjWxu3CPoV/JN6pUt3u5Q"
    "rjYw/gZJRX+tmq5bjMShmRoG3cmCMyLkTttCXRs2QSkczqQqTcjeZiXmsT8qTqTafgotHHC56otCCjcFZ1reoz7cZ0v8"
    "ySD8Q13DGOq1H0oCZCAbxLcU7LD2Ykf6lditwSnAVX7WiDSWuVR2lGZQam1Npbf83trwJce/A4k0VNAWaZ0/oHEJl6hy"
    "XFlFf6e1SZFzGbDlE9DKpURRFbHE9FP0WFb6YshkD5V27C3COnYy+gfApcNeAVApp9VnBPFQtAWvU01mYk69QLhiS7Bm"
    "rHAWEHmx5gxDhTcSC/bLh9NsKMbh6GJQslHTTKA+th09fTPH0MEg7RSSeOhIASr3IlpcdJghY33kVz6G+Z+xz3MAuJVi"
    "cOGGNFLt9bCBnF8DktbKS+pw7m7ofdqOX5Ol8NZmFUXDCAwKRXccnIxYl1/MZujPPRpxQ7YkrY4XxkcVVuyUOCESNtkz"
    "wUpUz3621KsmBtARjHdJuFf0Lkpd/vjLrQ+OVOHBos3TQWgiIA3qYg/KqpCa4RmC0jD229CI7zlNUkrzdXismMfKOlQY"
    "CWYNKyTnssDK7NJdaCzOsXz9iyd3FudBDlfOY2I7ScyHFdKRIn8eIZVGAnVtqWvvTiiGZPZKJ3VdXak1a58rXxfMD7Gl"
    "XYOAW0PJye3+7xjQRiIv3dZynk5Vf/j/DRVazTF3ocEw7aI1i+3NJP02jw2V9aVdmsAqKri70YJshRV8Jx1MpYg6gRSe"
    "0BjE5Gde+9b50oR9voky9kgTI/as8DKAtuMMd2Q7CAp58ftd/Y0ydlgXYudSQTrdbJbC0xtymflKFIKn7m+zTb9Kl5Ri"
    "aFYnplhC9GTBgsFwNw3KVG+0YHDdoHqrkAD2UTnojNonE4E68v4q4JQ+RG0sQX/Y/4TzRazrz940j+D8SDgjFNLfo0xE"
    "0eOuolS70eZ7OO86h7+Dy2jnlLIySGIOGqamoVAjRrFpPdQGeyb48teD+wZAqvc60UwMnfvbHCEKqFLqvWwo17kJlq7m"
    "v89hkn4HGskwtguqLosCcVIT6cTqKWwi9RJKrSAvhUic+VuQvq7TO4eX2ZGZUYkOPuXcrpAZmK+MZe+yl1jLG8+dIHcS"
    "4e6wmHBhVBkdSQ4V4n0lTADIKwkLwIxyTFOm15+SJrWVBaWTJstAE5M5OLkw6iry2olrciuLW5TFgZvTONqolvATsqm4"
    "UuoumXx2LTOpkLr1PEMKh2zpUm1K3jv1jgRzFQ4usx/zUrhty8PLddAaXRjUaaxJ7bJloEPTLd3hkkMDa5AKwVH7sLHW"
    "T0P9JYWsCWjtWbJD3g8pBIE3azPm+aHF8cMZUmcBY86gOXW3Pmn90rPFK45NK3EUr7diGYYzcEOfHtzFWFTzU0JLRVXO"
    "wHlSrZXlSB+spwIh/Mwnr90uM24CPCQgwhAipx0Akk2jaW8/7vPzvEavyEtSMYCzuNxim01kJ/FIbocH1zZzDZC0xGbN"
    "PmQ6FwCnT1lMlRqfe+djHDbapH3+SBdbfRL1ZUC8qKpVNI7fRrxJ279otrYWM38WxDClRUJOdqlgfROgvQ7uR1Do6eCb"
    "IhrU/snii2Tc3+nK95OI+jnUrJR6LUXzk6isVSjCbBkRYUzN5S01GR6bWevI1L+eTgNLQla2")
# phase 23e's files as Pillow 12.1 ends them, as TIFF_OUTCOMES
TIFF_CODEC_OUTCOMES = {
    'cielab_lzw.png': '3835cb3b03bf4076917883fe365b8a340922b0dd9a0701debdbfde968baca67e',
    'lzma_check_damaged.jpg': '65bd03b5d09052b2f7b2b54089e648dfc8fc89ec94da7d74048e9b39ae99c52e',
    'ojpeg_interchange.png': '3660c1a9ccc96c740d2f70d30c3a52f30dc3cf9d6d98a457c79988b31ed444c3',
    'ojpeg_planes.jpg': '7745acaeed760de7dc597f3c71629cb000378e4460010f6c2513cc7d9afd23a8',
    'ojpeg_tables.jpg': '3660c1a9ccc96c740d2f70d30c3a52f30dc3cf9d6d98a457c79988b31ed444c3',
    'ojpeg_tiles.png': '6be3b090d7b49f9791c0935e3c647ebe9071135c437616061bbf169e0ff6aeab',
    'thunderscan.jpg': '74cd85aa38e6a7fbf01eb17cc1544e6217101b8dec9a583f8877b8bfa47520d2',
    'ycbcr_jpeg_planes.png': '7745acaeed760de7dc597f3c71629cb000378e4460010f6c2513cc7d9afd23a8',
    'ycbcr_lzw_2x2.png': '79d767c3344ebf4c8ca945dee3e609a629ffab3d05f3edc235ce44ce12943883',
    'ycbcr_lzw_4x2.jpg': 'c31ae6484332952dbb956fe5711dd93a4914f7cb1c66c9b735a7486a1d4c756e',
    'zstd.png': '2c39976e943fd0ffc80efe81b40b0c9a12457aeea9b7580a1ccb3043c0727f5a',
    'zstd_predictor2.jpg': '2c39976e943fd0ffc80efe81b40b0c9a12457aeea9b7580a1ccb3043c0727f5a',
}
JPEG_MEMORY_SIZE = (1536, 2048)  # phase 23e's progressive JPEG, h x w
JPEG_BYTES_PER_PIXEL = 16  # the bound on the decoder's peak host RSS growth


def _thunder_rows(g4) -> bytes:
    """4-bit samples [h, w] as ThunderScan codes (``tif_thunder.c``), each
    row on its own from a last pixel of 0: runs of the last pixel (2 to
    63), three 2-bit deltas, two 3-bit deltas, else a raw pixel."""
    two = {0: 0, 1: 1, -1: 3}
    three = {0: 0, 1: 1, 2: 2, 3: 3, -3: 5, -2: 6, -1: 7}
    out = bytearray()
    for row in g4.tolist():
        w, i, last = len(row), 0, 0
        while i < w:
            r = 0
            while i + r < w and r < 63 and row[i + r] == last:
                r += 1
            if r >= 2:
                out.append(r)
                i += r
                continue
            if i + 3 <= w:
                d = [row[i] - last, row[i + 1] - row[i], row[i + 2] - row[i + 1]]
                if all(x in two for x in d):
                    out.append(0x40 | two[d[0]] << 4 | two[d[1]] << 2 | two[d[2]])
                    last, i = row[i + 2], i + 3
                    continue
            if i + 2 <= w:
                d = [row[i] - last, row[i + 1] - row[i]]
                if all(x in three for x in d):
                    out.append(0x80 | three[d[0]] << 3 | three[d[1]])
                    last, i = row[i + 1], i + 2
                    continue
            out.append(0xC0 | row[i])
            last, i = row[i], i + 1
    return bytes(out)


def _lzw_literals(data: bytes) -> bytes:
    """A TIFF LZW strip of ``data`` that codes every byte as itself: a Clear
    code every 250 codes keeps the codes 9 bits wide, then EOI; MSB first."""
    codes = []
    for k in range(0, len(data), 250):
        codes += [256] + list(data[k:k + 250])
    codes.append(257)
    acc = nbits = 0
    out = bytearray()
    for c in codes:
        acc, nbits = (acc << 9) | c, nbits + 9
        while nbits >= 8:
            nbits -= 8
            out.append((acc >> nbits) & 0xFF)
    if nbits:
        out.append((acc << (8 - nbits)) & 0xFF)
    return bytes(out)


def _ycbcr_blocks(img, sh: int, sv: int) -> bytes:
    """An RGB picture [h, w, 3] (h, w multiples of the sampling) as TIFF's
    chunky YCbCr: each sh x sv block's luma row by row, then its Cb and Cr
    (the block's means), Rec. 601 full range."""
    import numpy as np

    f = img.astype(np.float64)
    y = 0.299 * f[..., 0] + 0.587 * f[..., 1] + 0.114 * f[..., 2]
    cb = 128 - 0.168736 * f[..., 0] - 0.331264 * f[..., 1] + 0.5 * f[..., 2]
    cr = 128 + 0.5 * f[..., 0] - 0.418688 * f[..., 1] - 0.081312 * f[..., 2]
    h, w = y.shape
    by, bx = h // sv, w // sh
    luma = y.reshape(by, sv, bx, sh).transpose(0, 2, 1, 3).reshape(by, bx, sv * sh)
    chroma = [c.reshape(by, sv, bx, sh).mean(axis=(1, 3))[..., None] for c in (cb, cr)]
    blocks = np.concatenate([luma] + chroma, -1)
    return np.clip(np.round(blocks), 0, 255).astype(np.uint8).tobytes()


def _ojpeg_scan(img, restart: int, sampling):
    """:func:`_jpeg_file` of ``img`` -> (its header, SOI to SOS; its scan
    data cut at the restart markers)."""
    import struct

    jpg = _jpeg_file(img, restart=restart, sampling=sampling)
    sos = jpg.find(b"\xff\xda")
    head = jpg[:sos + 2 + struct.unpack_from(">H", jpg, sos + 2)[0]]
    data = jpg[len(head):-2]
    parts, cut = [], 0
    for k in range(len(data) - 1):
        if data[k] == 0xFF and 0xD0 <= data[k + 1] <= 0xD7:
            parts.append(data[cut:k])
            cut = k + 2
    parts.append(data[cut:])
    return head, parts


def _ojpeg_file(img, form: str, sampling=(2, 2), rps=None, photo: int = 6, tile=None,
                planar: int = 1) -> bytes:
    """An old-style JPEG TIFF (compression 6) of ``img`` ([h, w, 3], or [h,
    w] for one component) from :func:`_jpeg_file` with a restart interval
    a strip where there are several, its scan data cut at the restart
    markers into the strips (libtiff writes its own markers back):
    ``form`` "interchange" puts the stream's header (SOI to SOS) in the
    JPEGInterchangeFormat tags (513/514), "tables" only its tables in
    JPEGQTables, JPEGDCTables and JPEGACTables (519-521, JPEGProc 1),
    "inline" the header at the start of the first strip.  With ``tile``
    (w, h) the stream is a tile wide and the tiles' rows tall (its left
    tile's columns of ``img``), a tile a restart interval; tiles past the
    stream's bands repeat its last.  ``planar`` 2 with three samples makes
    a scan of each component at 1 x 1 (one frame of three), each in its
    plane's strips, an SOS marker starting each after the first."""
    import struct

    import numpy as np

    h, w = img.shape[:2]
    gray = img.ndim == 2
    tw, rps = tile if tile else (w, rps or h)
    if tile:
        bands = -(-h // rps)
        canvas = np.zeros((bands * rps, tw) + img.shape[2:], np.uint8)
        canvas[:h, :min(tw, w)] = img[:, :tw]
        img = canvas
    planes = planar == 2 and not gray
    sh, sv = (1, 1) if gray or planes else sampling
    restart = -(-tw // (8 * sh)) * (rps // (8 * sv)) if rps < h else 0
    strips = []
    for c in range(3 if planes else 1):
        part_head, parts = _ojpeg_scan(np.ascontiguousarray(img[..., c]) if planes else img,
                                       restart, (sh, sv))
        if tile:
            parts += parts[-1:] * (-(-w // tw) * len(parts) - len(parts))
        if c:  # the component's scan: SOS, Ss 0, Se 63
            parts[0] = b"\xff\xda" + struct.pack(">HBBBBBB", 8, 1, c + 1, 0, 0, 63, 0) + parts[0]
        else:
            head = part_head
        strips += parts
    if planes:  # a frame of three components, then the first one's scan
        sof = head.find(b"\xff\xc0")
        y, x = struct.unpack_from(">HH", head, sof + 5)
        frame = b"\xff\xc0" + struct.pack(">HBHHB", 17, 8, y, x, 3) + bytes(
            [1, 0x11, 0, 2, 0x11, 0, 3, 0x11, 0])
        head = (head[:sof] + frame + head[sof + 2 + struct.unpack_from(">H", head, sof + 2)[0]:
                                          head.find(b"\xff\xda")]
                + b"\xff\xda" + struct.pack(">HBBBBBB", 8, 1, 1, 0, 0, 63, 0))
    spp = 1 if gray else 3
    fields = {256: (4, [w]), 257: (4, [h]), 258: (3, [8] * spp), 259: (3, [6]),
              262: (3, [photo]), 277: (3, [spp])}
    if tile:
        fields[322], fields[323] = (3, [tw]), (3, [rps])
    else:
        fields[278] = (3, [rps])
    if planar != 1:
        fields[284] = (3, [planar])
    if not gray:
        fields[530] = (3, [sh, sv])
    extra = []
    if form == "inline":
        strips[0] = head + strips[0]
    elif form == "interchange":
        extra = [head]
    else:  # the tables behind the strips, their offsets in the tags
        tables = _jpeg_tables()
        dqt = tables[tables.find(b"\xff\xdb") + 4:]
        dht = tables[tables.find(b"\xff\xc4") + 4:-2]
        at, found = 0, {}
        while at < len(dht):
            n = 17 + sum(dht[at + 1:at + 17])
            found[dht[at]] = dht[at + 1:at + n]
            at += n
        extra = [dqt[1:65], dqt[66:130], found[0x00], found[0x01], found[0x10], found[0x11]]
    pos = 8 + sum(len(x) for x in strips)
    offsets = []
    for x in extra:
        offsets.append(pos)
        pos += len(x)
    if form == "interchange":
        fields[513], fields[514] = (4, offsets), (4, [len(head)])
    elif form == "tables":
        k = 1 if gray else 3
        fields[512] = (3, [1])
        for tag, pair in ((519, offsets[0:2]), (520, offsets[2:4]), (521, offsets[4:6])):
            fields[tag] = (4, ([pair[0]] * 3 if planes else [pair[0], pair[1], pair[1]])[:k])
    # the strips first, then the tables as segments after them (not strips)
    out = bytearray(_tiff_file(fields, strips + extra, tiled=bool(tile)))
    at = struct.unpack_from("<I", out, 4)[0]
    for i in range(struct.unpack_from("<H", out, at)[0]):
        e = at + 2 + 12 * i
        tag, typ, count, value = struct.unpack_from("<HHII", out, e)
        if tag in (273, 279, 324, 325):
            first = value if count == 1 else struct.unpack_from("<I", out, value)[0]
            if len(strips) == 1:
                struct.pack_into("<HHII", out, e, tag, typ, 1, first)
            else:
                struct.pack_into("<HHII", out, e, tag, typ, len(strips), value)
    return bytes(out)


def _tiff_codec_files() -> dict:
    """The files of phase 23e -> {name: bytes}: phase 23d's picture in the
    TIFF codecs and layouts phase 23d leaves out, written by the script's own
    writers (Zstandard from the constants above): Zstandard, with predictor
    2, ThunderScan (4-bit), YCbCr in LZW at 2 x 2 and 4 x 2 (libtiff's RGBA
    interface), YCbCr JPEG in three planes, CIELab in LZW (Pillow's
    LittleCMS conversion), old-style JPEG in strips of 32 rows with its
    header in JPEGInterchangeFormat and with its tables in tags, in three
    planes and in 64 x 32 tiles side by side (libtiff reads each tile as the
    next band of one stream), and an LZMA
    strip whose check is damaged after its data (liblzma
    5.8.2 reads it; older ones fail it)."""
    import base64
    import lzma
    import struct

    import numpy as np

    rng = np.random.RandomState(41)
    h, w = TIFF_SIZE
    img = _gradient_image(rng, h, w)
    img = np.clip(img.astype(np.int64) + rng.randint(-20, 21, img.shape), 0, 255)
    img = img.astype(np.uint8)
    gray = img[..., 1]

    def fields(photo, bits, spp, comp, more=None):
        f = {256: (4, [w]), 257: (4, [h]), 258: (3, [bits] * spp), 259: (3, [comp]),
             262: (3, [photo]), 277: (3, [spp])}
        f.update(more or {})
        return f

    files = {
        "zstd.png": _tiff_file(fields(1, 8, 1, 50000), [base64.b64decode(ZSTD_GRAY)]),
        "zstd_predictor2.jpg": _tiff_file(fields(1, 8, 1, 50000, {317: (3, [2])}),
                                          [base64.b64decode(ZSTD_GRAY_PREDICTOR2)]),
        "thunderscan.jpg": _tiff_file(fields(1, 4, 1, 32809), [_thunder_rows(gray >> 4)]),
    }
    for sh, sv, name in ((2, 2, "ycbcr_lzw_2x2.png"), (4, 2, "ycbcr_lzw_4x2.jpg")):
        files[name] = _tiff_file(
            fields(6, 8, 3, 5, {278: (3, [32]), 530: (3, [sh, sv])}),
            [_lzw_literals(_ycbcr_blocks(img[y:y + 32], sh, sv)) for y in range(0, h, 32)])
    planes = [_jpeg_file(img[..., c], sampling=(1, 1), ycc=False, abbreviated=True)
              for c in range(3)]
    files["ycbcr_jpeg_planes.png"] = _tiff_file(
        fields(6, 8, 3, 7, {284: (3, [2]), 347: (7, _jpeg_tables()), 530: (3, [1, 1])}), planes)
    lab = img.astype(np.int64)  # a Lab picture: L from green, a and b signed
    lab = np.stack([lab[..., 1], lab[..., 0] - 128, lab[..., 2] - 128], -1).astype(np.uint8)
    files["cielab_lzw.png"] = _tiff_file(fields(8, 8, 3, 5, {278: (3, [48])}),
                                         [_lzw_literals(lab[y:y + 48].tobytes())
                                          for y in range(0, h, 48)])
    files["ojpeg_interchange.png"] = _ojpeg_file(img, "interchange", rps=32)
    files["ojpeg_tables.jpg"] = _ojpeg_file(img, "tables", rps=32)
    files["ojpeg_planes.jpg"] = _ojpeg_file(img, "inline", rps=32, planar=2)
    files["ojpeg_tiles.png"] = _ojpeg_file(img, "interchange", tile=(64, 32))
    xz = bytearray(lzma.compress(img.tobytes(), format=lzma.FORMAT_XZ, check=lzma.CHECK_CRC64))
    index = (struct.unpack_from("<I", xz, len(xz) - 8)[0] + 1) * 4  # the footer's backward size
    xz[len(xz) - 12 - index - 8] ^= 0x5A  # the block's CRC64, after all its data
    files["lzma_check_damaged.jpg"] = _tiff_file(fields(2, 8, 3, 34925), [bytes(xz)])
    return files


def jpeg_memory_child(spec_json: str) -> int:
    """``chip_smoke.py --jpeg-memory-child <json>``: the port's JPEG decoder
    on one file in a process of its own -> one JSON line: its peak host RSS
    growth in KiB (:class:`_PeakRss` less the RSS before), bytes a declared
    pixel, the decode's ms and the SHA-256 of the array read."""
    import hashlib

    import numpy as np

    from cogview_tpu_torch.utils.image_formats import decode_image

    spec = json.loads(spec_json)
    with open(spec["path"], "rb") as f:
        data = f.read()
    before = _status_kib("VmRSS") or 0
    t0 = time.perf_counter()
    with _PeakRss() as peak:
        img = decode_image(data)
    ms = (time.perf_counter() - t0) * 1000.0
    h, w = img.shape[:2]
    ok = img.dtype == np.uint8 and img.shape == (h, w, 3)
    growth = max(peak.peak - before, 0)
    print(json.dumps({"growth_kib": growth, "pixels": h * w, "ok": bool(ok),
                      "bytes_per_pixel": growth * 1024 / (h * w), "ms": ms,
                      "sha256": hashlib.sha256(np.ascontiguousarray(img).tobytes()).hexdigest()}))
    return 0


def phase_tiff_codecs(torch, vqvae, work: str, smi: str) -> None:
    """Phase 23e: the TIFF codecs phase 23d leaves out on the card's host,
    without Pillow (TIFF_CODEC_OUTCOMES), then through the preprocess CLI on
    the card; and a 2048 x 1536 progressive JPEG decoded in a child process,
    its peak host RSS growth held to JPEG_BYTES_PER_PIXEL a declared pixel
    (see the module docstring)."""
    import numpy as np

    t0 = time.perf_counter()
    files = _tiff_codec_files()
    host_ms, rows, skipped = _outcomes_phase(torch, vqvae, work, "tiff_codecs", files,
                                             TIFF_CODEC_OUTCOMES)
    h, w = TIFF_SIZE
    print(f"tiff codecs ({smi}; host decode of {h} x {w}, ms): "
          + ", ".join(f"{n} {host_ms[n]:.1f}" for n in sorted(files)))
    print(f"tiff codecs: {len(files)} files as Pillow ends them, {rows} rows, {skipped} "
          f"skipped, codes equal to img2code of the arrays read")
    mh, mw = JPEG_MEMORY_SIZE
    big = _gradient_image(np.random.RandomState(43), mh, mw)
    path = os.path.join(work, "progressive_2048x1536.jpg")
    with open(path, "wb") as f:
        f.write(_jpeg_file(big, progressive=True))
    got = _run_child("--jpeg-memory-child", {"path": path}, "jpeg memory")
    _check(got["ok"] and got["pixels"] == mh * mw, "the progressive JPEG did not decode whole")
    _check(got["bytes_per_pixel"] <= JPEG_BYTES_PER_PIXEL,
           f"the JPEG decoder's peak host RSS grew {got['bytes_per_pixel']:.2f} bytes a declared "
           f"pixel, past {JPEG_BYTES_PER_PIXEL}")
    print(f"jpeg memory ({smi}): a {mw} x {mh} progressive JPEG ({os.path.getsize(path)} "
          f"bytes) decoded in a child process in {got['ms']:.1f} ms, peak host RSS +"
          f"{got['growth_kib']} KiB = {got['bytes_per_pixel']:.2f} bytes a declared pixel "
          f"(bound {JPEG_BYTES_PER_PIXEL})")
    print(f"tiff codecs: phase {time.perf_counter() - t0:.1f} s")


RARE_SIZE = (96, 128)  # phase 23f's pictures, h x w (PCD's base image is 512 x 768)
# phase 23f's files as Pillow 12.1 ends them (Image.open(...).convert("RGB")
# on this script's files): "skip" where it raises, else the SHA-256 of the
# RGB array it reads; tests/test_torch_image_rare.py holds this table to
# live Pillow
RARE_OUTCOMES = {
    'bc6h.png': 'ae5ac0ddad678b9cd4464dc12d2fa0f8834283abb1fa127cd7c4af8299adb463',
    'bc6h_signed.jpg': 'ecf3ebd2b63fdabd9b929c34a3463d48bc8ccc2c94d5ed0c5646c8c44e4072df',
    'blp1_cmyk.jpg': '254018bcb0578625d17a2e17f482767a7c087d76770fe37e090830252597e28f',
    'flc.png': '011e483e06a72c66d7a8f7cbf1c874f1d84e5ab94326e2c2df5956bb74d3f97f',
    'fli.jpg': '14820757eba4f9dd4570fb2b243c36529b8c57604fe56f3ec7578317b42533a3',
    'fli_broken.jpg': 'skip',
    'im_l12.png': 'd5c8fa0d7c6b2b159f7c057c52725ec1a13c20769d92d477b54b1d2ad3d91e52',
    'im_ycc.jpg': '2384f43ffffe6d703466982f2b7203adffe1da1030ade9ac3da5d23bedfbb0a6',
    'iptc_jpeg.jpg': '532cff5e158c2d73b2bc366cfef5156cb11343e9c8185830c843872388b8b888',
    'iptc_raw.png': 'f60c27f47af569a5e17216097776e3c7d6f38be4605d074bce5b29e9b84c1b1f',
    'pcd.jpg': '30c8b53daf10d4a2fdc0ec1fdf739fa9b8c88d622571504c2b0c76e19dcd465a',
    'pcd_cut.jpg': 'skip',
    'pcd_rotated.png': '72121ae19133c62653d12bf3f6aadb682ebaa3a890b19bf23104215325449745',
    'psd_lab.png': '15705f25024d037f8fa9feca31842e47f580f962bbcc8ff2ad5ef4ff614db82a',
}


def _packbits_rows(rows) -> bytes:
    """PackBits of each row of ``rows`` [n, w] uint8, its byte counts
    first (a PSD composite's layout): a run packet for 3 or more equal
    bytes, else literals of up to 128."""
    import struct

    out = []
    for row in rows.tolist():
        enc, i = bytearray(), 0
        while i < len(row):
            j = i
            while j < len(row) and j - i < 128 and row[j] == row[i]:
                j += 1
            if j - i >= 3:
                enc += bytes([257 - (j - i), row[i]])
                i = j
                continue
            j = i
            while j < len(row) and j - i < 128 and not (
                    j + 2 < len(row) and row[j] == row[j + 1] == row[j + 2]):
                j += 1
            enc += bytes([j - i - 1]) + bytes(row[i:j])
            i = j
        out.append(bytes(enc))
    return struct.pack(f">{len(out)}H", *map(len, out)) + b"".join(out)


def _fli_file(w: int, h: int, chunks, magic: int = 0xAF11) -> bytes:
    """An FLI (0xAF11) or FLC (0xAF12) of one frame of ``chunks`` [(type,
    body)], each body padded to an even length."""
    import struct

    body = b""
    for kind, data in chunks:
        data += bytes(len(data) % 2)
        body += struct.pack("<IH", 6 + len(data), kind) + data
    frame = struct.pack("<IHH", 16 + len(body), 0xF1FA, len(chunks)) + bytes(8) + body
    head = struct.pack("<IHHHHHHI", 128 + len(frame), magic, 1, w, h, 8, 0, 5)
    return head.ljust(128, b"\0") + frame


def _brun(idx) -> bytes:
    """An FLI BRUN chunk's body: each row's packet count (unused), then a
    run (count, byte) for 3 or more equal bytes, else a literal (-count,
    bytes) of up to 127."""
    out = bytearray()
    for row in idx.tolist():
        out.append(0)
        i = 0
        while i < len(row):
            j = i
            while j < len(row) and j - i < 127 and row[j] == row[i]:
                j += 1
            if j - i >= 3:
                out += bytes([j - i, row[i]])
            else:
                j = min(len(row), i + 127)
                out += bytes([256 - (j - i)]) + bytes(row[i:j])
            i = j
    return bytes(out)


def _rare_files() -> dict:
    """The files of phase 23f -> {name: bytes}: a seeded 96 x 128 picture
    (the gradient of phase 23, with noise) as the script's own writers
    write it in the rarer formats the port reads: FLI (a 64-colour palette
    and byte runs) and FLC (a 256-colour palette, then BLACK, COPY, LC,
    SS2 and PSTAMP chunks over one another), IPTC raw (in two image
    records) and holding a JPEG, Kodak PhotoCD (a 768 x 512 base image of
    a larger gradient) upright and rotated, DDS in BC6H unsigned and signed
    (seeded blocks of every mode and a reserved one), PSD in Lab
    (PackBits), IM in YCC and at 12 bits a sample on an odd width, BLP1
    holding a four-component JPEG with Adobe transform 2 (YCCK, which
    Pillow reads as CMYK); and two damaged files Pillow skips: an FLI byte
    run past its row and a PCD cut inside its base image."""
    import struct

    import numpy as np

    rng = np.random.RandomState(47)
    h, w = RARE_SIZE
    img = _gradient_image(rng, h, w)
    img = np.clip(img.astype(np.int64) + rng.randint(-12, 13, img.shape), 0, 255).astype(np.uint8)
    files = {}
    # FLI: indices into a 4 x 4 x 4 colour cube, 6-bit values (shifted by 2)
    cube = (img.astype(np.int64) >> 6)
    idx = ((cube[..., 0] << 4) | (cube[..., 1] << 2) | cube[..., 2]).astype(np.uint8)
    pal64 = bytes(v * 21 for c in range(64) for v in (c >> 4, (c >> 2) & 3, c & 3))
    files["fli.jpg"] = _fli_file(w, h, [(11, struct.pack("<HBB", 1, 0, 64) + pal64),
                                        (15, _brun(idx))])
    # FLC: a 6 x 6 x 6 cube and a gray ramp, then chunks over one another
    pal = bytes(v * 51 for c in range(216) for v in (c // 36, (c // 6) % 6, c % 6))
    pal += bytes(v for g in range(40) for v in (g * 6,) * 3)
    six = (img.astype(np.int64) * 6) >> 8
    full = (six[..., 0] * 36 + six[..., 1] * 6 + six[..., 2]).astype(np.uint8)
    lc = struct.pack("<HH", 20, 30)
    for row in (216 + (img[20:50, :, 1] // 7)).astype(np.uint8).tolist():
        lc += bytes([2, 0, 100]) + bytes(row[:100]) + bytes([5, 256 - 20, row[110]])
    ss2 = struct.pack("<HH", 2, 65536 - 60)  # two lines, the first after 60 skipped
    for row in (full[60:62] ^ 7).tolist():
        ss2 += struct.pack("<HBB", 2, 0, 32) + bytes(row[:64]) + bytes([16, 256 - 8, 9, 200])
    files["flc.png"] = _fli_file(w, h, [(4, struct.pack("<HBB", 1, 0, 0) + pal), (13, b""),
                                        (16, full.tobytes()), (12, lc), (7, ss2),
                                        (18, bytes(12))], magic=0xAF12)
    broken = bytearray(_brun(idx))
    broken[1] = 200  # the first row's first run, 200 bytes long, past the row's 128
    files["fli_broken.jpg"] = _fli_file(w, h, [(15, bytes(broken))])

    def field(record: int, tag: int, value: bytes) -> bytes:
        return bytes([0x1C, record, tag]) + struct.pack(">H", len(value)) + value

    def iptc(compression: int, data: bytes, parts: int) -> bytes:
        head = (field(3, 60, bytes([1, 0])) + field(3, 20, struct.pack(">H", w))
                + field(3, 30, struct.pack(">H", h)) + field(3, 120, bytes([compression])))
        cut = -(-len(data) // parts)
        return head + b"".join(field(8, 10, data[i:i + cut])
                               for i in range(0, len(data), cut)) + bytes(5)

    files["iptc_raw.png"] = iptc(1, img[..., 1].tobytes(), 2)
    files["iptc_jpeg.jpg"] = iptc(5, _jpeg_file(img), 1)
    # PCD: a 512 x 768 gradient in PhotoYCC-like planes, at sector 96
    big = _gradient_image(np.random.RandomState(48), 512, 768).astype(np.float64)
    lum = 0.299 * big[..., 0] + 0.587 * big[..., 1] + 0.114 * big[..., 2]
    ycc = [np.clip(lum * 0.72, 0, 255),
           np.clip(156 + (big[..., 2] - lum) * 0.45, 0, 255)[::2, ::2],
           np.clip(137 + (big[..., 0] - lum) * 0.55, 0, 255)[::2, ::2]]
    ycc = [p.astype(np.uint8) for p in ycc]
    base = np.concatenate([ycc[0].reshape(256, 2 * 768), ycc[1], ycc[2]], axis=1)
    for name, orientation in (("pcd.jpg", 0), ("pcd_rotated.png", 1)):
        head = bytearray(2048 + 1539)
        head[2048:2055] = b"PCD_IPI"
        head[2048 + 1538] = orientation
        files[name] = bytes(head).ljust(96 * 2048, b"\0") + base.tobytes()
    files["pcd_cut.jpg"] = files["pcd.jpg"][:-1000]
    # BC6H: seeded blocks, the mode bits set to each of the 14 modes and one
    # reserved, in turn
    mode_bits = [(0, 2), (1, 2)] + [(v, 5) for v in (2, 6, 10, 14, 18, 22, 26, 30, 3, 7, 11,
                                                     15, 19)]
    for name, fmt in (("bc6h.png", 95), ("bc6h_signed.jpg", 96)):
        blk = rng.randint(0, 256, ((h // 4) * (w // 4), 16)).astype(np.uint8)
        for i, (v, n) in enumerate(mode_bits):
            blk[i::len(mode_bits), 0] = (blk[i::len(mode_bits), 0] & (255 ^ ((1 << n) - 1))) | v
        head = struct.pack("<4sIIIIIII", b"DDS ", 124, 0x1007, h, w, 0, 0, 0) + bytes(44)
        head += struct.pack("<II4sI4I", 32, 0x4, b"DX10", 0, 0, 0, 0, 0)
        files[name] = head.ljust(128, b"\0") + struct.pack("<5I", fmt, 3, 0, 1, 0) + blk.tobytes()
    # PSD in Lab: L from green, a and b from the colour differences
    i64 = img.astype(np.int64)
    lab = np.stack([i64[..., 1], 128 + (i64[..., 0] - i64[..., 1]) // 2,
                    128 + (i64[..., 1] - i64[..., 2]) // 2]).astype(np.uint8)
    res = b"8BIM" + struct.pack(">HHI", 1005, 0, 4) + bytes(4)
    files["psd_lab.png"] = (b"8BPS" + struct.pack(">H", 1) + bytes(6)
                            + struct.pack(">HIIHH", 3, h, w, 8, 9) + struct.pack(">I", 0)
                            + struct.pack(">I", len(res)) + res + struct.pack(">I", 0)
                            + struct.pack(">H", 1) + _packbits_rows(lab.reshape(3 * h, w)))

    def im(kind: bytes, iw: int, body: bytes) -> bytes:
        head = b"Image type: %s\r\nImage size (x*y): %d*%d\r\n" % (kind, iw, h)
        return head.ljust(511, b"\0") + b"\x1a" + body

    ycbcr = np.stack([0.299 * i64[..., 0] + 0.587 * i64[..., 1] + 0.114 * i64[..., 2],
                      128 - 0.1687 * i64[..., 0] - 0.3313 * i64[..., 1] + 0.5 * i64[..., 2],
                      128 + 0.5 * i64[..., 0] - 0.4187 * i64[..., 1] - 0.0813 * i64[..., 2]], 1)
    files["im_ycc.jpg"] = im(b"YCC image", w, np.clip(ycbcr, 0, 255).astype(np.uint8)[::-1].tobytes())
    v12 = i64[:, :w - 1, 1] + rng.randint(0, 3, (h, w - 1)) * 128  # some past 255
    bits = ((v12[..., None] >> np.arange(12)) & 1).reshape(h, -1).astype(np.uint8)
    pad = rng.randint(0, 2, (h, -bits.shape[1] % 8)).astype(np.uint8)  # junk padding
    files["im_l12.png"] = im(b"L*12 image", w - 1, np.packbits(
        np.concatenate([bits, pad], 1), axis=1, bitorder="little")[::-1].tobytes())
    cmyk = np.concatenate([img, 255 - img[..., 1:2]], -1)
    jpeg = _jpeg_file(cmyk, sampling=(1, 1), ycc=False, adobe=2)
    sos = jpeg.index(b"\xff\xda")
    at = 28 + 128 + 4 + sos
    files["blp1_cmyk.jpg"] = (b"BLP1" + struct.pack("<iIIIiI", 0, 0, w, h, 5, 0)
                              + struct.pack("<16I", at, *[0] * 15)
                              + struct.pack("<16I", len(jpeg) - sos, *[0] * 15)
                              + struct.pack("<I", sos) + jpeg)
    return files


def phase_rare_formats(torch, vqvae, work: str, smi: str) -> None:
    """Phase 23f: the rarer formats on the card's host, without Pillow
    (RARE_OUTCOMES), then through the preprocess CLI on the card (see the
    module docstring)."""
    t0 = time.perf_counter()
    files = _rare_files()
    host_ms, rows, skipped = _outcomes_phase(torch, vqvae, work, "rare_formats", files,
                                             RARE_OUTCOMES)
    print(f"rare formats ({smi}; host decode of {RARE_SIZE[0]} x {RARE_SIZE[1]}, PCD 512 x "
          "768, ms): " + ", ".join(f"{n} {host_ms[n]:.1f}" for n in sorted(files)))
    print(f"rare formats: {len(files)} files as Pillow ends them, {rows} rows, {skipped} "
          f"skipped, codes equal to img2code of the arrays read; phase "
          f"{time.perf_counter() - t0:.1f} s")


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
    FID(A, A) below 1e-3 between a TSV of A's images and A's folder (and
    the same statistics) and FID(A, B) > 0 for two distinct sets of 32
    smooth 160 x 200 images; --inception-score; --extractor vq with phase
    23's VQ-VAE; then the extractor's images/s at batch 50, 299 x 299."""
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
    # "aa": the TSV of A against A's folder, so FID(A, A) (each FID a
    # 2,048-wide matrix square root on the host, seconds each)
    for key, argv in (("aa", ["--path1", tsv, "--path2", a]),
                      ("ab", ["--path1", a, "--path2", b, "--inception-score", "--is-splits", "2"]),
                      ("vq", ["--path1", a, "--path2", b, "--extractor", "vq",
                              "--img-tokenizer-path", os.path.join(work, "vqvae_released.pt")])):
        rc, _ = _run_quiet(fid.main, [*argv, "--batch-size", "16", "--device", "cuda"])
        _check(rc == 0, f"fid {key} failed")
        runs[key] = dict(fid.main.last)
    aa, ab, vq = runs["aa"], runs["ab"], runs["vq"]
    _check(abs(aa["fid"]) < 1e-3, f"FID(A, A) = {aa['fid']}")
    _check(ab["fid"] > 0 and vq["fid"] > 0, f"FID(A, B) = {ab['fid']}, vq {vq['fid']}")
    _check(np.isfinite(ab["is_mean"]) and ab["is_mean"] >= 1.0 - 1e-6, "IS is not finite")
    mu_err = float(np.abs(aa["mu1"] - aa["mu2"]).max())
    sig_err = float(np.abs(aa["sigma1"] - aa["sigma2"]).max())
    _check(aa["n1"] == aa["n2"] == 32 and mu_err <= 1e-5 * float(np.abs(aa["mu2"]).max())
           and sig_err <= 1e-5 * float(np.abs(aa["sigma2"]).max()),
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


# --------------------------------------------------------------------- #
# phase 26: the native host runtimes
# --------------------------------------------------------------------- #

SPM_CAPTIONS = 4000


def _pb_varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        out.append(b | (0x80 if n else 0))
        if not n:
            return bytes(out)


def _pb_field(num: int, wire: int, payload) -> bytes:
    import struct

    key = _pb_varint(num << 3 | wire)
    if wire == 0:
        return key + _pb_varint(payload)
    if wire == 5:
        return key + struct.pack("<f", payload)
    return key + _pb_varint(len(payload)) + payload


def _spm_corpus(seed: int):
    """A SentencePiece BPE model (protobuf wire format: pieces of every
    type, merges with negated ranks as scores, identity normalization with
    the dummy prefix and whitespace folding) and SPM_CAPTIONS captions of
    words from its syllables, CJK characters, digits, punctuation, pieces
    the model lacks and runs of whitespace -> (model bytes, captions)."""
    import numpy as np

    rng = np.random.RandomState(seed)
    syl = [a + b for a in "bcdfghklmnprstvz" for b in "aeiou"] + list("一只猫的小狗山水画风景")
    words = ["".join(rng.choice(syl, rng.randint(1, 4))) for _ in range(600)]
    merges = {}
    for w in words:  # every prefix, with and without the word-start mark
        for i in range(2, len(w) + 1):
            for piece in (w[:i], "▁" + w[:i]):
                merges.setdefault(piece, len(merges))
    chars = sorted(set("".join(syl)) | set("▁.,!?0123456789"))
    pieces = ([("<unk>", 0.0, 2), ("<s>", 0.0, 3), ("</s>", 0.0, 3), ("<n>", 0.0, 4),
               ("[X]", 0.0, 4)] + [(p, -float(r), 1) for p, r in merges.items()]
              + [(c, -1e4, 1) for c in chars])
    blob = b"".join(_pb_field(1, 2, _pb_field(1, 2, p.encode()) + _pb_field(2, 5, s)
                              + _pb_field(3, 0, t)) for p, s, t in pieces)
    blob += _pb_field(2, 2, _pb_field(3, 0, 2) + _pb_field(40, 0, 0))  # BPE, unk 0
    blob += _pb_field(3, 2, _pb_field(1, 2, b"identity") + _pb_field(3, 0, 1)
                      + _pb_field(4, 0, 1) + _pb_field(5, 0, 1))
    extra = ["", " ", "  ", "\t", ",", ".", "!", "<n>", "[X]", "0", "42", "Q", "é", "ß"]
    caps = []
    for _ in range(SPM_CAPTIONS):
        toks = [rng.choice(words) if rng.rand() < 0.8 else rng.choice(extra)
                for _ in range(rng.randint(1, 25))]
        sep = " " if rng.rand() < 0.7 else rng.choice(["", "  ", " \t "])
        caps.append(("  " if rng.rand() < 0.1 else "") + sep.join(toks))
    return blob, caps


def phase_native(torch, work: str) -> dict:
    """The g++ build of csrc/spm and csrc/dataio into the build directory;
    native SentencePiece ids, decodes and piece lookups equal to the
    pure-Python runtime's over SPM_CAPTIONS captions, with each one's
    encode rate; native dataio batches equal to the Python loader's rows
    on phase 23's corpus -> rates."""
    import numpy as np

    from cogview_tpu_torch.data.datasets import get_dataset_by_type
    from cogview_tpu_torch.data.native_loader import NativeCompactDataset
    from cogview_tpu_torch.ops import _kernels
    from cogview_tpu_torch.tokenization import FakeImageTokenizer, UnifiedTokenizer
    from cogview_tpu_torch.tokenization import sp_cpp, text_tokenizer, unified

    t0 = time.perf_counter()
    libs = _kernels.build_host(["spm", "dataio"])
    build_s = time.perf_counter() - t0
    _check(all(p.exists() and p.parent == _kernels.BUILD for p in libs),
           "the host libraries are not in the build directory")
    blob, caps = _spm_corpus(26)
    path = os.path.join(work, "spm_test.model")
    with open(path, "wb") as f:
        f.write(blob)
    cpp = unified.make_text_tokenizer(path)
    py = text_tokenizer.from_pretrained(path)
    _check(isinstance(cpp, sp_cpp.CppTextTokenizer), "make_text_tokenizer did not pick the "
           "native runtime")
    rates, ids = {}, {}
    for name, tok in (("native", cpp), ("python", py)):
        t0 = time.perf_counter()
        ids[name] = [tok.encode(c) for c in caps]
        dt = time.perf_counter() - t0
        rates[name] = sum(len(c) for c in caps) / dt
    bad = sum(a != b for a, b in zip(ids["native"], ids["python"]))
    _check(bad == 0, f"{bad} of {len(caps)} captions encode to other ids natively")
    dec_bad = sum(cpp.decode(i) != py.decode(i) for i in ids["python"][:500])
    _check(dec_bad == 0, f"{dec_bad} decodes differ")
    for piece in ("<unk>", "<n>", "[X]", py.model.pieces[40], "not a piece"):
        _check(cpp.convert_token_to_id(piece) == py.convert_token_to_id(piece),
               f"piece lookup of {piece!r} differs")
    n_ids = sum(len(i) for i in ids["python"])
    print(f"native runtimes: g++ build of {', '.join(p.name for p in libs)} in {build_s:.2f} s; "
          f"SentencePiece ({len(py.model.pieces)} pieces) ids equal over {len(caps)} captions "
          f"({n_ids} ids), decodes and piece lookups equal; encode rate native "
          f"{rates['native'] / 1e6:.3f} M chars/s, python {rates['python'] / 1e6:.4f} M chars/s "
          f"(x{rates['native'] / rates['python']:.1f}, this host)")

    tok = UnifiedTokenizer(img_tokenizer=FakeImageTokenizer(8192), txt_tokenizer=WordTokenizer())
    corpus = os.path.join(work, "t2i_folder.bin")
    pyds = get_dataset_by_type("CompactBinaryDataset", corpus, tok, max_len=1089)
    native = NativeCompactDataset(corpus, tok, max_len=1089)
    _check(len(native) == len(pyds) == CORPUS_IMAGES, "the corpus sizes differ")
    order = np.random.RandomState(26).permutation(len(native))
    t0 = time.perf_counter()
    batches = [native.batch(order[i:i + 16]) for i in range(0, len(order), 16)]
    nat_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    rows = [pyds[int(i)] for i in order]
    py_s = time.perf_counter() - t0
    text = np.concatenate([b["text"] for b in batches])
    mask = np.concatenate([b["loss_mask"] for b in batches])
    _check(np.array_equal(text, np.stack([r["text"] for r in rows]))
           and np.array_equal(mask, np.stack([r["loss_mask"] for r in rows])),
           "native dataio batches differ from the Python loader's rows")
    print(f"native dataio: {len(order)} rows of phase 23's corpus in 4 batches equal to the "
          f"Python loader's; {len(order) / nat_s:.0f} rows/s native, {len(order) / py_s:.0f} "
          f"rows/s python (this host)")
    return {"spm_native_chars_per_s": rates["native"], "spm_python_chars_per_s": rates["python"]}


# --------------------------------------------------------------------- #
# phase 27: K3-K5 of a shard, with batch and head offsets
# --------------------------------------------------------------------- #


def phase_flash_offsets(torch, fa) -> dict:
    """K3, K4 and K5 at the tutorial's training shape (B=16, N=16, D=64,
    S=1088, bf16, dropout 0.1) on the shard of rows 8-15 and heads 8-15,
    with its batch and head offsets: within tolerance of their plain
    versions with the same offsets, bit-equal to the block of the unsharded
    kernels' results (each (row, head) is one block's work, so the keep mask
    of the shard is the block of the unsharded mask), and the plain keep
    masks equal -> summary."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(27)
    B, N, D, S, rate, seed = 16, 16, 64, 1088, 0.1, 2718
    rows, heads, off = slice(8, 16), slice(8, 16), (8, 8, 16)
    worst, out = 0.0, {}
    for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
        qkv = torch.randn((B, S, 3, N * D), generator=gen, device=dev).to(dtype)
        q, k, v = (qkv[:, :, i].reshape(B, S, N, D) for i in range(3))
        do = torch.randn((B, S, N, D), generator=gen, device=dev).to(dtype)
        kw = dict(dropout_rate=rate, dropout_seed=seed)
        o, lse = fa.flash_attention(q, k, v, 0, **kw)
        delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
        full = [o, fa.flash_bwd_dq(q, k, v, do, lse, delta, 0, **kw),
                *fa.flash_bwd_dkv(q, k, v, do, lse, delta, 0, **kw)]
        blk = [t[rows, :, heads] for t in (q, k, v, do)]
        bl, bd = lse[rows, heads].contiguous(), delta[rows, heads].contiguous()
        so, slse = fa.flash_attention(*blk[:3], 0, batch_offset=8, head_offset=8,
                                      num_heads=N, **kw)
        shard = [so, fa.flash_bwd_dq(*blk, bl, bd, 0, offsets=off, **kw),
                 *fa.flash_bwd_dkv(*blk, bl, bd, 0, offsets=off, **kw)]
        plain = [fa.flash_attention_reference(*blk[:3], 0, rate, seed, off)[0],
                 fa.flash_bwd_dq_reference(*blk, bl, bd, 0, rate, seed, off),
                 *fa.flash_bwd_dkv_reference(*blk, bl, bd, 0, rate, seed, off)]
        torch.cuda.synchronize()
        errs = []
        for name, s_, f_, p_ in zip(("o", "dq", "dk", "dv"), shard, full, plain):
            err = (s_.float() - p_.float()).abs().max().item()
            scale = p_.float().abs().max().item()
            _check(err <= tol * scale, f"K3-K5 with offsets: {name} {dtype} {err} > {tol} x "
                   f"{scale} of the plain version")
            _check(torch.equal(s_, f_[rows, :, heads]), f"K3-K5 with offsets: {name} {dtype} "
                   "is not the block of the unsharded kernel's result")
            worst = max(worst, err)
            errs.append(f"{name} {err:.3e}")
        _check(torch.equal(slse, lse[rows, heads]), "the shard's lse is not the block")
        name = str(dtype)[6:]
        print(f"flash kernels with offsets (b0, n0, N) = {off}, {name} B=8 of 16, N=8 of 16, "
              f"S=1088, dropout 0.1: max_abs_err vs plain {', '.join(errs)} (tol {tol:g} x max); "
              f"o, lse, dq, dk, dv bit-equal to the unsharded kernels' block")
        if dtype == torch.bfloat16:
            ones = torch.ones((B, N, 64, 64), device=dev)
            keep_full = fa._drop(ones, rate, seed) != 0
            keep = fa._drop(ones[rows, heads], rate, seed, off) != 0
            _check(torch.equal(keep, keep_full[rows, heads]), "the plain keep mask of the shard "
                   "is not the block of the unsharded mask")
            out["ms"] = _device_time_us(torch, lambda: fa.flash_attention(
                *blk[:3], 0, batch_offset=8, head_offset=8, num_heads=N, **kw)) / 1000.0
            out["zero_ms"] = _device_time_us(torch, lambda: fa.flash_attention(
                *blk[:3], 0, **kw)) / 1000.0
            print(f"flash forward on the shard, bf16 with dropout: {out['ms'] * 1e3:.1f} us/call "
                  f"with offsets, {out['zero_ms'] * 1e3:.1f} us/call at zero offsets (CUDA "
                  f"events, median of 25)")
        del qkv, q, k, v, do, o, lse, delta, full, blk, shard, plain
    out["max_abs_err"] = worst
    return out


# --------------------------------------------------------------------- #
# phase 28: two ranks on the one card
# --------------------------------------------------------------------- #

TWO_RANK_MESHES = ((2, 1, False), (1, 2, False), (2, 1, True))  # (dp, mp, fsdp)
TWO_RANK_BATCH, TWO_RANK_STEPS, TWO_RANK_LR = 4, 2, 1e-4
TP_CTX, TP_STEPS, TP_BATCH = 64, 16, 4
# one-rank against two-rank, bf16 compute: the loss and grad norm (the
# row-parallel and cross-rank sums round at other points); Adam's first
# moment after the two steps, 0.09 g1 + 0.1 g2, to 2e-2 of each leaf's
# largest (a gradient check per leaf); every param, whose second update
# is at most lr x 1.0003 in size (the bias-corrected m / sqrt(v) of two
# steps), so 2 lr holds even where a near-zero gradient flips sign, with
# the share of params off by more than lr / 10 at most 1%; the decode
# logits (int4's step is absmax / 7, 18x int8's: a K or V value that the
# bf16 sums move across a rounding boundary moves a whole step), their
# argmax, and the ids drawn under the same gumbel noise
TWO_RANK_TOL = {"loss_rtol": 1e-3, "grad_norm_rtol": 1e-2, "mu_rtol": 2e-2,
                "param_atol": 2.0006 * TWO_RANK_LR + 1e-6, "param_far_share": 1e-2,
                "logit_atol": {"int8": 0.2, "int4": 0.5},
                "argmax_share": {"int8": 0.9, "int4": 0.85}, "ids_share": 0.95}


def _tutorial_steps(torch, mesh):
    """TWO_RANK_STEPS tutorial train steps from seeded params on this rank's
    rows -> (metrics, ms a step, [K3, K4, K5] launches, state)."""
    import numpy as np

    from cogview_tpu_torch import config as C
    from cogview_tpu_torch.models import gpt
    from cogview_tpu_torch.ops import flash_attention as fa
    from cogview_tpu_torch.parallel.sharding import shard_params
    from cogview_tpu_torch.training import optim
    from cogview_tpu_torch.training import train_loop as tl

    dev = torch.device("cuda")
    cfg = C.cogview_tutorial()
    params = gpt.init_params(cfg, torch.Generator(device=dev).manual_seed(28), device=dev)
    if mesh is not None:
        params = shard_params(params, mesh)
    opt, _ = optim.make_optimizer(params, lr=TWO_RANK_LR, warmup_iter=1, num_iters=10)
    state = tl.init_train_state(params, opt, torch.Generator().manual_seed(29))
    step = tl.make_train_step(cfg, opt, img_vocab=8192)
    rng = np.random.RandomState(28)
    text = rng.randint(0, 58219, (TWO_RANK_BATCH, 1089)).astype(np.int64)
    batch = {"text": text, "loss_mask": np.ones_like(text, np.float32)}
    rows = TWO_RANK_BATCH // (1 if mesh is None else mesh.data)
    b0 = 0 if mesh is None else mesh.data_rank * rows
    local = {k: v[b0:b0 + rows] for k, v in batch.items()}
    _zero_flash_counts(fa)
    metrics, ms = [], []
    for _ in range(TWO_RANK_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, local)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1000.0)
        metrics.append(m)
    return metrics, ms, _flash_counts(fa), state


def _tp_decode(torch, mesh, kv: str):
    """cogview-base (48 layers, hidden 2560, 40 heads, bf16 weights from a
    seed) at batch TP_BATCH: a TP_CTX-token prefill and TP_STEPS
    teacher-forced decode steps on the ``kv`` cache -> (float32 logits of
    every step on the CPU, ms a step, decode-kernel launches, plain-version
    calls)."""
    from cogview_tpu_torch import config as C
    from cogview_tpu_torch.models import gpt
    from cogview_tpu_torch.ops import decode_attention as da
    from cogview_tpu_torch.parallel.sharding import shard_params

    dev = torch.device("cuda")
    cfg = C.cogview_base(kv_cache_dtype=kv)
    params = gpt.init_params(cfg, torch.Generator(device=dev).manual_seed(31),
                             dtype=torch.bfloat16, device=dev)
    if mesh is not None:
        params = shard_params(params, mesh)
        torch.cuda.empty_cache()
    gen = torch.Generator(device=dev).manual_seed(32)
    S = TP_CTX + TP_STEPS
    toks = torch.randint(0, 58219, (TP_BATCH, S), generator=gen, device=dev)
    pos = torch.arange(S, device=dev).expand(TP_BATCH, S)
    cache = gpt.init_cache(cfg, TP_BATCH, S, device=dev)
    counter = da.decode_attention_quant
    counter.launches = counter.launches_int4 = 0
    da.decode_attention_quant_reference.calls = 0
    out = [gpt.forward_with_cache(params, cfg, toks[:, :TP_CTX], pos[:, :TP_CTX], cache, 0)
           [:, -1:].float().cpu()]
    ms = []
    for t in range(TP_CTX, S):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lg = gpt.forward_with_cache(params, cfg, toks[:, t:t + 1], pos[:, t:t + 1], cache, t)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1000.0)
        out.append(lg.float().cpu())
    launches = counter.launches_int4 if kv == "int4" else counter.launches
    plain_calls = da.decode_attention_quant_reference.calls
    del params, cache
    torch.cuda.empty_cache()
    return torch.cat(out, dim=1), ms, launches, plain_calls


def two_rank_reference(rank: int, world: int, work: str) -> None:
    """The one-rank NCCL group: its collectives on CUDA tensors, then the
    references of the two-rank runs (the tutorial steps unsharded, and
    cogview-base decode on one rank) written to ``work``."""
    import torch
    import torch.distributed as dist

    from cogview_tpu_torch.training.optim import tree_map

    dev = torch.device("cuda")
    x = torch.arange(8, dtype=torch.float32, device=dev)
    y = x.clone()
    dist.all_reduce(y)
    parts = [torch.empty_like(x)]
    dist.all_gather(parts, x)
    rs = torch.empty_like(x)
    dist.reduce_scatter(rs, [x])
    ok = torch.equal(y, x) and torch.equal(parts[0], x) and torch.equal(rs, x)
    res = {"backend": dist.get_backend(), "collectives_ok": bool(ok)}
    metrics, ms, counts, state = _tutorial_steps(torch, None)
    torch.save({"params": tree_map(lambda p: p.detach().cpu(), state["params"]),
                "mu": tree_map(lambda p: p.cpu(), state["opt_state"]["mu"])},
               os.path.join(work, "ref_params.pt"))
    res["train"] = {"metrics": metrics, "ms": ms, "flash_launches": counts[0],
                    "flash_plain_calls": counts[1]}
    del state
    torch.cuda.empty_cache()
    res["decode"] = {}
    for kv in ("int8", "int4"):
        logits, dms, launches, plain_calls = _tp_decode(torch, None, kv)
        torch.save(logits, os.path.join(work, f"ref_logits_{kv}.pt"))
        res["decode"][kv] = {"ms": dms, "launches": launches, "plain_calls": plain_calls}
    with open(os.path.join(work, "ref.json"), "w") as f:
        json.dump(res, f)


def two_rank_worker(rank: int, world: int, work: str) -> None:
    """One of two gloo ranks on the one card: gloo's all_reduce, all_gather
    and reduce_scatter on CUDA tensors; the tutorial steps at each of
    TWO_RANK_MESHES against the one-rank params; cogview-base decode at
    TP=2 (20 heads a rank) on the int8 and int4 caches against the one-rank
    logits.  Each rank writes its own results, kernel launches and
    plain-version calls to two_<rank>.json."""
    import torch

    from cogview_tpu_torch.ops.hash_prng import hash_uniform
    from cogview_tpu_torch.parallel import comm
    from cogview_tpu_torch.parallel.mesh import create_mesh, use_mesh
    from cogview_tpu_torch.parallel.sharding import gather_params
    from cogview_tpu_torch.training.optim import tree_leaves

    dev = torch.device("cuda")
    res = {"train": {}, "decode": {}}
    with use_mesh(create_mesh(model_parallel=1, data_parallel=2, device=dev)) as mesh:
        x = torch.arange(8, dtype=torch.float32, device=dev) + 10 * rank
        s = comm.all_reduce(x, "data")
        g = comm.all_gather(x, "data", 0)
        r = comm.reduce_scatter(x, "data", 0)
        base = torch.arange(8, dtype=torch.float32, device=dev)
        res["collectives_ok"] = bool(
            torch.equal(s, 2 * base + 10) and torch.equal(g, torch.cat([base, base + 10]))
            and torch.equal(r, (2 * base + 10)[4 * rank:4 * rank + 4]) and s.is_cuda
            and g.is_cuda and r.is_cuda)
    ref = torch.load(os.path.join(work, "ref_params.pt"), map_location=dev)
    for dp, mp, fsdp in TWO_RANK_MESHES:
        with use_mesh(create_mesh(model_parallel=mp, data_parallel=dp, fsdp=fsdp,
                                  device=dev)) as mesh:
            metrics, ms, counts, state = _tutorial_steps(torch, mesh)
            full = gather_params(state["params"], mesh)
            mu = gather_params(state["opt_state"]["mu"], mesh)
            pairs = list(zip(tree_leaves(full), tree_leaves(ref["params"])))
            far = sum(int(((a - b).abs() > TWO_RANK_LR / 10).sum()) for a, b in pairs)
            res["train"][f"{dp}x{mp}{' fsdp' if fsdp else ''}"] = {
                "metrics": metrics, "ms": ms, "flash_launches": counts[0],
                "flash_plain_calls": counts[1],
                "param_max_abs_diff": max((a - b).abs().max().item() for a, b in pairs),
                "param_far_share": far / sum(a.numel() for a, _ in pairs),
                "mu_rel_diff": max((a - b).abs().max().item() / b.abs().max().item()
                                   for a, b in zip(tree_leaves(mu), tree_leaves(ref["mu"])))}
            del state, full, mu
            torch.cuda.empty_cache()
    del ref
    with use_mesh(create_mesh(model_parallel=2, data_parallel=1, device=dev)) as mesh:
        for kv in ("int8", "int4"):
            logits, dms, launches, plain_calls = _tp_decode(torch, mesh, kv)
            want = torch.load(os.path.join(work, f"ref_logits_{kv}.pt"))
            V = want.shape[-1]
            rows = torch.arange(TP_BATCH)[:, None, None]
            steps = torch.arange(want.shape[1])[None, :, None]
            gumbel = -torch.log(-torch.log(hash_uniform(35, rows, torch.arange(V), steps)))
            res["decode"][kv] = {
                "ms": dms, "launches": launches, "plain_calls": plain_calls,
                "max_abs_diff": (logits - want).abs().max().item(),
                "max_abs_logit": want.abs().max().item(),
                "argmax_share": (logits.argmax(-1) == want.argmax(-1)).float().mean().item(),
                "ids_share": ((logits + gumbel).argmax(-1)
                              == (want + gumbel).argmax(-1)).float().mean().item()}
    res["cache_gap"] = (torch.load(os.path.join(work, "ref_logits_int4.pt"))
                        - torch.load(os.path.join(work, "ref_logits_int8.pt"))).abs().max().item()
    with open(os.path.join(work, f"two_{rank}.json"), "w") as f:
        json.dump(res, f)


def phase_two_ranks(torch, work: str, ran: dict) -> dict:
    """Two gloo ranks on the one card (NCCL refuses two ranks on one
    device) against a one-rank NCCL group on the same card: the tutorial
    steps at (dp, mp, fsdp) = (2, 1, no), (1, 2, no), (2, 1, yes), and
    cogview-base decode at TP=2 on the int8 (K1) and int4 (K2) caches; then
    the dry run's six passes on four ranks on the card, all run by
    ``phase_rank_spawns`` (``ran``: its seconds) -> the kernels' launches
    in the two-rank and one-rank runs, each rank's as it counted them."""
    d = os.path.join(work, "two_ranks")
    with open(os.path.join(d, "ref.json")) as f:
        ref = json.load(f)
    ranks = []
    for rank in range(2):
        with open(os.path.join(d, f"two_{rank}.json")) as f:
            ranks.append(json.load(f))
    tol = TWO_RANK_TOL
    print(f"one-rank group: backend {ref['backend']}, all_reduce / all_gather / reduce_scatter "
          f"on CUDA tensors {'correct' if ref['collectives_ok'] else 'WRONG'}; run in "
          f"{ran[1]['two_rank_reference']:.1f} s")
    print(f"two gloo ranks on the one card: all_reduce / all_gather / reduce_scatter on CUDA "
          f"tensors, results on the card and correct on each rank: "
          f"{[two['collectives_ok'] for two in ranks]}; run in "
          f"{ran[2]['two_rank_worker']:.1f} s")
    _check(ref["backend"] == "nccl" and ref["collectives_ok"]
           and all(two["collectives_ok"] for two in ranks),
           "a collective on CUDA tensors gave a wrong result")
    rm = ref["train"]["metrics"]
    _check(min(ref["train"]["flash_launches"]) > 0
           and ref["train"]["flash_plain_calls"] == [0, 0, 0],
           "one rank: the flash kernels did not run")
    flash = list(ref["train"]["flash_launches"])
    for name in ranks[0]["train"]:
        for rank, two in enumerate(ranks):
            r = two["train"][name]
            m = r["metrics"]
            for key, rt in (("lm_loss", tol["loss_rtol"]), ("grad_norm", tol["grad_norm_rtol"])):
                for a, b in zip(m, rm):
                    _check(abs(a[key] - b[key]) <= rt * abs(b[key]),
                           f"two ranks {name}, rank {rank}: {key} {a[key]} vs one rank {b[key]}")
            _check(r["param_max_abs_diff"] <= tol["param_atol"]
                   and r["param_far_share"] <= tol["param_far_share"]
                   and r["mu_rel_diff"] <= tol["mu_rtol"],
                   f"two ranks {name}, rank {rank}: params or Adam moments differ "
                   f"({r['param_max_abs_diff']}, {r['param_far_share']}, {r['mu_rel_diff']})")
            _check(min(r["flash_launches"]) > 0 and r["flash_plain_calls"] == [0, 0, 0],
                   f"two ranks {name}, rank {rank}: the flash kernels did not run")
            flash = [a + b for a, b in zip(flash, r["flash_launches"])]
        r = ranks[0]["train"][name]
        m = r["metrics"]
        print(f"tutorial train steps at (dp, mp) = {name}, batch {TWO_RANK_BATCH} x 1,088, "
              f"dropout 0.1, rank 0: lm loss {['%.5f' % x['lm_loss'] for x in m]} vs one rank "
              f"{['%.5f' % x['lm_loss'] for x in rm]}, grad norm "
              f"{['%.4f' % x['grad_norm'] for x in m]} vs {['%.4f' % x['grad_norm'] for x in rm]}; "
              f"params after step {TWO_RANK_STEPS} max |diff| {r['param_max_abs_diff']:.3e} (tol "
              f"{tol['param_atol']:.4e}), share off by > lr/10 {r['param_far_share']:.2e}; Adam's "
              f"first moment {r['mu_rel_diff']:.2e} of each leaf's max; K3/K4/K5 launches on "
              f"ranks 0 and 1 {[two['train'][name]['flash_launches'] for two in ranks]}; ms a "
              f"step, two ranks share one card: {['%.1f' % x for x in r['ms']]} (one rank alone: "
              f"{['%.1f' % x for x in ref['train']['ms']]})")
    decode = {}
    gap = ranks[0]["cache_gap"]
    print(f"for scale: the one-rank int4 logits differ from the one-rank int8 logits by up to "
          f"{gap:.4f}")
    for kv in ("int8", "int4"):
        rr = ref["decode"][kv]
        _check(rr["launches"] == 48 * TP_STEPS and rr["plain_calls"] == 0,
               f"one-rank {kv} decode: {rr['launches']} kernel launches, {rr['plain_calls']} "
               f"plain-version calls, not one launch a layer and step")
        decode[kv] = rr["launches"]
        for rank, two in enumerate(ranks):
            r = two["decode"][kv]
            _check(r["max_abs_diff"] <= tol["logit_atol"][kv]
                   and r["argmax_share"] >= tol["argmax_share"][kv]
                   and r["ids_share"] >= tol["ids_share"],
                   f"TP=2 {kv} decode on rank {rank} differs from the one-rank run")
            _check(r["launches"] == 48 * TP_STEPS and r["plain_calls"] == 0,
                   f"TP=2 {kv} decode on rank {rank}: {r['launches']} kernel launches, "
                   f"{r['plain_calls']} plain-version calls, not one launch a layer and step")
            decode[kv] += r["launches"]
        r = ranks[0]["decode"][kv]
        print(f"cogview-base TP=2 (20 heads a rank) {kv} cache, batch {TP_BATCH}, rank 0: prefill "
              f"{TP_CTX} + {TP_STEPS} decode steps; logits max |diff| {r['max_abs_diff']:.4f} of "
              f"max |logit| {r['max_abs_logit']:.3f}, argmax agreement {r['argmax_share']:.4f}, "
              f"ids under fixed gumbel draws equal {r['ids_share']:.4f}; decode-kernel launches on "
              f"ranks 0 and 1 {[two['decode'][kv]['launches'] for two in ranks]} (one rank "
              f"{rr['launches']}); ms a decode step, two ranks share one card: median "
              f"{statistics.median(r['ms']):.1f} (one rank alone: "
              f"{statistics.median(rr['ms']):.1f})")
    with open(os.path.join(d, "dryrun_4.txt")) as f:
        lines = f.read().splitlines()
    for line in lines:
        print(line)
    _check(len(lines) == 6 and all(ln.startswith("dryrun_multichip ok") for ln in lines),
           f"the dry run on the card: {lines}")
    print(f"dry run, four gloo ranks share the card: passes 1-6 ok in "
          f"{ran[4]['dryrun_passes']:.1f} s")
    return {"flash": flash, "decode": decode}


# --------------------------------------------------------------------- #
# phase 29: ring attention and the GPipe pipeline, two ranks on the one card
# --------------------------------------------------------------------- #

RING_B, RING_S, RING_N, RING_D = 2, 1088, 40, 64  # cogview-base's training shape
RING_CASES = ((0, 0.0), (0, 0.1), (64, 0.0), (64, 0.1))  # (sep, dropout)
RING_SEED = 2929
# the two ranks hold the whole replicated model and its Adam state (about
# 1.26 GB a layer each): two of them fit about 12 layers in 80 GB; SP's
# depth is cut to 4 to keep the script inside its time limit (a step
# all-reduces every float32 gradient over 'seq' through gloo: 10 s at 12
# layers on two ranks sharing an H100)
SP_LAYERS, PP_LAYERS, RING_STEPS, RING_LR = 4, 48, 2, 1e-4
# bf16 ring against bf16 dense attention: the ring rounds its unnormalized
# probabilities to bf16, dense its normalized ones, so the two differ by
# about one bf16 step of the largest output (0.4-0.6% of the largest
# gradient on a 512-position CPU rehearsal)
RING_TOL = {"o_rel": 1e-2, "grad_rel": 2e-2}
# the SP and PP steps are compared with one rank in float32 compute, held
# to TWO_RANK_TOL: in bf16 the ring rounds its unnormalized probabilities
# where the dense route rounds the normalized ones, and a microbatch's
# matmuls take other shapes than the whole batch's, and over 12 and 48
# layers Adam turned those roundings into 1.30% and 2.80% of the params
# off by more than lr / 10 (NVIDIA H100 80GB HBM3); the bf16 ring is held
# to dense attention above, and the pipeline's bf16 step is checked finite
SAMPLES, LAYER_SAMPLES = 4096, 256  # elements of each leaf, and of each of its layers
# the new memory (the layers' float32 outputs) of the SP step against one
# rank's: max |diff| over max |value|
SP_MEMS_TOL = 1e-4


def _leaf_samples(torch, tree, mesh=None):
    """Evenly strided elements of every leaf of ``tree`` (``tree_leaves``
    order), float32 on the CPU: about SAMPLES of each whole leaf (all of a
    smaller one), and of each stacked layer leaf about LAYER_SAMPLES of
    every layer, gathered over 'pipe' where ``mesh`` splits the layers (a
    few KB cross the group, not the leaves)."""
    from cogview_tpu_torch.parallel import comm
    from cogview_tpu_torch.parallel.mesh import PIPE_AXIS
    from cogview_tpu_torch.training.optim import tree_leaves

    out = []
    for t in tree_leaves({k: v for k, v in tree.items() if k != "layers"}):
        out.append(t.detach().reshape(-1)[::max(1, t.numel() // SAMPLES)].float().cpu())
    for t in tree_leaves(tree["layers"]):
        rows = t.detach().reshape(t.shape[0], -1)
        rows = rows[:, ::max(1, rows.shape[1] // LAYER_SAMPLES)].float().contiguous()
        out.append(comm.all_gather(rows, PIPE_AXIS, 0, mesh).cpu())
    return out


def _base_steps(torch, mesh, layers: int, dropout: float, flash_min_seq: int, steps: int):
    """``steps`` cogview-base train steps (``layers`` deep, the published
    widths, float32 compute) from seeded params at batch RING_B x 1,088 on
    this rank's part of ``mesh`` (None: one rank) -> (metrics, ms a step,
    [K3, K4, K5]
    launches, their plain versions' calls, the param and Adam-moment
    samples, peak GiB, the state, the config and the optimizer)."""
    import numpy as np

    from cogview_tpu_torch import config as C
    from cogview_tpu_torch.models import gpt
    from cogview_tpu_torch.ops import flash_attention as fa
    from cogview_tpu_torch.parallel.sharding import shard_params
    from cogview_tpu_torch.training import optim
    from cogview_tpu_torch.training import train_loop as tl

    dev = torch.device("cuda")
    cfg = C.cogview_base(num_layers=layers, embedding_dropout=dropout,
                         attention_dropout=dropout, output_dropout=dropout,
                         flash_min_seq=flash_min_seq, pp_microbatches=2,
                         compute_dtype=torch.float32)
    torch.cuda.reset_peak_memory_stats()
    params = gpt.init_params(cfg, torch.Generator(device=dev).manual_seed(29), device=dev)
    if mesh is not None:
        params = shard_params(params, mesh)
        torch.cuda.empty_cache()
    opt, _ = optim.make_optimizer(params, lr=RING_LR, warmup_iter=1, num_iters=10)
    state = tl.init_train_state(params, opt, torch.Generator().manual_seed(30))
    step = tl.make_train_step(cfg, opt, img_vocab=8192)
    text = np.random.RandomState(29).randint(0, 58219, (RING_B, 1089)).astype(np.int64)
    batch = {"text": text, "loss_mask": np.ones_like(text, np.float32)}
    _zero_flash_counts(fa)
    metrics, ms = [], []
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, batch)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1000.0)
        metrics.append(m)
    launches, plain = _flash_counts(fa)
    samples = {"params": _leaf_samples(torch, state["params"], mesh),
               "mu": _leaf_samples(torch, state["opt_state"]["mu"], mesh)}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    return metrics, ms, launches, plain, samples, peak, state, cfg, opt


SP_MEM = 128  # positions of the seeded memory of the SP step with --max-memory-length


def _sp_mems_step(torch, mesh):
    """One cogview-base train step, SP_LAYERS deep, float32, every dropout
    at 0.1, with the transformer-XL memory (max_memory_length SP_MEM, a
    seeded memory of SP_MEM positions) on this rank's part of ``mesh``
    (None: one rank); under 'seq' each layer attends over the gathered
    sequence -> (metrics, ms, the param and Adam-moment samples, strided
    samples of the new memory, peak GiB)."""
    import numpy as np

    from cogview_tpu_torch import config as C
    from cogview_tpu_torch.models import gpt
    from cogview_tpu_torch.parallel.sharding import shard_params
    from cogview_tpu_torch.training import optim
    from cogview_tpu_torch.training import train_loop as tl

    dev = torch.device("cuda")
    cfg = C.cogview_base(num_layers=SP_LAYERS, embedding_dropout=0.1, attention_dropout=0.1,
                         output_dropout=0.1, compute_dtype=torch.float32)
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=dev).manual_seed(33)
    params = gpt.init_params(cfg, gen, device=dev)
    if mesh is not None:
        params = shard_params(params, mesh)
    opt, _ = optim.make_optimizer(params, lr=RING_LR, warmup_iter=1, num_iters=10)
    state = tl.init_train_state(params, opt, torch.Generator().manual_seed(34))
    step = tl.make_train_step(cfg, opt, img_vocab=8192, max_memory_length=SP_MEM)
    mems = torch.randn((SP_LAYERS + 1, RING_B, SP_MEM, cfg.hidden_size), generator=gen,
                       device=dev)
    text = np.random.RandomState(33).randint(0, 58219, (RING_B, 1089)).astype(np.int64)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, m, new_mems = step(state, {"text": text, "loss_mask": np.ones_like(text, np.float32)},
                              mems=mems)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1000.0
    samples = {"params": _leaf_samples(torch, state["params"], mesh),
               "mu": _leaf_samples(torch, state["opt_state"]["mu"], mesh),
               "mems": new_mems.reshape(-1)[::max(1, new_mems.numel() // SAMPLES)].cpu()}
    return m, ms, samples, torch.cuda.max_memory_allocated() / 2 ** 30


def _ring_qkv(torch, dev):
    """The whole q, k, v and an output cotangent [B, S, N, D], bf16, from
    RING_SEED on ``dev``."""
    g = torch.Generator(device=dev).manual_seed(RING_SEED)
    return [torch.randn((RING_B, RING_S, RING_N, RING_D), generator=g, device=dev
                        ).to(torch.bfloat16) for _ in range(4)]


def ring_reference(rank: int, world: int, work: str) -> None:
    """The one-rank references of phase 29: K3 at the ring's global shape
    (its time), 2 SP_LAYERS-deep steps on the dense route with dropout 0.1,
    and 2 PP_LAYERS-deep steps through the flash kernels without dropout,
    written to ``work``."""
    import torch

    from cogview_tpu_torch.ops import flash_attention as fa

    dev = torch.device("cuda")
    q, k, v, _ = _ring_qkv(torch, dev)
    res = {"k3_ms": _device_time_us(torch, lambda: fa.flash_attention(q, k, v, 0)) / 1000.0}
    del q, k, v
    for name, layers, drop, fmin in (("sp", SP_LAYERS, 0.1, 4096),
                                     ("pp", PP_LAYERS, 0.0, 1024)):
        metrics, ms, launches, plain, samples, peak, state, _, _ = _base_steps(
            torch, None, layers, drop, fmin, RING_STEPS)
        torch.save(samples, os.path.join(work, f"ring_ref_{name}.pt"))
        res[name] = {"metrics": metrics, "ms": ms, "flash_launches": launches,
                     "flash_plain_calls": plain, "peak_gib": peak}
        del state
        torch.cuda.empty_cache()
    m, ms, samples, peak = _sp_mems_step(torch, None)
    torch.save(samples, os.path.join(work, "ring_ref_sp_mems.pt"))
    res["sp_mems"] = {"metrics": m, "ms": ms, "peak_gib": peak}
    torch.cuda.empty_cache()
    with open(os.path.join(work, "ring_ref.json"), "w") as f:
        json.dump(res, f)


def _compare_samples(got, want):
    """-> (max |param diff|, share of param samples off by > lr / 10, Adam
    moment's max |diff| over each leaf's max)."""
    pairs = list(zip(got["params"], want["params"]))
    far = sum(int(((a - b).abs() > RING_LR / 10).sum()) for a, b in pairs)
    return (max((a - b).abs().max().item() for a, b in pairs),
            far / sum(a.numel() for a, _ in pairs),
            max((a - b).abs().max().item() / max(b.abs().max().item(), 1e-30)
                for a, b in zip(got["mu"], want["mu"])))


def ring_worker(rank: int, world: int, work: str) -> None:
    """One of two gloo ranks on the one card: (a) the ppermute route gloo
    takes on CUDA tensors, and one shift and its backward; (b) ring
    attention at cogview-base widths over seq 2 against dense attention
    on the whole sequence (o, dq, dk, dv; the keep masks), and its time;
    (c) 2 SP = 2 train steps, SP_LAYERS deep, dropout 0.1; (d) 2 PP = 2
    train steps at PP_LAYERS, dropout 0, then one with dropout 0.1.  Each
    rank writes its results, launches and plain-version calls to
    ring_<rank>.json."""
    import numpy as np
    import torch

    from cogview_tpu_torch.ops import flash_attention as fa
    from cogview_tpu_torch.ops.attention import causal_mask, dense_attention
    from cogview_tpu_torch.ops.hash_prng import hash_dropout
    from cogview_tpu_torch.ops.ring_attention import keep_mask, ring_attention
    from cogview_tpu_torch.parallel import comm
    from cogview_tpu_torch.parallel.mesh import SEQ_AXIS, create_mesh, use_mesh
    from cogview_tpu_torch.training import train_loop as tl

    dev = torch.device("cuda")
    res = {"ring": {}}
    with use_mesh(create_mesh(seq_parallel=2, device=dev)) as mesh:
        x = (torch.arange(8, dtype=torch.float32, device=dev) + 10 * rank).requires_grad_(True)
        y = comm.ppermute(x, SEQ_AXIS, 1)
        (gx,) = torch.autograd.grad((y * (1 + rank)).sum(), x)
        other = 1 - rank
        res["route"] = comm.ppermute_route(dev)
        res["ppermute_ok"] = bool(
            y.is_cuda and torch.equal(y, torch.arange(8, dtype=torch.float32, device=dev)
                                      + 10 * other)
            and torch.equal(gx, torch.full_like(gx, 1.0 + other)))

        q, k, v, do = _ring_qkv(torch, dev)
        Sc = RING_S // 2
        sl = slice(rank * Sc, (rank + 1) * Sc)
        for sep, rate in RING_CASES:
            ql, kl, vl = (t[:, sl].clone().requires_grad_(True) for t in (q, k, v))
            kw = dict(sep=sep, dropout_rate=rate, dropout_seed=RING_SEED + sep, train=True)
            o = ring_attention(ql, kl, vl, **kw)
            grads = torch.autograd.grad((o.float() * do[:, sl].float()).sum(), (ql, kl, vl))
            got = [comm.all_gather(t.contiguous(), SEQ_AXIS, 1) for t in (o,) + grads]
            qf, kf, vf = (t.clone().requires_grad_(True) for t in (q, k, v))
            ref = dense_attention(qf, kf, vf, causal_mask(RING_S, sep=sep, device=dev),
                                  dropout_rate=rate, dropout_seed=RING_SEED + sep, train=True)
            want = [ref] + list(torch.autograd.grad((ref.float() * do.float()).sum(),
                                                    (qf, kf, vf)))
            errs = [((a.float() - b.float()).abs().max() / b.float().abs().max()).item()
                    for a, b in zip(got, want)]
            rec = {"o_rel": errs[0], "dq_rel": errs[1], "dk_rel": errs[2], "dv_rel": errs[3]}
            if rate > 0.0:
                full = (RING_B, RING_N, RING_S, RING_S)
                blk = (RING_B, RING_N, Sc, Sc)
                ring_keep = torch.cat([torch.cat(
                    [keep_mask(blk, rate, RING_SEED + sep, (0, 0, i * Sc, j * Sc), full, dev)
                     for j in range(2)], dim=3) for i in range(2)], dim=2)
                dense_keep = hash_dropout(torch.ones(full, device=dev), rate,
                                          RING_SEED + sep, salt=1) != 0
                rec["keep_equal"] = bool(torch.equal(ring_keep, dense_keep))
                rec["keep_share"] = dense_keep.float().mean().item()
                del ring_keep, dense_keep
            if (sep, rate) == (0, 0.0):
                rec["ring_ms"] = _device_time_us(torch, lambda: ring_attention(
                    q[:, sl], k[:, sl], v[:, sl], sep=0)) / 1000.0
                rec["plain_ms"] = _device_time_us(torch, lambda: dense_attention(
                    q, k, v, causal_mask(RING_S, device=dev))) / 1000.0
            res["ring"][f"sep{sep} dropout{rate}"] = rec
            del ql, kl, vl, o, grads, got, qf, kf, vf, ref, want
        del q, k, v, do
        torch.cuda.empty_cache()

    want = {name: torch.load(os.path.join(work, f"ring_ref_{name}.pt"))
            for name in ("sp", "pp", "sp_mems")}
    with use_mesh(create_mesh(seq_parallel=2, device=dev)) as mesh:
        # the gather route: the memory's layers attend over the whole sequence
        m, ms, samples, peak = _sp_mems_step(torch, mesh)
        diff, far, mu = _compare_samples(samples, want["sp_mems"])
        ref_mems = want["sp_mems"]["mems"]
        res["sp_mems"] = {"metrics": m, "ms": ms, "param_max_abs_diff": diff,
                          "param_far_share": far, "mu_rel_diff": mu, "peak_gib": peak,
                          "mems_rel_diff": float((samples["mems"] - ref_mems).abs().max()
                                                 / ref_mems.abs().max())}
        torch.cuda.empty_cache()
    for name, layers, drop, fmin, axes in (("sp", SP_LAYERS, 0.1, 4096, dict(seq_parallel=2)),
                                           ("pp", PP_LAYERS, 0.0, 1024, dict(pipe_parallel=2))):
        with use_mesh(create_mesh(device=dev, **axes)) as mesh:
            metrics, ms, launches, plain, samples, peak, state, cfg, opt = _base_steps(
                torch, mesh, layers, drop, fmin, RING_STEPS)
            diff, far, mu = _compare_samples(samples, want[name])
            res[name] = {"metrics": metrics, "ms": ms, "flash_launches": launches,
                         "flash_plain_calls": plain, "param_max_abs_diff": diff,
                         "param_far_share": far, "mu_rel_diff": mu, "peak_gib": peak}
            if name == "pp":
                # one more step on the same state, in bf16 with every
                # dropout at 0.1
                step = tl.make_train_step(cfg.replace(
                    embedding_dropout=0.1, attention_dropout=0.1, output_dropout=0.1,
                    compute_dtype=torch.bfloat16), opt, img_vocab=8192)
                text = np.random.RandomState(31).randint(0, 58219, (RING_B, 1089))
                _zero_flash_counts(fa)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                _, m = step(state, {"text": text, "loss_mask": np.ones(text.shape, np.float32)})
                torch.cuda.synchronize()
                launches, plain = _flash_counts(fa)
                res["pp_dropout"] = {"metrics": m, "ms": (time.perf_counter() - t0) * 1000.0,
                                     "flash_launches": launches, "flash_plain_calls": plain,
                                     "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
            del state
            torch.cuda.empty_cache()
    with open(os.path.join(work, f"ring_{rank}.json"), "w") as f:
        json.dump(res, f)


def phase_ring_pipeline(torch, work: str, ran: dict) -> list:
    """Ring attention (SP) and GPipe (PP) on two gloo ranks sharing the
    card, against a one-rank NCCL group's references on the same card
    (ring_reference, ring_worker, run by ``phase_rank_spawns``; ``ran``:
    its seconds); then the dry run's six passes on eight ranks on the card
    -> the flash kernels' launches of the PP steps on both ranks, each
    rank's as it counted them."""
    from cogview_tpu_torch.dryrun import dryrun_multichip

    d = os.path.join(work, "ring")
    with open(os.path.join(d, "ring_ref.json")) as f:
        ref = json.load(f)
    ranks = []
    for rank in range(2):
        with open(os.path.join(d, f"ring_{rank}.json")) as f:
            ranks.append(json.load(f))
    print(f"ring/pipeline one-rank references run in {ran[1]['ring_reference']:.1f} s; two gloo "
          f"ranks in {ran[2]['ring_worker']:.1f} s")
    print(f"ppermute on CUDA tensors under gloo: route {[r['route'] for r in ranks]}, one shift "
          f"and its backward correct on each rank: {[r['ppermute_ok'] for r in ranks]}")
    _check(all(r["ppermute_ok"] and r["route"] == "all_gather" for r in ranks),
           "ppermute on CUDA tensors under gloo")
    for key in ranks[0]["ring"]:
        for rank, r in enumerate(ranks):
            rec = r["ring"][key]
            _check(rec["o_rel"] <= RING_TOL["o_rel"]
                   and max(rec["dq_rel"], rec["dk_rel"], rec["dv_rel"]) <= RING_TOL["grad_rel"]
                   and rec.get("keep_equal", True),
                   f"ring attention {key}, rank {rank}, differs from dense attention: {rec}")
        rec = ranks[0]["ring"][key]
        keep = (f"; keep masks of the 2 x 2 blocks equal the dense mask: {rec['keep_equal']} "
                f"(kept {rec['keep_share']:.4f})" if "keep_equal" in rec else "")
        print(f"ring attention B={RING_B} S={RING_S} N={RING_N} D={RING_D} bf16 seq 2, {key}: "
              f"max |diff| over max |dense| o {rec['o_rel']:.2e}, dq {rec['dq_rel']:.2e}, dk "
              f"{rec['dk_rel']:.2e}, dv {rec['dv_rel']:.2e} (tol {RING_TOL['o_rel']}, "
              f"{RING_TOL['grad_rel']}){keep}")
    rt = ranks[0]["ring"]["sep0 dropout0.0"]
    print(f"ring forward, sep 0, no dropout, each rank's block, two ranks share one card: "
          f"{[r['ring']['sep0 dropout0.0']['ring_ms'] for r in ranks]} ms; dense plain version "
          f"on the whole sequence {rt['plain_ms']:.3f} ms; K3 on the whole sequence, one rank "
          f"alone: {ref['k3_ms']:.3f} ms")
    tol = TWO_RANK_TOL
    flash = [0, 0, 0]
    for name, what in (("sp", f"SP=2 (ring), {SP_LAYERS} layers, float32, dropout 0.1, against "
                              f"one rank on the dense route"),
                       ("pp", f"PP=2 (GPipe, 2 microbatches), {PP_LAYERS} layers, float32, "
                              f"dropout 0, against one rank unpipelined")):
        rr = ref[name]
        for rank, two in enumerate(ranks):
            r = two[name]
            for key, rt in (("lm_loss", tol["loss_rtol"]), ("grad_norm", tol["grad_norm_rtol"])):
                for a, b in zip(r["metrics"], rr["metrics"]):
                    _check(abs(a[key] - b[key]) <= rt * abs(b[key]),
                           f"{name} rank {rank}: {key} {a[key]} vs one rank {b[key]}")
            _check(r["param_max_abs_diff"] <= tol["param_atol"]
                   and r["param_far_share"] <= tol["param_far_share"]
                   and r["mu_rel_diff"] <= tol["mu_rtol"],
                   f"{name} rank {rank}: params or Adam moments differ "
                   f"({r['param_max_abs_diff']}, {r['param_far_share']}, {r['mu_rel_diff']})")
            _check(r["flash_plain_calls"] == [0, 0, 0],
                   f"{name} rank {rank}: a flash plain version ran")
        if name == "pp":
            for rank, two in enumerate(ranks):
                # each stage: 24 layers, the forward twice (remat) and each
                # backward kernel once per layer and microbatch
                per = PP_LAYERS // 2 * 2 * RING_STEPS
                _check(two["pp"]["flash_launches"] == [2 * per, per, per],
                       f"pp rank {rank}: flash launches {two['pp']['flash_launches']}, not "
                       f"{[2 * per, per, per]}")
                flash = [a + b for a, b in zip(flash, two["pp"]["flash_launches"])]
            _check(rr["flash_launches"][0] > 0 and rr["flash_plain_calls"] == [0, 0, 0],
                   "pp one rank: the flash kernels did not run")
        else:
            _check(all(two["sp"]["flash_launches"] == [0, 0, 0] for two in ranks),
                   "sp: a flash kernel ran on the ring route")
        r = ranks[0][name]
        print(f"cogview-base {what}, batch {RING_B} x 1,088, rank 0: lm loss "
              f"{['%.5f' % x['lm_loss'] for x in r['metrics']]} vs one rank "
              f"{['%.5f' % x['lm_loss'] for x in rr['metrics']]}, grad norm "
              f"{['%.4f' % x['grad_norm'] for x in r['metrics']]} vs "
              f"{['%.4f' % x['grad_norm'] for x in rr['metrics']]}; sampled params after step "
              f"{RING_STEPS} max |diff| {r['param_max_abs_diff']:.3e} (tol {tol['param_atol']:.4e}), "
              f"share off by > lr/10 {r['param_far_share']:.2e}; Adam's first moment "
              f"{r['mu_rel_diff']:.2e}; K3/K4/K5 launches on ranks 0 and 1 "
              f"{[two[name]['flash_launches'] for two in ranks]} (one rank "
              f"{rr['flash_launches']}), plain-version calls "
              f"{[two[name]['flash_plain_calls'] for two in ranks]}; peak GiB on ranks 0 and 1 "
              f"{['%.2f' % two[name]['peak_gib'] for two in ranks]} (one rank "
              f"{rr['peak_gib']:.2f}); ms a step, two ranks share one card: "
              f"{['%.1f' % x for x in r['ms']]} (one rank alone: "
              f"{['%.1f' % x for x in rr['ms']]})")
    rr = ref["sp_mems"]
    for rank, two in enumerate(ranks):
        r = two["sp_mems"]
        _check(abs(r["metrics"]["lm_loss"] - rr["metrics"]["lm_loss"])
               <= tol["loss_rtol"] * abs(rr["metrics"]["lm_loss"])
               and abs(r["metrics"]["grad_norm"] - rr["metrics"]["grad_norm"])
               <= tol["grad_norm_rtol"] * abs(rr["metrics"]["grad_norm"])
               and r["param_max_abs_diff"] <= tol["param_atol"]
               and r["param_far_share"] <= tol["param_far_share"]
               and r["mu_rel_diff"] <= tol["mu_rtol"] and r["mems_rel_diff"] <= SP_MEMS_TOL,
               f"sp with --max-memory-length, rank {rank}: {r} vs one rank {rr}")
    r = ranks[0]["sp_mems"]
    print(f"SP=2 step with --max-memory-length {SP_MEM} (a seeded memory of {SP_MEM} "
          f"positions), cogview-base, {SP_LAYERS} layers, float32, dropout 0.1, the gather "
          f"route, against one rank: lm loss {r['metrics']['lm_loss']:.6f} vs "
          f"{rr['metrics']['lm_loss']:.6f}, grad norm {r['metrics']['grad_norm']:.5f} vs "
          f"{rr['metrics']['grad_norm']:.5f}; sampled params max |diff| "
          f"{r['param_max_abs_diff']:.3e}, share off by > lr/10 {r['param_far_share']:.2e}, "
          f"Adam's first moment {r['mu_rel_diff']:.2e} (tolerances as the SP steps); the new "
          f"memory's samples max |diff| / max {r['mems_rel_diff']:.2e} (tol {SP_MEMS_TOL}); "
          f"peak GiB {['%.2f' % two['sp_mems']['peak_gib'] for two in ranks]} (one rank "
          f"{rr['peak_gib']:.2f}); {r['ms']:.1f} ms, two ranks share one card (one rank alone "
          f"{rr['ms']:.1f} ms)")
    for rank, two in enumerate(ranks):
        r = two["pp_dropout"]
        _check(math.isfinite(r["metrics"]["lm_loss"]) and math.isfinite(r["metrics"]["grad_norm"])
               and r["metrics"]["skipped"] == 0 and r["flash_plain_calls"] == [0, 0, 0]
               and min(r["flash_launches"]) > 0,
               f"pp with dropout 0.1, rank {rank}: {r}")
        flash = [a + b for a, b in zip(flash, r["flash_launches"])]
    r = ranks[0]["pp_dropout"]
    print(f"PP=2 step in bf16 with dropout 0.1: lm loss {r['metrics']['lm_loss']:.5f}, grad norm "
          f"{r['metrics']['grad_norm']:.4f}, finite; K3/K4/K5 launches on ranks 0 and 1 "
          f"{[two['pp_dropout']['flash_launches'] for two in ranks]}; peak GiB "
          f"{['%.2f' % two['pp_dropout']['peak_gib'] for two in ranks]}; {r['ms']:.1f} ms, two "
          f"ranks share one card")
    t3 = time.perf_counter()
    lines = dryrun_multichip(8, device="cuda", timeout=300)
    _check(len(lines) == 6 and all(ln.startswith("dryrun_multichip ok") for ln in lines),
           f"the dry run on the card: {lines}")
    print(f"dry run, eight gloo ranks share the card: passes 1-6 ok in "
          f"{time.perf_counter() - t3:.1f} s")
    return flash


# phase 30: data-parallel vqtrain and the data x pipe dropout step
VQ_DP = {"channel": 512, "embed_dim": 256, "n_embed": 8192, "size": 256, "batch": 8,
         "st_steps": 2}  # the released geometry, global batch 8
VQ_DP_LR = 3e-4
# two ranks against one on the same global batch, float32 with TF32 off:
# each rank's convolutions run at batch 4 where one rank's run at 8, and
# the gradients and EMA sums add in another order, so the losses agree to
# float32 rounding; Adam turns a near-zero gradient into a step of up to
# lr, so a param may differ by 2 lr, with at most 1% of the samples off by
# more than lr / 10; a code that flips between two near-equal distances
# moves one count between two codes' EMA statistics, so each EMA buffer is
# held by its share of elements off by more than 1e-3 of its largest
VQ_DP_TOL = {"loss_rtol": 1e-4, "param_atol": 2 * VQ_DP_LR + 1e-6, "param_far_share": 1e-2,
             "ema_rel": 1e-3, "ema_far_share": 1e-2}
# data 2 x pipe 2 against data 1 x pipe 2 on the same global batch, every
# dropout at 0.1: the masks hash the same global coordinates, so the two
# differ by float32 rounding (a microbatch's rows split over 'data' run
# smaller matmuls, and PB-relax's max is over a rank's rows)
PP_DP = {"layers": 4, "batch": 8, "seq": 1088, "dropout": 0.1, "lr": 1e-4, "steps": 1}
PP_DP1 = dict(PP_DP, batch=2)  # phase 30b: one row a microbatch
PP_DP_TOL = {"loss_rtol": 1e-5, "grad_norm_rtol": 1e-4, "param_atol": 2 * 1e-4 + 1e-6,
             "param_far_share": 1e-2}
# elements of each leaf compared, evenly strided
SLICE_SAMPLES = 4096


def _strided(t, n: int = SLICE_SAMPLES):
    flat = t.detach().reshape(-1)
    return flat[::max(1, flat.numel() // n)].float().cpu()


def vq_dp_worker(rank: int, world: int, work: str) -> None:
    """One of ``world`` ranks training the VQ-VAE of ``vq_dp.json`` on a
    'data' axis of every rank: st_steps straight-through + EMA steps, then
    one --gumbel-hard step, on one seeded global batch of which this rank
    takes its rows (and its rows of one global gumbel draw); writes each
    step's global metrics and ms, strided samples of every encoder and
    decoder leaf and the EMA buffers to vq_dp_<world>_<rank>."""
    import torch

    from cogview_tpu_torch.config import VQVAEConfig
    from cogview_tpu_torch.models import vqvae
    from cogview_tpu_torch.ops.precision import set_fp32_precision
    from cogview_tpu_torch.parallel.mesh import create_mesh, use_mesh
    from cogview_tpu_torch.parallel.pipeline import data_rows
    from cogview_tpu_torch.training import vqvae_train as vt
    from cogview_tpu_torch.training.optim import tree_leaves

    with open(os.path.join(work, "vq_dp.json")) as f:
        spec = json.load(f)
    set_fp32_precision()
    dev = torch.device("cuda", 0)
    B, S, K = spec["batch"], spec["size"], spec["n_embed"]
    cfg = VQVAEConfig(channel=spec["channel"], embed_dim=spec["embed_dim"], n_embed=K)
    res = {"metrics": [], "ms": []}
    with use_mesh(create_mesh(data_parallel=world, device=dev)) as mesh:
        rows = data_rows(B, mesh=mesh).to(dev)
        params = vqvae.with_ema_buffers(vqvae.tree_to(
            vqvae.init_params(cfg, torch.Generator().manual_seed(0)), dev))
        tx = vt.make_adam(params, VQ_DP_LR)
        state = vt.init_vqvae_train_state(params, tx)
        gen = torch.Generator(device=dev).manual_seed(31)
        steps = ([("st-ema", vt.make_vqvae_train_step(tx))] * spec["st_steps"]
                 + [("gumbel-hard", vt.make_vqvae_gumbel_train_step(tx, hard=True))])
        for mode, step in steps:
            batch = torch.randn((B, S, S, 3), generator=gen, device=dev)[rows]
            kw = {}
            if mode == "gumbel-hard":
                noise = vqvae.gumbel_noise((B, (S // 8) ** 2, K), gen, device=dev)
                kw = dict(temperature=1.0, noise=noise[rows].reshape(-1, K))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            m = step(state, batch, **kw)
            m = {k: float(v) for k, v in m.items()}  # waits for the step
            res["ms"].append((time.perf_counter() - t0) * 1000.0)
            res["metrics"].append(dict(m, mode=mode))
            del batch, kw
        p = state["params"]
        samples = [_strided(t) for t in tree_leaves({k: p[k] for k in vt.TRAINED})]
        ema = {k: p["quantize"][k].detach().float().cpu()
               for k in ("embed", "cluster_size", "embed_avg")}
        res["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    torch.save({"samples": samples, "ema": ema}, os.path.join(work, f"vq_dp_{world}_{rank}.pt"))
    with open(os.path.join(work, f"vq_dp_{world}_{rank}.json"), "w") as f:
        json.dump(res, f)


def pp_dp_worker(rank: int, world: int, work: str, name: str = "pp_dp") -> None:
    """One of ``world`` ranks of a data world/2 x pipe 2 mesh training
    ``<name>.json``'s config (the tutorial width, every dropout at 0.1,
    float32, 2 microbatches) on one seeded global batch: this data rank's
    rows are its shard of each microbatch (``pipeline.data_rows``); writes
    the metrics, ms a step, its rows, K3/K4/K5 launches and plain-version
    calls, and strided samples of every param to <name>_<world>_<rank>."""
    import numpy as np
    import torch

    from cogview_tpu_torch import config as C
    from cogview_tpu_torch.models import gpt
    from cogview_tpu_torch.ops import flash_attention as fa
    from cogview_tpu_torch.ops.precision import set_fp32_precision
    from cogview_tpu_torch.parallel.mesh import create_mesh, use_mesh
    from cogview_tpu_torch.parallel.pipeline import data_rows
    from cogview_tpu_torch.parallel.sharding import shard_params
    from cogview_tpu_torch.training import optim
    from cogview_tpu_torch.training import train_loop as tl

    with open(os.path.join(work, f"{name}.json")) as f:
        spec = json.load(f)
    set_fp32_precision()
    dev = torch.device("cuda", 0)
    r = spec["dropout"]
    cfg = C.cogview_tutorial(num_layers=spec["layers"], embedding_dropout=r,
                             attention_dropout=r, output_dropout=r, pp_microbatches=2,
                             compute_dtype=torch.float32)
    res = {"metrics": [], "ms": []}
    with use_mesh(create_mesh(data_parallel=world // 2, pipe_parallel=2, device=dev)) as mesh:
        params = shard_params(gpt.init_params(
            cfg, torch.Generator(device=dev).manual_seed(41), device=dev), mesh)
        opt, _ = optim.make_optimizer(params, lr=spec["lr"], warmup_iter=1, num_iters=10)
        state = tl.init_train_state(params, opt, torch.Generator().manual_seed(42))
        step = tl.make_train_step(cfg, opt, img_vocab=8192)
        rows = data_rows(spec["batch"], 2, mesh).numpy()
        res["rows"] = len(rows)
        _zero_flash_counts(fa)
        for i in range(spec["steps"]):
            text = np.random.RandomState(41 + i).randint(
                0, cfg.vocab_size, (spec["batch"], spec["seq"] + 1)).astype(np.int64)[rows]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = step(state, {"text": text, "loss_mask": np.ones(text.shape, np.float32)})
            torch.cuda.synchronize()
            res["ms"].append((time.perf_counter() - t0) * 1000.0)
            res["metrics"].append(m)
        res["flash_launches"], res["flash_plain_calls"] = _flash_counts(fa)
        samples = _leaf_samples(torch, state["params"], mesh)
        res["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    torch.save(samples, os.path.join(work, f"{name}_{world}_{rank}.pt"))
    with open(os.path.join(work, f"{name}_{world}_{rank}.json"), "w") as f:
        json.dump(res, f)


def pp_dp1_worker(rank: int, world: int, work: str) -> None:
    """pp_dp_worker on PP_DP1 (phase 30b): batch 2 in 2 microbatches, so
    that on a data axis of 2 the first data rank holds no row."""
    pp_dp_worker(rank, world, work, "pp_dp1")


def _load_ranks(d: str, prefix: str, world: int):
    """Each rank's JSON record, its saved tensors under "tensors"."""
    import torch

    out = []
    for rank in range(world):
        with open(os.path.join(d, f"{prefix}_{world}_{rank}.json")) as f:
            res = json.load(f)
        res["tensors"] = torch.load(os.path.join(d, f"{prefix}_{world}_{rank}.pt"))
        out.append(res)
    return out


def _far(a, b, atol):
    return float(((a - b).abs() > atol).float().mean())


def phase_data_parallel_slice(torch, work: str, smi: str, ran: dict) -> list:
    """vqtrain's data axis: the VQ-VAE at VQ_DP's geometry on two gloo ranks
    sharing the card (NCCL refuses two ranks on one device) against one
    rank alone, st_steps ST + EMA steps and a gumbel-hard step on the same
    global batch; then the data 2 x pipe 2 dropout step on four gloo
    ranks against data 1 x pipe 2 on two, all run by ``phase_rank_spawns``
    (``ran``: its seconds) -> the K3/K4/K5 launches of both pipeline runs,
    each rank's as it counted them."""
    d = os.path.join(work, "slice30")
    vq, pp = VQ_DP, PP_DP
    one, = _load_ranks(d, "vq_dp", 1)
    two = _load_ranks(d, "vq_dp", 2)
    tol = VQ_DP_TOL
    for rank, r in enumerate(two):
        for a, b in zip(r["metrics"], one["metrics"]):
            for key in ("loss", "recon_mse", "commit", "kl"):
                if key in b:
                    _check(abs(a[key] - b[key]) <= tol["loss_rtol"] * abs(b[key]),
                           f"vqtrain dp 2, rank {rank}, {a['mode']}: {key} {a[key]} vs one "
                           f"rank {b[key]}")
        pairs = list(zip(r["tensors"]["samples"], one["tensors"]["samples"]))
        pmax = max(float((a - b).abs().max()) for a, b in pairs)
        pfar = sum(int(((a - b).abs() > VQ_DP_LR / 10).sum()) for a, b in pairs) / sum(
            a.numel() for a, _ in pairs)
        ema = {}
        for k, b in one["tensors"]["ema"].items():
            a = r["tensors"]["ema"][k]
            scale = max(float(b.abs().max()), 1e-30)
            ema[k] = (float((a - b).abs().max()) / scale, _far(a, b, tol["ema_rel"] * scale))
        _check(pmax <= tol["param_atol"] and pfar <= tol["param_far_share"]
               and all(far <= tol["ema_far_share"] for _, far in ema.values()),
               f"vqtrain dp 2, rank {rank}: params ({pmax}, {pfar}) or EMA buffers {ema} "
               "differ from one rank")
        r.update(pmax=pmax, pfar=pfar, ema=ema)
    r = two[0]
    gc = "channel {channel}, embed {embed_dim}, {n_embed} codes, {batch} x {size}^2".format(**vq)
    print(f"vqtrain data axis ({smi}): 2 gloo ranks share the card (not a speed) against one "
          f"rank, {gc}, float32, TF32 off; per step {[m['mode'] for m in r['metrics']]}: "
          f"loss {['%.6f' % m['loss'] for m in r['metrics']]} vs one rank "
          f"{['%.6f' % m['loss'] for m in one['metrics']]} (rtol {tol['loss_rtol']}); "
          f"sampled encoder/decoder params max |diff| {r['pmax']:.3e} (tol "
          f"{tol['param_atol']:.2e}), share off by > lr/10 {r['pfar']:.2e} (tol "
          f"{tol['param_far_share']}); EMA buffers max |diff| / max, share off by > "
          f"{tol['ema_rel']} of max: "
          + ", ".join(f"{k} {a:.2e} {b:.2e}" for k, (a, b) in r["ema"].items())
          + f" (tol share {tol['ema_far_share']})")
    print(f"vqtrain data axis ms a step (st-ema x {vq['st_steps']}, gumbel-hard): two ranks "
          f"share one card {[['%.1f' % x for x in t['ms']] for t in two]}; one rank alone "
          f"{['%.1f' % x for x in one['ms']]}; run in {ran[1]['vq_dp_worker']:.1f} s (one) and "
          f"{ran[2]['vq_dp_worker']:.1f} s (two)")
    return _pp_dp_against_data_1(d, "pp_dp", pp, ran, smi)


def _pp_dp_against_data_1(d: str, name: str, pp: dict, ran: dict, smi: str) -> list:
    """``name``'s data 2 x pipe 2 ranks against its data 1 x pipe 2 ranks on
    the same global batch (phases 30 and 30b) -> the K3/K4/K5 launches of
    both runs.  A rank launches each flash kernel once a layer and
    microbatch on the rows it holds, and not at all where it holds none."""
    dp1 = _load_ranks(d, name, 2)
    dp2 = _load_ranks(d, name, 4)
    tol = PP_DP_TOL
    per = pp["layers"] // 2 * 2 * pp["steps"]  # a stage's layers x microbatches x steps
    flash = [0, 0, 0]
    for world, ranks in ((2, dp1), (4, dp2)):
        for rank, r in enumerate(ranks):
            # dp 2 splits each microbatch's rows: still one launch a layer
            # and microbatch, on fewer rows
            want = [2 * per, per, per] if r["rows"] else [0, 0, 0]
            _check(r["flash_launches"] == want and r["flash_plain_calls"] == [0, 0, 0],
                   f"{name} dp {world // 2} rank {rank}: flash launches {r['flash_launches']}, "
                   f"plain {r['flash_plain_calls']}, not {want}")
            flash = [a + b for a, b in zip(flash, r["flash_launches"])]
    for rank, r in enumerate(dp2):
        want = dp1[rank % 2]  # the same stage
        for a, b in zip(r["metrics"], want["metrics"]):
            _check(abs(a["lm_loss"] - b["lm_loss"]) <= tol["loss_rtol"] * abs(b["lm_loss"])
                   and abs(a["grad_norm"] - b["grad_norm"]) <= tol["grad_norm_rtol"]
                   * abs(b["grad_norm"]) and a["skipped"] == 0,
                   f"{name} data 2 x pipe 2 rank {rank}: {a} vs data 1 x pipe 2 {b}")
        pairs = list(zip(r["tensors"], want["tensors"]))
        r["pmax"] = max(float((a - b).abs().max()) for a, b in pairs)
        r["pfar"] = sum(int(((a - b).abs() > pp["lr"] / 10).sum()) for a, b in pairs) / sum(
            a.numel() for a, _ in pairs)
        _check(r["pmax"] <= tol["param_atol"] and r["pfar"] <= tol["param_far_share"],
               f"{name} data 2 x pipe 2 rank {rank}: params differ ({r['pmax']}, {r['pfar']})")
    r, w = dp2[0], dp1[0]
    worker = f"{name}_worker"
    print(f"data 2 x pipe 2 against data 1 x pipe 2 ({smi}), tutorial width, {pp['layers']} "
          f"layers, batch {pp['batch']} x {pp['seq']:,}, float32, every dropout at "
          f"{pp['dropout']}, 2 microbatches, {pp['steps']} step(s), rows by rank "
          f"{[x['rows'] for x in dp2]}: lm loss "
          f"{['%.7f' % m['lm_loss'] for m in r['metrics']]} vs "
          f"{['%.7f' % m['lm_loss'] for m in w['metrics']]} (rtol {tol['loss_rtol']}), grad norm "
          f"{['%.6f' % m['grad_norm'] for m in r['metrics']]} vs "
          f"{['%.6f' % m['grad_norm'] for m in w['metrics']]} (rtol {tol['grad_norm_rtol']}); "
          f"sampled params max |diff| {max(x['pmax'] for x in dp2):.3e} (tol "
          f"{tol['param_atol']:.2e}), share off by > lr/10 {max(x['pfar'] for x in dp2):.2e}; "
          f"K3/K4/K5 launches by rank {[x['flash_launches'] for x in dp2]} (data 1: "
          f"{[x['flash_launches'] for x in dp1]}), plain-version calls "
          f"{[x['flash_plain_calls'] for x in dp2]}; ms a step, ranks share one card (not a "
          f"speed): four {[['%.1f' % t for t in x['ms']] for x in dp2]}, two "
          f"{[['%.1f' % t for t in x['ms']] for x in dp1]}; run in "
          f"{ran[4][worker]:.1f} s (four) and {ran[2][worker]:.1f} s (two)")
    return flash


def phase_one_row_microbatches(torch, work: str, smi: str, ran: dict) -> list:
    """Phase 30b: data 2 x pipe 2 at one row a microbatch, the first data
    rank's shards empty, against data 1 x pipe 2 (``phase_rank_spawns``
    ran both) -> the K3/K4/K5 launches."""
    return _pp_dp_against_data_1(os.path.join(work, "slice30"), "pp_dp1", PP_DP1, ran, smi)


# --------------------------------------------------------------------- #
# the ranks of phases 28-30: one spawn for each world size
# --------------------------------------------------------------------- #

def dryrun_passes(rank: int, world: int, work: str) -> None:
    """The dry run's six passes on this rank; rank 0 writes their lines to
    dryrun_<world>.txt."""
    from cogview_tpu_torch.dryrun import passes

    passes(rank, world, os.path.join(work, f"dryrun_{world}.txt"), "cuda")


# each world size's functions in the order they run, each on its phase's
# folder: a rank runs them one after another in one process group, so the
# process start, CUDA's context and the first step's one-time costs are
# paid once a world size, not once a function.  The references come first
# (world 1), and the workers that turn TF32 off (vq_dp_worker,
# pp_dp_worker, as their entry points do) come last in their spawn
RANK_RUNS = {
    1: (("two_rank_reference", "two_ranks"), ("ring_reference", "ring"),
        ("vq_dp_worker", "slice30")),
    2: (("two_rank_worker", "two_ranks"), ("ring_worker", "ring"), ("vq_dp_worker", "slice30"),
        ("pp_dp_worker", "slice30"), ("pp_dp1_worker", "slice30")),
    4: (("dryrun_passes", "two_ranks"), ("pp_dp_worker", "slice30"),
        ("pp_dp1_worker", "slice30")),
}


def rank_runs(rank: int, world: int, work: str) -> None:
    """RANK_RUNS[world] on this rank, each function's device memory freed
    and peak reset before the next; rank 0 writes each one's seconds to
    ran_<world>.json."""
    import gc

    import torch

    secs = {}
    for name, folder in RANK_RUNS[world]:
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        globals()[name](rank, world, os.path.join(work, folder))
        secs[name] = time.perf_counter() - t0
        gc.collect()
        torch.cuda.empty_cache()
    if rank == 0:
        with open(os.path.join(work, f"ran_{world}.json"), "w") as f:
            json.dump(secs, f)


def phase_rank_spawns(torch, work: str) -> dict:
    """The spawns of phases 28-30 (RANK_RUNS), every rank on the one card
    -> {world: {function: seconds on rank 0}}, each world's whole spawn
    under "spawn"."""
    from cogview_tpu_torch.parallel.spawn import run_ranks

    torch.cuda.empty_cache()
    for folder in ("two_ranks", "ring", "slice30"):
        os.makedirs(os.path.join(work, folder), exist_ok=True)
    for name, spec in (("vq_dp", VQ_DP), ("pp_dp", PP_DP), ("pp_dp1", PP_DP1)):
        with open(os.path.join(work, "slice30", f"{name}.json"), "w") as f:
            json.dump(spec, f)
    # the 48-layer PP steps leave two ranks about 33 GiB each of the card:
    # let their allocators grow segments in place (fixed segments left 7 GiB
    # cached and unusable on a rank); the ranks' fork server starts with
    # this environment, and the script's own is restored after
    alloc = os.environ.get("PYTORCH_CUDA_ALLOC_CONF")
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    ran = {}
    try:
        for world, timeout in ((1, 900), (2, 1000), (4, 500)):
            t0 = time.perf_counter()
            run_ranks(rank_runs, world, work, work, device="cuda:0", timeout=timeout)
            with open(os.path.join(work, f"ran_{world}.json")) as f:
                ran[world] = json.load(f)
            ran[world]["spawn"] = time.perf_counter() - t0
    finally:
        if alloc is None:
            os.environ.pop("PYTORCH_CUDA_ALLOC_CONF")
        else:
            os.environ["PYTORCH_CUDA_ALLOC_CONF"] = alloc
    print("ranks of phases 28-30, every rank on the one card: "
          + "; ".join(f"{w} rank(s) spawned and run in {r['spawn']:.1f} s ("
                      + ", ".join(f"{k} {v:.1f} s" for k, v in r.items() if k != "spawn") + ")"
                      for w, r in ran.items()))
    return ran


def _bytecode_cache() -> None:
    """Python's bytecode cache for this process and every process it
    starts, in the build directory.  Where the installed packages'
    ``__pycache__`` cannot be written, each fresh process compiles the
    modules it imports again: a spawned rank's first remat step imports
    ``torch._dynamo`` (``torch.utils.checkpoint`` imports it lazily), 983
    modules compiled in 4.5 of 11 s on the card's host.  With the cache,
    the first process compiles them and the ranks read them."""
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "cogview_tpu_torch",
                        "build", "pycache")
    os.makedirs(path, exist_ok=True)
    sys.pycache_prefix = path
    sys.dont_write_bytecode = False
    os.environ["PYTHONPYCACHEPREFIX"] = path
    os.environ.pop("PYTHONDONTWRITEBYTECODE", None)


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
    _bytecode_cache()
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

    # phase 2: build the seven libraries, one nvcc each, in parallel
    t0 = time.perf_counter()
    names = ("decode_attention", *fa.LIBRARIES, "probes")
    sos = _kernels.build_all(names)
    for name in names:
        _kernels.lib(name)
    print(f"build: {', '.join(so.name for so in sos)} in {time.perf_counter() - t0:.2f} s")

    # phases 3-5: kernels against their plain versions
    k1 = phase_kernel(torch, da, packed=False)
    k2 = phase_kernel(torch, da, packed=True)
    _check_decode_kernels(sos[names.index("decode_attention")], da.TILE_WIDTHS)
    k3 = phase_flash_kernel(torch, fa)
    k45 = phase_flash_backward(torch, fa)
    _check_tensor_core_kernels([sos[names.index(n)] for n in fa.LIBRARIES], fa.LIBRARIES)
    lap("phases 3-5")
    # phase 5b: every kernel at the other head dims, then D = 100 through
    # pretraining and text->image
    wide = phase_head_dims_kernels(torch, da, fa, smi.splitlines()[0])
    with tempfile.TemporaryDirectory() as work:
        wide_launches = phase_head_dims_main_path(torch, da, fa, cli, cfgmod, tasks, sampling,
                                                  pretrain, losses, optim, work)
    lap("phase 5b")
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
        k2_launches = phase_serve_int4(torch, da, serve, cfgmod, tasks, sampling, png, work)
        lap("phase 12")
        # phase 9: text->image with int8 weights; its PNGs feed phases 15
        # (low-level SR) and 16 (super-resolution), which also run before
        # the profiled request; then the bf16-weight request (profiled),
        # whose PNGs feed 10, 11
        t2i = [phase_main_path(torch, da, gpt, cli, cfgmod, tasks, sampling, png, "int8", work,
                               layers=CUT_LAYERS)]
        lap("phase 9, int8 weights")
        llsr_launches = phase_low_level_sr(torch, da, cli, cfgmod, tasks, sampling, png,
                                           t2i[0][1], work)
        lap("phase 15")
        sr_launches = phase_super_resolution(torch, da, cfgmod, cli, gpt, magnify, sampling,
                                             png, t2i[0][1], work, smi.splitlines()[0])
        lap("phase 16")
        t2i.append(phase_main_path(torch, da, gpt, cli, cfgmod, tasks, sampling, png, "bfloat16",
                                   work, layers=MAIN_LAYERS))
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
        phase_image_formats(torch, vqvae, work, smi.splitlines()[0])
        lap("phase 23b")
        phase_damaged_files(torch, vqvae, work, smi.splitlines()[0])
        lap("phase 23c")
        phase_tiff_files(torch, vqvae, work, smi.splitlines()[0])
        lap("phase 23d")
        phase_tiff_codecs(torch, vqvae, work, smi.splitlines()[0])
        lap("phase 23e")
        phase_rare_formats(torch, vqvae, work, smi.splitlines()[0])
        lap("phase 23f")
        phase_vqtrain(torch, work, smi.splitlines()[0])
        lap("phase 24")
        phase_fid(torch, png, work, smi.splitlines()[0])
        lap("phase 25")
        # phase 26: the native host runtimes (phase 23's corpus); phase 27:
        # K3-K5 of a shard; phase 28: two ranks on the one card
        phase_native(torch, work)
        lap("phase 26")
        k345_off = phase_flash_offsets(torch, fa)
        lap("phase 27")
        ran = phase_rank_spawns(torch, work)
        lap("the ranks of phases 28-30")
        two = phase_two_ranks(torch, work, ran)
        lap("phase 28")
        # phase 29: ring attention (SP) and GPipe (PP) on two ranks, then the
        # dry run's six passes on eight
        ring_launches = phase_ring_pipeline(torch, work, ran)
        lap("phase 29")
        # phase 30: vqtrain on a data axis, and the data x pipe dropout step
        dp_launches = phase_data_parallel_slice(torch, work, smi.splitlines()[0], ran)
        lap("phase 30")
        # phase 30b: the same step at one row a microbatch
        dp1_launches = phase_one_row_microbatches(torch, work, smi.splitlines()[0], ran)
        lap("phase 30b")
    # the flash kernels' launches on the training paths: phases 14, 19, 20, 23, 28, 29, 30
    # and 30b
    train_launches = [sum(x) for x in zip(train_launches, ft_launches, full_launches,
                                          pre_launches, two["flash"], ring_launches,
                                          dp_launches, dp1_launches)]

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
                        + two["decode"]["int8"]
                        + ckpt_launches + tut_launches,
                        k1["max_abs_err"], "int8"),
         # device ms of K1 per decode step of the bf16-weight request
         # (torch.profiler over PROFILED_STEPS; MAIN_LAYERS launches a step)
         "step_ms": t2i[1][2]["k1_ms"]},
        decode_entry("decode_attention_int4", k2, k2_launches + two["decode"]["int4"],
                     k2["max_abs_err"], "int4"),
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
         "sr_max_abs_err": k345_sr["max_abs_err"],
         # offsets_*: a shard's rows 8-15 and heads 8-15 at the training shape
         # with its batch and head offsets (phase 27), bf16 with dropout 0.1;
         # offsets_max_abs_err over o, dq, dk, dv, float32 and bf16
         "offsets_ms": k345_off["ms"], "offsets_zero_ms": k345_off["zero_ms"],
         "offsets_max_abs_err": k345_off["max_abs_err"]},
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
                                           ("dkv", 249, train_launches[2])))]
    # phase 5b: each kernel's head dims checked (phases 3-5's and 5b's), its
    # largest error at 5b's (K4 and K5: relative to the largest gradient),
    # its times at D = 100 and 256 (d100, d256:
    # HEAD_DIM_TIMED, bf16; library_ms of K4 and K5 covers dq + dk/dv; d128
    # the exact kernels at D = 100's shapes) and
    # the launches of 5b's main path, which "launches" includes
    for entry, key, earlier in zip(kernels, ("int8", "int4", "fwd", "dq", "dkv"),
                                   ([64], [64], [16, 32, 64, 128], [16, 32, 64, 128],
                                    [16, 32, 64, 128])):
        entry["launches"] += wide_launches[key]
        entry.update(head_dims=sorted(set(earlier + wide["dims"][key])),
                     head_dims_max_abs_err=wide["err"][key],
                     head_dim_launches=wide_launches[key],
                     **{f"d{d}": wide["times"][d][key] for d in HEAD_DIM_TIMED})
    kernels += probe_rows
    left = _live_children()
    _check(not left, f"processes the script started are still running: {left}")
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
    if sys.argv[1:2] == ["--jpeg-memory-child"]:
        sys.exit(jpeg_memory_child(sys.argv[2]))
    sys.exit(main())
