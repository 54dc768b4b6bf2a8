#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each prints its lines; any failure exits non-zero and prints no
result):

1. device: require CUDA, print the card's name and power limit, turn TF32 off;
2. build: compile the decode-attention kernel from csrc/ with nvcc;
3. kernel: the kernel against its plain PyTorch version at cogview-base head
   shapes (B=4, N=40, D=64, 9 windows), float32 and bfloat16 queries, seal and
   non-seal steps; context within tolerance, seal bytes bit-equal; the
   microseconds per call of both;
4. small input: prefill + decode of a tiny float32 model on the card (kernel)
   against the same model on the CPU (plain version);
5. main path: ``cogview_tpu_torch.cli.generate.main`` at cogview-base width
   (48 layers, random weights from a seed), int8 KV cache, batch 4, one
   text2image request of 30 words, first with bf16 weights, then with int8
   weights.  Checks the generated ids, the four PNGs, and that every decode
   step of every layer launched the kernel and never the plain version.

The next-to-last line is the kernels' JSON record, the last line
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
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


def phase_kernel(torch, da):
    """Kernel vs plain version at cogview-base head shapes -> summary dict."""
    dev = torch.device("cuda")
    B, N, D, W, G, L, li = 4, 40, 64, da.WRITE_WINDOW, da.SEAL_GROUP, 2, 1
    NW = da.pad_cache_len(1088) // W
    gen = torch.Generator(device=dev).manual_seed(0)
    kv = torch.randint(-127, 128, (L, NW, B, 2, N, D, W), generator=gen, device=dev,
                       dtype=torch.int8)
    sc = torch.rand((L, NW, B, 2, N, W), generator=gen, device=dev) * 0.02
    ring = torch.randn((L, G, B, N, 2 * D), generator=gen, device=dev)
    q32 = torch.randn((B, N, D), generator=gen, device=dev)
    worst = 0.0
    for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
        q = q32.to(dtype)
        for idx in (10, 133, 600, 15, 135, 1031):
            kv_k, sc_k, kv_r, sc_r = kv.clone(), sc.clone(), kv.clone(), sc.clone()
            ctx_k = da.decode_attention_quant(q, ring[li], kv_k[li], sc_k[li], idx)
            ctx_r = da.decode_attention_quant_reference(q, ring[li], kv_r[li], sc_r[li], idx)
            torch.cuda.synchronize()
            err = (ctx_k.float() - ctx_r.float()).abs().max().item()
            seal = idx % G == G - 1
            same = torch.equal(kv_k, kv_r) and torch.equal(sc_k, sc_r)
            changed = not torch.equal(kv_k, kv)
            print(f"kernel {str(dtype)[6:]} index={idx} seal={seal}: ctx max_abs_err={err:.3e} "
                  f"(tol {tol:g}) cache bit-equal={same} cache written={changed}")
            _check(ctx_k.dtype == dtype and ctx_k.shape == (B, N, D), "ctx dtype/shape")
            _check(err <= tol, f"ctx error {err} > {tol} at index {idx}")
            _check(same, f"cache differs from the plain version at index {idx}: "
                   f"{(kv_k != kv_r).sum().item()} bytes, {(sc_k != sc_r).sum().item()} scales")
            _check(changed == seal, f"cache written={changed} on seal={seal} at index {idx}")
            worst = max(worst, err)

    times = {}
    for dtype in (torch.float32, torch.bfloat16):
        q = q32.to(dtype)
        for idx in (600, 1031):
            kv_t, sc_t = kv.clone(), sc.clone()
            args = (q, ring[li], kv_t[li], sc_t[li], idx)
            us_k = _device_time_us(torch, lambda: da.decode_attention_quant(*args))
            us_p = _device_time_us(torch, lambda: da.decode_attention_quant_reference(*args))
            times[(str(dtype)[6:], idx)] = (us_k, us_p)
            print(f"kernel time {str(dtype)[6:]} index={idx}: kernel {us_k:.1f} us/call, "
                  f"plain {us_p:.1f} us/call (CUDA events, median of 25)")
    return {"max_abs_err": worst, "times": times}


def phase_small_input(torch, gpt, cfgmod):
    """Tiny float32 model: prefill + 28 decode steps on the card (kernel)
    against the CPU (plain version) with the same weights."""
    cfg = cfgmod.tiny_test()
    gen = torch.Generator().manual_seed(1)
    params_cpu = gpt.init_params(cfg, gen)

    def to_dev(t):
        return {k: to_dev(v) for k, v in t.items()} if isinstance(t, dict) else t.cuda()

    params_gpu = to_dev(params_cpu)
    B, S, ctx = 2, 40, 12
    tokens = torch.randint(0, cfg.vocab_size, (B, S), generator=gen)
    pos = torch.arange(S).expand(B, S)
    outs = {}
    for name, params, dev in (("cpu", params_cpu, "cpu"), ("cuda", params_gpu, "cuda")):
        cache = gpt.init_cache(cfg, B, S, device=dev)
        tk, ps = tokens.to(dev), pos.to(dev)
        got = [gpt.forward_with_cache(params, cfg, tk[:, :ctx], ps[:, :ctx], cache, 0)]
        for t in range(ctx, S):
            got.append(gpt.forward_with_cache(params, cfg, tk[:, t:t + 1], ps[:, t:t + 1],
                                              cache, t))
        outs[name] = torch.cat(got, dim=1).cpu()
    err = (outs["cpu"] - outs["cuda"]).abs().max().item()
    print(f"small input (tiny_test f32, prefill 12 + 28 decode steps): logits max_abs_err "
          f"card vs CPU = {err:.3e} (tol 1e-3)")
    _check(err <= 1e-3, f"card logits differ from the CPU's by {err}")


def phase_main_path(torch, da, cli, tasks, png, weights: str):
    """One text2image request through the CLI -> kernel launches."""
    import numpy as np

    captured = {}
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
        captured["steps"] = template.length - template.context_length
        captured["ctx"] = template.context_length
        return out

    with tempfile.TemporaryDirectory() as tmp:
        query = os.path.join(tmp, "query.txt")
        with open(query, "w") as f:
            f.write(" ".join(f"word{i}" for i in range(30)) + "\n")
        out_dir = os.path.join(tmp, "out")
        argv = ["--preset", "cogview-base", "--dtype", "bfloat16", "--weights", weights,
                "--kv-cache", "int8", "--batch-size", "4", "--top_k", "200",
                "--seed", "1234", "--device", "cuda", "--input-source", query,
                "--output-path", out_dir]
        cli.generate_once, tasks.filling_sequence = timed_generate_once, timed_fill
        try:
            da.decode_attention_quant.launches = 0
            da.decode_attention_quant_reference.calls = 0
            rc = cli.main(argv, txt_tokenizer=WordTokenizer())
            launches = da.decode_attention_quant.launches
            plain_calls = da.decode_attention_quant_reference.calls
        finally:
            cli.generate_once, tasks.filling_sequence = orig_gen, orig_fill
        _check(rc == 0, f"cli.main returned {rc}")

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
        print(f"main path weights={weights}: kernel launches {launches} == (S - ctx) x 48 = "
              f"{steps} x 48 = {want}: {launches == want}; plain-version calls {plain_calls}")
        _check(launches == want and plain_calls == 0, "the main path did not run the kernel")
        print(f"main path weights={weights}: {captured['request_s']:.3f} s per request "
              f"(batch 4); filling {captured['fill_s']:.3f} s = "
              f"{1000.0 * captured['fill_s'] / steps:.3f} ms per decode step "
              f"(prefill included, {steps} steps)")
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        _fail("torch.cuda.is_available() is False: this script needs an NVIDIA GPU")
    try:
        from cogview_tpu_torch import config as cfgmod
        from cogview_tpu_torch.cli import generate as cli
        from cogview_tpu_torch.generation import tasks
        from cogview_tpu_torch.models import gpt
        from cogview_tpu_torch.ops import _kernels
        from cogview_tpu_torch.ops import decode_attention as da
        from cogview_tpu_torch.ops.precision import set_fp32_precision
        from cogview_tpu_torch.utils import png
    except ImportError as e:
        _fail(f"the port is not importable here ({e}); run from the repository root")

    # phase 1: device
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip()
    print(smi.splitlines()[0])
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    set_fp32_precision()

    # phase 2: build
    t0 = time.perf_counter()
    so = _kernels.build("decode_attention")
    _kernels.lib()
    print(f"build: {so.name} in {time.perf_counter() - t0:.2f} s")

    # phase 3: kernel against its plain version
    k1 = phase_kernel(torch, da)
    # phase 4: small input against the CPU
    phase_small_input(torch, gpt, cfgmod)
    # phase 5: the main path, bf16 then int8 weights
    launches = sum(phase_main_path(torch, da, cli, tasks, png, w)
                   for w in ("bfloat16", "int8"))

    us_k, us_p = k1["times"][("bfloat16", 600)]
    print(json.dumps({"kernels": [{
        "name": "decode_attention_int8",
        "route": "cuda",
        "source": "cogview_tpu_torch/csrc/decode_attention.cu",
        "replaces": "cogview_tpu/ops/decode_attention.py:161",
        "launches": launches,
        "max_abs_err": k1["max_abs_err"],
        "ms": us_k / 1000.0,
        "plain_ms": us_p / 1000.0,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
