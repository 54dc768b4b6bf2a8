#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each prints its lines; any failure exits non-zero and prints no
result):

1. device: require CUDA, print the card's name and power limit, turn TF32 off;
2. build: compile both kernels from cogview_tpu_torch/csrc/ with nvcc, one
   process per source, in parallel;
3. decode kernel: against its plain PyTorch version at cogview-base head
   shapes (B=4, N=40, D=64, 9 windows), float32 and bfloat16 queries, seal and
   non-seal steps; context within tolerance, seal bytes bit-equal; the
   microseconds per call of both;
4. flash kernel: against its plain PyTorch version at cogview-base head
   shapes (B=4, N=40, D=64) on strided q/k/v views of a fused QKV tensor,
   float32 and bfloat16: S=1058 (post-selection), S=1089 with a prefix that
   crosses tiles, a ragged small S, and dropout 0.1; o and lse within
   tolerance; the microseconds per call of both at S=1058;
5. small input: prefill + decode of a tiny float32 model, and a tiny
   float32 forward through the flash kernel, on the card against the same
   model on the CPU (plain versions);
6. text->image: ``cogview_tpu_torch.cli.generate.main`` at cogview-base width
   (48 layers, random weights from a seed), int8 KV cache, batch 4, one
   request of 30 words, first with bf16 weights, then with int8 weights.
   Checks the generated ids, the four PNGs, and that every decode step of
   every layer launched the decode kernel and never its plain version;
7. image->text: the CLI on the first bf16-weight PNG, batch 4: 20 text ids
   per row, 20 x 48 decode-kernel launches;
8. post-selection: the CLI scores the four PNGs against the prompt: four
   finite negative scores in scores_rank_0.txt, 48 flash-kernel launches;
   the same tokens scored again through dense attention on the card agree.

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


def phase_flash_kernel(torch, fa):
    """Flash kernel vs plain version at cogview-base head shapes -> summary."""
    dev = torch.device("cuda")
    B, N, D = 4, 40, 64
    gen = torch.Generator(device=dev).manual_seed(2)
    worst, times = 0.0, {}
    # (S, sep, dropout rate): post-selection's length, a prefix that crosses
    # the 64-row tiles, a ragged small S, and dropout with a fixed seed
    for S, sep, rate in ((1058, 0, 0.0), (1089, 100, 0.0), (77, 5, 0.0), (333, 40, 0.1)):
        qkv32 = torch.randn((B, S, 3, N * D), generator=gen, device=dev)
        for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
            # strided views of a fused projection, as the model passes them
            qkv = qkv32.to(dtype)
            q, k, v = (qkv[:, :, i].reshape(B, S, N, D) for i in range(3))
            kw = dict(dropout_rate=rate, dropout_seed=1234 if rate else None)
            o, lse = fa.flash_attention(q, k, v, sep, **kw)
            ro, rlse = fa.flash_attention_reference(q, k, v, sep, **kw)
            torch.cuda.synchronize()
            err = (o.float() - ro.float()).abs().max().item()
            lerr = (lse - rlse).abs().max().item()
            name = str(dtype)[6:]
            print(f"flash kernel {name} S={S} sep={sep} dropout={rate}: o max_abs_err="
                  f"{err:.3e} (tol {tol:g}), lse max_abs_err={lerr:.3e} (tol 1e-4)")
            _check(o.dtype == dtype and o.shape == (B, S, N, D) and lse.shape == (B, N, S),
                   "flash o/lse dtype or shape")
            _check(err <= tol and lerr <= 1e-4, f"flash kernel differs at S={S} {name}")
            worst = max(worst, err)
            if S == 1058:
                us_k = _device_time_us(torch, lambda: fa.flash_attention(q, k, v, sep))
                us_p = _device_time_us(torch, lambda: fa.flash_attention_reference(q, k, v, sep))
                times[name] = (us_k, us_p)
                print(f"flash kernel time {name} S=1058: kernel {us_k:.1f} us/call, plain "
                      f"{us_p:.1f} us/call (CUDA events, median of 25)")
    return {"max_abs_err": worst, "times": times}


def phase_small_input(torch, gpt, cfgmod, fa):
    """Tiny float32 models on the card (kernels) against the CPU (plain
    versions) with the same weights: prefill + 28 decode steps, and a full
    forward through the flash kernel."""
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


def phase_main_path(torch, da, cli, tasks, sampling, png, weights: str, work: str):
    """One text2image request through the CLI -> (kernel launches, PNG dir)."""
    import numpy as np

    query = os.path.join(work, "query.txt")
    with open(query, "w") as f:
        f.write(PROMPT + "\n")
    out_dir = os.path.join(work, f"t2i_{weights}")
    captured = {}
    da.decode_attention_quant.launches = 0
    da.decode_attention_quant_reference.calls = 0
    _run_cli(cli, tasks, sampling, torch, _cli_argv(weights, "text2image", query, out_dir),
             captured)
    launches = da.decode_attention_quant.launches
    plain_calls = da.decode_attention_quant_reference.calls

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
    return launches, out_dir


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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        _fail("torch.cuda.is_available() is False: this script needs an NVIDIA GPU")
    try:
        from cogview_tpu_torch import config as cfgmod
        from cogview_tpu_torch.cli import generate as cli
        from cogview_tpu_torch.generation import sampling, scoring, tasks
        from cogview_tpu_torch.models import gpt
        from cogview_tpu_torch.ops import _kernels
        from cogview_tpu_torch.ops import decode_attention as da
        from cogview_tpu_torch.ops import flash_attention as fa
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

    # phase 2: build both libraries, one nvcc each, in parallel
    t0 = time.perf_counter()
    names = ("decode_attention", "flash_attention")
    sos = _kernels.build_all(names)
    for name in names:
        _kernels.lib(name)
    print(f"build: {', '.join(so.name for so in sos)} in {time.perf_counter() - t0:.2f} s")

    # phases 3-5: kernels against their plain versions, small input
    k1 = phase_kernel(torch, da)
    k3 = phase_flash_kernel(torch, fa)
    phase_small_input(torch, gpt, cfgmod, fa)

    with tempfile.TemporaryDirectory() as work:
        # phase 6: text->image, bf16 then int8 weights; the bf16 PNGs feed 7, 8
        t2i = [phase_main_path(torch, da, cli, tasks, sampling, png, w, work)
               for w in ("bfloat16", "int8")]
        png_dir = t2i[0][1]
        # phase 7: image->text; phase 8: post-selection
        i2t = phase_image2text(torch, da, fa, cli, tasks, sampling, png_dir, work)
        flash_launches = phase_post_selection(torch, fa, cli, tasks, scoring, png_dir, work)

    us_k, us_p = k1["times"][("bfloat16", 600)]
    fk, fp = k3["times"]["bfloat16"]
    print(json.dumps({"kernels": [{
        "name": "decode_attention_int8",
        "route": "cuda",
        "source": "cogview_tpu_torch/csrc/decode_attention.cu",
        "replaces": "cogview_tpu/ops/decode_attention.py:161",
        "launches": sum(n for n, _ in t2i) + i2t,
        "max_abs_err": k1["max_abs_err"],
        "ms": us_k / 1000.0,
        "plain_ms": us_p / 1000.0,
    }, {
        "name": "flash_attention_fwd",
        "route": "cuda",
        "source": "cogview_tpu_torch/csrc/flash_attention.cu",
        "replaces": "cogview_tpu/ops/flash_attention.py:163",
        "launches": flash_launches,
        "max_abs_err": k3["max_abs_err"],
        "ms": fk / 1000.0,
        "plain_ms": fp / 1000.0,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
