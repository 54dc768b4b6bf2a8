"""Folder-watcher generation service of the port (twin of
cogview_tpu/cli/serve.py).

Watches an input folder for ``*.txt`` query files (one query per line, the
format of ``cli.generate``'s --input-source files), generates, writes the
PNGs (or captions.txt for image2text) to ``<img-folder-path>/<stem>-<line>/``
and moves each processed file to ``done/``, or to ``failed/`` with the
exception in a sibling ``.err`` file.

  python -m cogview_tpu_torch.cli.serve --preset cogview-base --kv-cache int4 \\
      --input-folder-path input/ --img-folder-path image/ \\
      --text-model-path pretrained/chinese_sentencepiece/cog-pretrain.model

Before serving, one warmup generation (``--no-warmup`` skips it) builds the
CUDA kernels and initialises cuBLAS, so the first query does not pay for
them.  Weights are the preset's random initial weights (checkpoint import is
a later slice, so there is no --load).  The JAX server's --aot-dir and its
persistent compile cache are JAX executable stores and have no counterpart.
Runs on a CUDA device by default and fails if there is none.
"""

from __future__ import annotations

import argparse
import os
import shutil
import time

from ..generation.sampling import SamplingParams
from ..generation.tasks import generate_once
from ..ops.precision import set_fp32_precision
from .generate import PRESETS, build_tokenizer, load_model, resolve_device, save_image_grid


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("cogview-tpu-torch serve")
    p.add_argument("--input-folder-path", default="input/")
    p.add_argument("--img-folder-path", default="image/")
    p.add_argument("--time-interval", type=float, default=10.0,
                   help="poll period in seconds")
    p.add_argument("--generation-task", default="text2image",
                   choices=["text2image", "image2text"])
    p.add_argument("--preset", default="cogview-base", choices=list(PRESETS.keys()))
    p.add_argument("--text-model-path", default=None)
    p.add_argument("--dtype", default="bfloat16", choices=["bfloat16", "float32"])
    p.add_argument("--weights", default="bfloat16", choices=["bfloat16", "int8"],
                   help="int8 weight-only quantization (see generate --weights)")
    p.add_argument("--kv-cache", default="int8", choices=["int8", "int4", "bfloat16"],
                   help="decode KV cache (see generate --kv-cache)")
    p.add_argument("--device", default="cuda")
    p.add_argument("--batch-size", type=int, default=4)
    p.add_argument("--max-inference-batch-size", type=int, default=8)
    p.add_argument("--temperature", type=float, default=1.0)
    p.add_argument("--top_k", type=int, default=200)
    p.add_argument("--top_p", type=float, default=0.0)
    p.add_argument("--seed", type=int, default=1234)
    p.add_argument("--max-polls", type=int, default=0,
                   help="stop after N polls (0 = forever); for testing")
    p.add_argument("--no-warmup", dest="warmup", action="store_false", default=True,
                   help="skip the warmup generation before serving (default: one "
                        "text2image generation builds the kernels first)")
    return p


def process_file(path: str, args, params, cfg, tokenizer, sampling, device=None) -> int:
    n = 0
    stem = os.path.splitext(os.path.basename(path))[0]
    with open(path, encoding="utf-8") as f:
        for qi, line in enumerate(f):
            raw = line.strip()
            if not raw:
                continue
            res = generate_once(
                params, cfg, tokenizer, raw, args.generation_task,
                num=args.batch_size,
                max_inference_batch_size=args.max_inference_batch_size,
                sampling=sampling,
                device=device,
            )
            out_dir = os.path.join(args.img_folder_path, f"{stem}-{qi}")
            os.makedirs(out_dir, exist_ok=True)
            if args.generation_task == "image2text":
                with open(os.path.join(out_dir, "captions.txt"), "w") as out:
                    for parts in res.texts:
                        out.write(" ".join(p for p in parts if isinstance(p, str)) + "\n")
            else:
                for i, img in enumerate(res.images):
                    save_image_grid([img], os.path.join(out_dir, f"{i}.png"))
            n += 1
    return n


def watch_folder(input_folder: str, process, time_interval: float = 10.0,
                 max_polls: int = 0) -> int:
    """Poll ``input_folder`` for *.txt query files; run ``process(path)`` on
    each.  Successes move to done/, failures to failed/ (with the exception
    text in a sibling .err file) so done/ only ever holds successfully
    processed inputs and failed queries are never silently dropped."""
    done_dir = os.path.join(input_folder, "done")
    failed_dir = os.path.join(input_folder, "failed")
    os.makedirs(done_dir, exist_ok=True)
    os.makedirs(failed_dir, exist_ok=True)

    polls = 0
    while True:
        entries = sorted(
            e for e in os.listdir(input_folder)
            if e.endswith(".txt") and os.path.isfile(os.path.join(input_folder, e))
        )
        for e in entries:
            src = os.path.join(input_folder, e)
            t0 = time.time()
            try:
                n = process(src)
                print(f"processed {e}: {n} queries in {time.time()-t0:.1f}s", flush=True)
                shutil.move(src, os.path.join(done_dir, e))
            except Exception as exc:  # keep serving on bad inputs
                print(f"[error] {e}: {exc}", flush=True)
                shutil.move(src, os.path.join(failed_dir, e))
                with open(os.path.join(failed_dir, e + ".err"), "w") as err:
                    err.write(f"{type(exc).__name__}: {exc}\n")
        polls += 1
        if max_polls and polls >= max_polls:
            return 0
        time.sleep(time_interval)


def main(argv=None, txt_tokenizer=None) -> int:
    """``txt_tokenizer`` replaces the SentencePiece text tokenizer (any
    object with ``num_tokens``, ``encode`` and ``decode``)."""
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    set_fp32_precision()
    params, cfg = load_model(args, device)
    tokenizer = build_tokenizer(args, device, txt_tokenizer)
    sampling = SamplingParams(temperature=args.temperature, top_k=args.top_k,
                              top_p=args.top_p, seed=args.seed)
    os.makedirs(args.input_folder_path, exist_ok=True)
    os.makedirs(args.img_folder_path, exist_ok=True)

    if args.warmup and args.generation_task == "text2image":
        # one generation before the first poll: it builds the CUDA kernels
        # and initialises cuBLAS.  A failure here stops the server, since
        # every query would fail the same way.
        t0 = time.time()
        generate_once(params, cfg, tokenizer, "warmup 预热", "text2image",
                      num=min(args.batch_size, args.max_inference_batch_size),
                      max_inference_batch_size=args.max_inference_batch_size,
                      sampling=sampling, device=device)
        print(f"warmup: generation ready in {time.time()-t0:.1f}s", flush=True)

    print(f"serving: watching {args.input_folder_path} every "
          f"{args.time_interval}s -> {args.img_folder_path}", flush=True)
    return watch_folder(
        args.input_folder_path,
        lambda src: process_file(src, args, params, cfg, tokenizer, sampling, device),
        time_interval=args.time_interval,
        max_polls=args.max_polls,
    )


if __name__ == "__main__":
    raise SystemExit(main())
