"""Generation CLI of the port (twin of cogview_tpu/cli/generate.py), text2image.

  python -m cogview_tpu_torch.cli.generate --input-source queries.txt \\
      --output-path samples --batch-size 4 \\
      --text-model-path pretrained/chinese_sentencepiece/cog-pretrain.model

Inputs: 'interactive' or a file with one query per line.  Weights are the
random initial weights of the preset (checkpoint import is a later slice).
Runs on a CUDA device by default and fails if there is none.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch
from cogview_tpu.tokenization import UnifiedTokenizer

from ..config import GPTConfig, cogview_base, smoke, tiny_test
from ..generation.sampling import SamplingParams
from ..generation.tasks import generate_once
from ..models import gpt
from ..ops.precision import set_fp32_precision
from ..tokenization.vq_tokenizer import TorchVQTokenizer
from ..utils.png import write_png

PRESETS = {
    "cogview-base": cogview_base,
    "smoke": smoke,
    "tiny": tiny_test,
}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("cogview-tpu-torch generate")
    g = p.add_argument_group("task")
    g.add_argument("--input-source", default="interactive",
                   help="'interactive' or a query file (one per line)")
    g.add_argument("--output-path", default="./samples")

    m = p.add_argument_group("model")
    m.add_argument("--preset", default="cogview-base", choices=list(PRESETS.keys()))
    m.add_argument("--text-model-path", default=None,
                   help="SentencePiece cog-pretrain.model path")
    m.add_argument("--dtype", default="bfloat16", choices=["bfloat16", "float32"])
    m.add_argument("--weights", default="bfloat16", choices=["bfloat16", "int8"],
                   help="int8 = weight-only per-channel quantization of the "
                        "matmul weights")
    m.add_argument("--kv-cache", default="int8", choices=["int8"],
                   help="decode KV cache; the port has the int8 cache only")
    m.add_argument("--device", default="cuda")

    s = p.add_argument_group("sampling")
    s.add_argument("--batch-size", type=int, default=4,
                   help="samples per query (reference num)")
    s.add_argument("--max-inference-batch-size", type=int, default=12)
    s.add_argument("--temperature", type=float, default=1.0)
    s.add_argument("--top_k", type=int, default=200)
    s.add_argument("--top_p", type=float, default=0.0)
    s.add_argument("--seed", type=int, default=1234)
    return p


def save_image_grid(images, path: str) -> None:
    """[n] list of [1, h, w, 3] float arrays -> horizontal PNG grid.
    Pixels are clipped to [0, 1] and truncated to 8 bits, as the JAX CLI."""
    arrs = [np.asarray(im)[0] for im in images]
    if not all(np.isfinite(a).all() for a in arrs):
        raise ValueError(f"non-finite pixels in an image for {path}")
    arrs = [np.clip(a, 0.0, 1.0) for a in arrs]
    h = max(a.shape[0] for a in arrs)
    canvas = np.zeros((h, sum(a.shape[1] for a in arrs), 3), np.float32)
    x = 0
    for a in arrs:
        canvas[: a.shape[0], x : x + a.shape[1]] = a
        x += a.shape[1]
    write_png(path, (canvas * 255).astype(np.uint8))


def iter_queries(args):
    if args.input_source == "interactive":
        while True:
            try:
                raw = input("\nPlease Input Query (stop to exit) >>> ")
            except EOFError:
                return
            if raw == "stop":
                return
            if raw:
                yield raw.strip()
    else:
        with open(args.input_source) as f:
            for line in f:
                if line.strip():
                    yield line.strip()


def resolve_device(name: str) -> torch.device:
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda but torch.cuda.is_available() is False")
    return device


def load_model(args, device):
    cfg: GPTConfig = PRESETS[args.preset]()
    cfg = cfg.replace(
        compute_dtype=torch.bfloat16 if args.dtype == "bfloat16" else torch.float32,
        kv_cache_dtype=args.kv_cache,
    )
    print("[warn] random-initialized model (checkpoint import is not ported yet)",
          file=sys.stderr)
    gen = torch.Generator(device=device).manual_seed(0)
    params = gpt.init_params(cfg, gen, dtype=cfg.compute_dtype, device=device)
    if args.weights == "int8":
        params = gpt.quantize_weights(params)
    return params, cfg


def build_tokenizer(args, device, txt_tokenizer=None):
    print("[warn] random VQ-VAE (checkpoint import is not ported yet)", file=sys.stderr)
    img_tok = TorchVQTokenizer.random_init(device=device)
    return UnifiedTokenizer(img_tokenizer=img_tok, txt_tokenizer=txt_tokenizer,
                            text_model_path=args.text_model_path)


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

    out_dir = args.output_path
    os.makedirs(out_dir, exist_ok=True)
    for raw in iter_queries(args):
        t0 = time.time()
        res = generate_once(params, cfg, tokenizer, raw, "text2image",
                            num=args.batch_size,
                            max_inference_batch_size=args.max_inference_batch_size,
                            sampling=sampling, device=device)
        for i, img in enumerate(res.images):
            save_image_grid([img], os.path.join(out_dir, f"{i}.png"))
        if res.images:
            save_image_grid(res.images, os.path.join(out_dir, "concat.png"))
        print(f"saved {len(res.images)} images -> {out_dir}")
        print(f"Taken time {time.time() - t0:.2f}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
