"""Generation CLI of the port (twin of cogview_tpu/cli/generate.py).

  python -m cogview_tpu_torch.cli.generate --input-source queries.txt \\
      --output-path samples --batch-size 4 \\
      --load ckpts/cogview-base/mp_rank_00_model_states.pt \\
      --img-tokenizer-path ckpts/vqvae_hard_biggerset_011.pt \\
      --text-model-path pretrained/chinese_sentencepiece/cog-pretrain.model

  python -m cogview_tpu_torch.cli.generate --generation-task post-selection \\
      --input-source candidates.txt --output-path scores

  python -m cogview_tpu_torch.cli.generate --generation-task super-resolution \\
      --preset cogview-sr --load ckpts/cogview-base/mp_rank_00_model_states.pt \\
      --input-source sr.txt --output-path sr

  python -m cogview_tpu_torch.cli.generate --preset tutorial --load ckpt_dir \\
      --input-source queries.txt --output-path samples

Tasks: text2image and low-level super-resolution (PNGs, one per sample,
and ``concat.png``), image2text (prints the text parts), super-resolution
(``sr-<query index>.png``, 512 x 512 pixels), raw (the line is the
template-language query: PNGs where it generates an image, else the
printed text parts) and post-selection (appends the query and its
tab-joined scores to ``<output-path>/scores_rank_0.txt``).  Inputs:
'interactive' or a file with one query per line; tab-separated fields fill
the task's template slots (image2text: an image path; low-level
super-resolution and super-resolution: the text, then an image path;
post-selection: the text, then one image path per candidate).  With
``--with-id`` each file line is the output id, a tab, then the query, and
its outputs go to ``<output-path>/<id>/``.  Images are PNGs (every colour
type, depth and interlace) or baseline or progressive JPEGs, resized as the
JAX package does (short side to 256 pixels, 128 for low-level
super-resolution, Pillow's bilinear filter, centre crop).

Weights: ``--load`` takes the reference's GPT checkpoint file (DeepSpeed's
``mp_rank_00_model_states.pt`` or a plain state dict; a trusted file, see
models/convert.py) or a directory of the port's own pretraining
checkpoints (``cli/pretrain.py --save``); the position table is then
fitted to the preset (a 1,089-position file serves ``--preset
cogview-sr``).  ``--img-tokenizer-path`` takes the reference's VQ-VAE
``.pt`` file.  Without them the weights are the preset's random initial
weights, with a warning.  Runs on a CUDA device by default and fails if
there is none.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch

from ..config import GPTConfig, cogview_base, cogview_sr, cogview_tutorial, smoke, tiny_test
from ..generation.sampling import SamplingParams
from ..generation.tasks import generate_once, post_selection, super_resolution
from ..models import convert, gpt
from ..ops.precision import set_fp32_precision
from ..training import checkpointing
from ..training.optim import tree_map
from ..tokenization.unified import UnifiedTokenizer
from ..tokenization.vq_tokenizer import TorchVQTokenizer
from ..utils.png import write_png

TASKS = ("text2image", "image2text", "super-resolution", "low-level super-resolution",
         "post-selection", "raw")

PRESETS = {
    "cogview-base": cogview_base,
    "cogview-sr": cogview_sr,
    "tutorial": cogview_tutorial,
    "smoke": smoke,
    "tiny": tiny_test,
}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("cogview-tpu-torch generate")
    g = p.add_argument_group("task")
    g.add_argument("--generation-task", default="text2image", choices=TASKS)
    g.add_argument("--input-source", default="interactive",
                   help="'interactive' or a query file (one per line)")
    g.add_argument("--output-path", default="./samples")
    g.add_argument("--with-id", action="store_true",
                   help="file lines are '<id>\\t<query>'; outputs go to <output-path>/<id>/")

    m = p.add_argument_group("model")
    m.add_argument("--preset", default="cogview-base", choices=list(PRESETS.keys()))
    m.add_argument("--load", default=None,
                   help="GPT checkpoint: the reference's mp_rank_00_model_states.pt (or a "
                        "plain state dict), or a directory of this package's pretraining "
                        "checkpoints; omitted = random init")
    m.add_argument("--img-tokenizer-path", default=None,
                   help="the reference's VQ-VAE .pt checkpoint; omitted = random init")
    m.add_argument("--text-model-path", default=None,
                   help="SentencePiece cog-pretrain.model path")
    m.add_argument("--dtype", default="bfloat16", choices=["bfloat16", "float32"])
    m.add_argument("--weights", default="bfloat16", choices=["bfloat16", "int8"],
                   help="int8 = weight-only per-channel quantization of the "
                        "matmul weights")
    m.add_argument("--kv-cache", default="int8", choices=["int8", "int4", "bfloat16"],
                   help="decode KV cache: int8 (the K1 decode kernel), int4 (two "
                        "values a byte, the K2 decode kernel; a quantization step "
                        "of absmax/7, 127/7 = 18x int8's) or bfloat16 (exact, "
                        "dense attention)")
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
    """-> (query, output directory) pairs."""
    if args.input_source == "interactive":
        while True:
            try:
                raw = input("\nPlease Input Query (stop to exit) >>> ")
            except EOFError:
                return
            if raw == "stop":
                return
            if raw:
                yield raw.strip(), args.output_path
    else:
        with open(args.input_source) as f:
            for line in f:
                raw = line.strip()
                if not raw:
                    continue
                out = args.output_path
                if args.with_id:
                    parts = raw.split("\t")
                    out = os.path.join(args.output_path, parts[0])
                    raw = "\t".join(parts[1:])
                yield raw, out


def resolve_device(name: str) -> torch.device:
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda but torch.cuda.is_available() is False")
    return device


def load_params(path: str, cfg: GPTConfig, device) -> dict:
    """GPT params from ``--load``: a directory with the pretraining tracker
    file is this package's own checkpoint (its ``params``; the mmap'd load
    leaves the optimizer state on disk); a file is the reference's
    checkpoint (models/convert.py)."""
    if os.path.isdir(path):
        state = checkpointing.load_latest(path, map_location="cpu")
        if state is None:
            raise SystemExit(f"--load {path}: a directory without {checkpointing.TRACKER}")
        return tree_map(lambda t: t.to(device), state["params"])
    return convert.load_gpt_checkpoint(path, cfg.num_layers, cfg.num_heads, device=device)


def load_model(args, device):
    cfg: GPTConfig = PRESETS[args.preset]()
    cfg = cfg.replace(
        compute_dtype=torch.bfloat16 if args.dtype == "bfloat16" else torch.float32,
        kv_cache_dtype=args.kv_cache,
    )
    if args.load:
        params = load_params(args.load, cfg, device)
        # a 1089-position base checkpoint serves the 1345-position SR preset
        # by tiling its table (reference utils.py:283-287)
        params = gpt.adapt_position_embeddings(params, cfg)
    else:
        print("[warn] no --load: random-initialized model", file=sys.stderr)
        gen = torch.Generator(device=device).manual_seed(0)
        params = gpt.init_params(cfg, gen, dtype=cfg.compute_dtype, device=device)
    # float32 leaves in the compute dtype; float16 and bfloat16 leaves keep
    # their stored dtype (each use casts a weight to the compute dtype)
    params = tree_map(lambda t: t.to(cfg.compute_dtype) if t.dtype == torch.float32 else t,
                       params)
    if args.weights == "int8":
        params = gpt.quantize_weights(params)
    return params, cfg


def build_tokenizer(args, device, txt_tokenizer=None):
    if args.img_tokenizer_path:
        img_tok = TorchVQTokenizer.from_checkpoint(args.img_tokenizer_path, device=device)
    else:
        print("[warn] no --img-tokenizer-path: random VQ-VAE", file=sys.stderr)
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

    task = args.generation_task
    for qi, (raw, out_dir) in enumerate(iter_queries(args)):
        os.makedirs(out_dir, exist_ok=True)
        t0 = time.time()
        if task == "post-selection":
            scores = post_selection(params, cfg, tokenizer, raw,
                                    args.max_inference_batch_size, device=device)
            out_file = os.path.join(out_dir, "scores_rank_0.txt")
            with open(out_file, "a") as f:
                f.write(raw + "\n")
                f.write("\t".join(str(x) for x in scores.tolist()) + "\n")
            print(f"scores -> {out_file}")
        elif task == "super-resolution":
            res = super_resolution(params, cfg, tokenizer, raw, sampling, device=device)
            out_file = os.path.join(out_dir, f"sr-{qi}.png")
            save_image_grid(res.images, out_file)
            print(f"saved {out_file}")
        else:
            res = generate_once(params, cfg, tokenizer, raw, task,
                                num=args.batch_size,
                                max_inference_batch_size=args.max_inference_batch_size,
                                sampling=sampling, device=device)
            if task == "image2text" or (task == "raw" and not res.images):
                for parts in res.texts:
                    print([p for p in parts if isinstance(p, str)])
            else:
                for i, img in enumerate(res.images):
                    save_image_grid([img], os.path.join(out_dir, f"{i}.png"))
                if res.images:
                    save_image_grid(res.images, os.path.join(out_dir, "concat.png"))
                print(f"saved {len(res.images)} images -> {out_dir}")
        print(f"Taken time {time.time() - t0:.2f}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
