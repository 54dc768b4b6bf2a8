"""Pretraining CLI of the port (twin of cogview_tpu/cli/pretrain.py), on one
device.

  python -m cogview_tpu_torch.cli.pretrain --preset tutorial --device cuda \\
      --train-data data/corpus.bin --batch-size 16 --train-iters 1000 \\
      --save ckpts/run1 \\
      --text-model-path pretrained/chinese_sentencepiece/cog-pretrain.model

Super-resolution finetuning from a cogview-base checkpoint (the position
table extended from 1,089 to 1,345 rows, positions restarting at [ROI2]):

  python -m cogview_tpu_torch.cli.pretrain --preset cogview-sr \
      --load ckpts/base --finetune --dual-positions \
      --dataset-type TokenizedDataset --train-data data/sr ...

Iterates global batches from ``cogview_tpu_torch.data`` (the port's copy
of the JAX package's numpy-only loader), runs the NaN-skipping train step with
activation recomputation, evaluates (loss and PPL), writes checkpoints with
the tracker-file protocol, and prints the JAX CLI's per-interval line.  It
takes every flag of the JAX CLI but the multi-device ones
(``--model-parallel-size``, ``--fsdp``, ``--sequence-parallel-size``,
``--pipeline-parallel-size``, ``--pipeline-microbatches``, ``--multihost``).
Runs on a CUDA device by default and fails if there is none.  On CUDA it
sets ``PYTORCH_CUDA_ALLOC_CONF=expandable_segments:True`` before the first
allocation unless the environment holds an allocator setting: without it
cogview-sr at 48 layers can fail for want of one free 4.69 GiB block.
"""

from __future__ import annotations

import argparse
import math
import os
import sys
import time

import numpy as np
import torch

from .. import config as C
from ..data.loader import DataConfig, detect_new_datasets, make_loaders
from ..models import gpt
from ..ops.precision import set_fp32_precision
from ..tokenization.unified import FakeImageTokenizer, UnifiedTokenizer
from ..training import checkpointing
from ..training.loss_scaler import LossScaleState
from ..training.losses import lm_loss
from ..training.optim import make_optimizer, tree_map
from ..training.train_loop import (init_fp16_train_state, init_train_state,
                                   make_fp16_train_step, make_train_step)
from ..utils.metrics import MetricsWriter
from ..utils.timers import Timers

PRESETS = {"cogview-base": C.cogview_base, "cogview-sr": C.cogview_sr,
           "tutorial": C.cogview_tutorial, "smoke": C.smoke, "tiny": C.tiny_test}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("cogview-tpu-torch pretrain")
    m = p.add_argument_group("model")
    m.add_argument("--preset", default="tutorial", choices=list(PRESETS))
    m.add_argument("--num-layers", type=int, default=None)
    m.add_argument("--hidden-size", type=int, default=None)
    m.add_argument("--num-attention-heads", type=int, default=None)
    m.add_argument("--max-position-embeddings", type=int, default=None)
    m.add_argument("--checkpoint-activations", action="store_true", default=True,
                   help="recompute each layer in the backward (always on)")
    m.add_argument("--finetune", action="store_true",
                   help="with --load, take only the params (the position table fitted "
                        "to the preset) and start the iteration, optimizer, generator "
                        "and loss scale afresh")
    m.add_argument("--device", default="cuda")

    t = p.add_argument_group("train")
    t.add_argument("--batch-size", type=int, default=4, help="global batch")
    t.add_argument("--train-iters", type=int, default=1000)
    t.add_argument("--lr", type=float, default=4e-4)
    t.add_argument("--lr-decay-style", default="cosine",
                   choices=["constant", "linear", "cosine", "exponential"])
    t.add_argument("--lr-decay-ratio", type=float, default=0.5)
    t.add_argument("--warmup", type=float, default=0.01,
                   help="fraction of train-iters for linear warmup")
    t.add_argument("--weight-decay", type=float, default=1e-2)
    t.add_argument("--clip-grad", type=float, default=1.0)
    t.add_argument("--txt-loss-scale", type=float, default=1.0)
    t.add_argument("--seed", type=int, default=1234)
    t.add_argument("--is-sparse", type=int, default=0, choices=[0, 1],
                   help="1 = pivot + window sparse attention for training")
    # the reference's shipped scripts pass 64/4/256, which divide the 1,088
    # training tokens of the production presets (the 128 default does not)
    t.add_argument("--query-window", type=int, default=0,
                   help="sparse attention's local window (0 = the config's 128; the "
                        "training tokens must be a multiple)")
    t.add_argument("--key-window-times", type=int, default=0,
                   help="sparse attention's window multiplier (0 = the config's 6)")
    t.add_argument("--num-pivot", type=int, default=0,
                   help="sparse attention's pivot count (0 = the config's 768)")
    t.add_argument("--max-memory-length", type=int, default=0,
                   help="transformer-XL memory of layer hidden states carried across "
                        "training batches: each batch continues the last as a segment; "
                        "no gradient flows through the memory")
    t.add_argument("--dual-positions", action="store_true",
                   help="dual-segment position ids restarting at [ROI2] "
                        "(super-resolution finetuning)")
    t.add_argument("--fp16", action="store_true",
                   help="float16 compute with dynamic loss scaling (the default "
                        "is bfloat16, which needs no scaling)")
    t.add_argument("--loss-scale-init", type=float, default=2.0 ** 32)
    t.add_argument("--loss-scale-window", type=int, default=1000)
    t.add_argument("--min-loss-scale", type=float, default=1.0)
    t.add_argument("--loss-scale-hysteresis", type=int, default=2)

    d = p.add_argument_group("data")
    d.add_argument("--train-data", nargs="+", default=None)
    d.add_argument("--dataset-type", default="CompactBinaryDataset",
                   choices=["TokenizedDataset", "TextCodeDataset", "CompactBinaryDataset"])
    d.add_argument("--split", default="0.95,0.04,0.01")
    d.add_argument("--resume-dataloader", action="store_true")
    d.add_argument("--img-tokenizer-num-tokens", type=int, default=8192)
    d.add_argument("--text-model-path", default=None)

    io = p.add_argument_group("io")
    io.add_argument("--save", default=None)
    io.add_argument("--load", default=None)
    io.add_argument("--save-interval", type=int, default=5000)
    io.add_argument("--eval-interval", type=int, default=1000)
    io.add_argument("--eval-iters", type=int, default=10)
    io.add_argument("--log-interval", type=int, default=100)
    io.add_argument("--summary-dir", default=None)
    io.add_argument("--experiment-name", default="cogview-tpu")
    io.add_argument("--exit-interval", type=int, default=None)
    io.add_argument("--profile-dir", default=None,
                    help="trace steps 10-13 with torch.profiler and write a Chrome "
                         "trace, trace.json, here")
    return p


def get_config(args) -> C.GPTConfig:
    cfg = PRESETS[args.preset]()
    over = {}
    if args.num_layers:
        over["num_layers"] = args.num_layers
    if args.hidden_size:
        over["hidden_size"] = args.hidden_size
    if args.num_attention_heads:
        over["num_heads"] = args.num_attention_heads
    if args.max_position_embeddings:
        over["max_position_embeddings"] = args.max_position_embeddings
    for name in ("query_window", "key_window_times", "num_pivot"):
        if getattr(args, name):
            over[name] = getattr(args, name)
    return cfg.replace(**over) if over else cfg


def build_tokenizer(args, txt_tokenizer=None) -> UnifiedTokenizer:
    """Pretraining needs only the vocabulary layout: a size-only image
    tokenizer, and the text tokenizer (``txt_tokenizer``, else SentencePiece
    from ``--text-model-path``)."""
    return UnifiedTokenizer(img_tokenizer=FakeImageTokenizer(args.img_tokenizer_num_tokens),
                            txt_tokenizer=txt_tokenizer, text_model_path=args.text_model_path)


def evaluate(loss_fn, val_batches, eval_iters: int):
    """Mean loss and PPL over up to ``eval_iters`` batches of the one
    long-lived ``val_batches`` iterator."""
    losses = []
    for _ in range(eval_iters):
        try:
            batch = next(val_batches)
        except StopIteration:
            break
        losses.append(float(loss_fn(batch)))
    if not losses:
        return None
    loss = float(np.mean(losses))
    return {"val_loss": loss, "val_ppl": math.exp(min(20.0, loss))}


def _checkpoint_state(state, iteration: int, loader_consumed: int, fp16: bool):
    opt = state["opt_state"]
    out = {
        "params": tree_map(torch.Tensor.detach, state["params"]),
        "opt_state": {"count": opt["count"], "mu": opt["mu"], "nu": opt["nu"]},
        "iteration": iteration,
        "generator": state["generator"].get_state(),
        "loader_consumed": loader_consumed,
    }
    if fp16:
        out["loss_scale"] = state["loss_scale"]._asdict()
    return out


@torch.no_grad()
def _restore(state, loaded, cfg, finetune: bool, fp16: bool) -> None:
    """Copy a loaded checkpoint into ``state`` in place: the params, their
    position table fitted to ``cfg`` (``gpt.adapt_position_embeddings``),
    and without ``finetune`` the optimizer state, the generator and the loss
    scale."""
    copy = lambda dst, src: dst.copy_(src)
    tree_map(copy, state["params"], gpt.adapt_position_embeddings(loaded["params"], cfg))
    if finetune:
        return
    tree_map(copy, state["opt_state"]["mu"], loaded["opt_state"]["mu"])
    tree_map(copy, state["opt_state"]["nu"], loaded["opt_state"]["nu"])
    state["opt_state"]["count"] = int(loaded["opt_state"]["count"])
    state["generator"].set_state(loaded["generator"].cpu())  # a CPU generator
    if fp16 and "loss_scale" in loaded:
        state["loss_scale"] = LossScaleState(**loaded["loss_scale"])


def expandable_segments(device: torch.device) -> None:
    """Lets the CUDA caching allocator grow its segments in place
    (``PYTORCH_CUDA_ALLOC_CONF=expandable_segments:True``) unless the caller
    set an allocator configuration.  At cogview-sr's 48 layers the step's
    peak is 63 GiB and a stacked gradient leaf takes 4.69 GiB in one block,
    which fixed-size segments cached at that point cannot always give.  The
    allocator reads the setting at the process's first CUDA use, so it
    changes nothing in a process that has used CUDA already."""
    if (device.type == "cuda" and not torch.cuda.is_initialized()
            and "PYTORCH_CUDA_ALLOC_CONF" not in os.environ
            and "PYTORCH_ALLOC_CONF" not in os.environ):
        os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"


def _start_profile(device: torch.device):
    activities = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    prof.__enter__()
    return prof


def _stop_profile(prof, profile_dir: str) -> None:
    prof.__exit__(None, None, None)
    os.makedirs(profile_dir, exist_ok=True)
    path = os.path.join(profile_dir, "trace.json")
    prof.export_chrome_trace(path)
    print(f"profiler trace (steps 10-13) -> {path}")


def main(argv=None, txt_tokenizer=None) -> int:
    """``txt_tokenizer`` replaces the SentencePiece text tokenizer (any
    object with ``num_tokens``); pretraining on token ids needs no more."""
    args = build_parser().parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda but torch.cuda.is_available() is False")
    expandable_segments(device)
    set_fp32_precision()

    cfg = get_config(args)
    tokenizer = build_tokenizer(args, txt_tokenizer)
    if cfg.vocab_size < len(tokenizer):
        print(f"[warn] model vocab {cfg.vocab_size} < tokenizer vocab {len(tokenizer)}: "
              "out-of-range ids fail; check --preset", file=sys.stderr)
    timers = Timers()
    writer = MetricsWriter(args.summary_dir, args.experiment_name)
    print(f"device: {device}; config {args.preset} ({cfg.num_layers}L/{cfg.hidden_size}H/"
          f"{cfg.num_heads}h, vocab {cfg.vocab_size})")

    data_cfg = DataConfig(
        train_data=args.train_data or (),
        dataset_type=args.dataset_type,
        split=tuple(float(x) for x in args.split.split(",")),
        batch_size=args.batch_size,
        max_len=cfg.max_position_embeddings,
        seed=args.seed,
    )
    train_it, val_it, _ = make_loaders(data_cfg, tokenizer)
    if train_it is None:
        raise SystemExit("no training data (or fewer samples than --batch-size)")

    params = gpt.init_params(cfg, torch.Generator(device=device).manual_seed(args.seed),
                             device=device)
    opt, schedule = make_optimizer(
        params, lr=args.lr, warmup_iter=max(1, int(args.warmup * args.train_iters)),
        num_iters=args.train_iters, decay_style=args.lr_decay_style,
        decay_ratio=args.lr_decay_ratio, weight_decay=args.weight_decay,
        grad_clip=args.clip_grad)
    rng = torch.Generator().manual_seed(args.seed + 1)
    if args.fp16:
        state = init_fp16_train_state(params, opt, rng, init_scale=args.loss_scale_init,
                                      hysteresis=args.loss_scale_hysteresis)
    else:
        state = init_train_state(params, opt, rng)
    iteration = 0
    loader_consumed = 0  # batches drawn from the current train iterator

    if args.load:
        loaded = checkpointing.load_latest(args.load, map_location=device)
        if loaded is not None:
            _restore(state, loaded, cfg, args.finetune, args.fp16)
            if not args.finetune:
                iteration = int(loaded["iteration"])
                loader_consumed = int(loaded.get("loader_consumed", iteration))
            print(f"loaded checkpoint from {args.load} at iteration {iteration}")
            del loaded
    if args.resume_dataloader and loader_consumed > 0:
        train_it.fast_forward(loader_consumed)

    img_vocab = tokenizer.img_tokenizer.num_tokens
    step_kw = dict(img_vocab=img_vocab, txt_loss_scale=args.txt_loss_scale,
                   remat=args.checkpoint_activations, is_sparse=bool(args.is_sparse),
                   dual_positions_roi2=tokenizer["[ROI2]"] if args.dual_positions else None,
                   max_memory_length=args.max_memory_length)
    if args.fp16:
        step = make_fp16_train_step(cfg, opt, scale_window=args.loss_scale_window,
                                    min_scale=args.min_loss_scale,
                                    hysteresis=args.loss_scale_hysteresis, **step_kw)
    else:
        step = make_train_step(cfg, opt, **step_kw)

    @torch.no_grad()
    def eval_loss(batch):
        batch = {k: torch.as_tensor(v).to(device) for k, v in batch.items()}
        return lm_loss(state["params"], cfg, batch, img_vocab=img_vocab,
                       txt_loss_scale=args.txt_loss_scale, train=False, remat=False)[0]

    known_paths = set(args.train_data or ())
    data_iter = iter(train_it)
    eval_batches = None  # created lazily, reused across eval intervals
    mems = None  # the rolling memory, with --max-memory-length
    prof = None  # torch.profiler over steps 10-13, with --profile-dir
    log_loss, log_img, log_txt, t_last = 0.0, 0.0, 0.0, time.time()

    while iteration < args.train_iters:
        if iteration % 100 == 0 and iteration > 0:
            new_it, known_paths = detect_new_datasets(data_cfg, tokenizer, known_paths)
            if new_it is not None:
                print(f"detected new datasets ({len(known_paths)} paths)")
                train_it = new_it
                data_iter = iter(train_it)
                loader_consumed = 0  # position is relative to the new loader

        timers("data loader").start()
        batch = next(data_iter)
        loader_consumed += 1
        timers("data loader").stop()

        if args.profile_dir and iteration == 9:
            prof = _start_profile(device)
        timers("train step").start()
        if args.max_memory_length > 0:
            state, metrics, mems = step(state, batch, mems=mems)
        else:
            state, metrics = step(state, batch)
        timers("train step").stop()

        iteration += 1
        if prof is not None and iteration == 13:
            _stop_profile(prof, args.profile_dir)
            prof = None
        log_loss += metrics["lm_loss"]
        log_img += metrics["img_loss"]
        log_txt += metrics["txt_loss"]

        if iteration % args.log_interval == 0:
            n = args.log_interval
            elapsed = (time.time() - t_last) * 1000.0 / n
            lr_now = schedule(iteration)
            print(f" iteration {iteration:8d}/{args.train_iters} | "
                  f"elapsed ms/iter {elapsed:.1f} | lr {lr_now:.3E} | "
                  f"lm loss {log_loss / n:.6f} | img loss {log_img / n:.6f} | "
                  f"unscaled txt loss {log_txt / n:.6f} | "
                  f"skipped {state['skipped']}", flush=True)
            print("   " + timers.log(["data loader", "train step"], normalizer=n), flush=True)
            writer.add_scalars(iteration, {
                "lr": lr_now, "train_loss": log_loss / n, "img_loss": log_img / n,
                "txt_loss": log_txt / n, "elapsed_ms": elapsed})
            log_loss = log_img = log_txt = 0.0
            t_last = time.time()

        if args.save and iteration % args.save_interval == 0:
            checkpointing.save_checkpoint(
                args.save, iteration,
                _checkpoint_state(state, iteration, loader_consumed, args.fp16))
            print(f"saved checkpoint at iteration {iteration}")

        if val_it is not None and iteration % args.eval_interval == 0:
            if eval_batches is None:
                eval_batches = iter(val_it)
            ev = evaluate(eval_loss, eval_batches, args.eval_iters)
            if ev:
                print(f" validation loss {ev['val_loss']:.6f} | ppl {ev['val_ppl']:.3f}")
                writer.add_scalars(iteration, ev)

        if args.exit_interval and iteration % args.exit_interval == 0:
            print(f"exiting at iteration {iteration} (--exit-interval)")
            break

    if prof is not None:
        _stop_profile(prof, args.profile_dir)
    if args.save:
        checkpointing.save_checkpoint(
            args.save, iteration, _checkpoint_state(state, iteration, loader_consumed, args.fp16))
    writer.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
