"""FID / Inception-Score CLI (twin of cogview_tpu/cli/fid.py).

  python -m cogview_tpu_torch.cli.fid --path1 real_imgs/ --path2 gen_imgs/ \\
      [--inception-weights inception_v3.pth] [--extractor inception|vq]

``--path1``/``--path2`` accept either an image directory or a base64-image
``.tsv`` corpus (``id \\t _ \\t caption \\t image_base64`` rows).  TSV
sources are streamed through :class:`..eval_utils.fid.StreamingStats`, so
corpus size is unbounded by host memory.  Folder images are read by the
port's readers and resized as Pillow's ``resize((s, s))`` does (BICUBIC).

The extractor is InceptionV3 (pool3 2048-d, the reference's block-3
features) on the device.  Pass --inception-weights with a torchvision
``inception_v3`` state-dict file for published-comparable numbers;
without it the network is a seeded random one (relative comparisons
only, loudly flagged).  --extractor vq selects the VQ-encoder proxy
instead.  --inception-score also reports IS of --path2 (meaningful only
with the fc head of pretrained weights).

Runs on a CUDA device by default and fails if there is none; ``--device
cpu`` runs on the CPU.  Features are computed on the device, statistics
on the host in float64.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

IMAGE_EXTS = (".png", ".jpg", ".jpeg", ".bmp", ".webp")


def load_image_dir(path: str, img_size: int = 256, limit: int = 0) -> np.ndarray:
    from ..models.vqvae import decode_image, resize_bicubic

    names = sorted(f for f in os.listdir(path) if f.lower().endswith(IMAGE_EXTS))
    if limit:
        names = names[:limit]
    out = []
    for n in names:
        with open(os.path.join(path, n), "rb") as f:
            data = f.read()
        try:
            img = decode_image(data)
        except ValueError as e:
            raise type(e)(f"{os.path.join(path, n)}: {e}") from None
        if img.shape[:2] != (img_size, img_size):
            img = resize_bicubic(img, img_size, img_size)
        out.append(np.asarray(img, np.float32) / 255.0)
    return np.stack(out)


def is_tsv(path: str) -> bool:
    return os.path.isfile(path) and path.lower().endswith((".tsv", ".txt"))


def source_statistics(path, extractor, batch_size, img_size=256, limit=0):
    """(mu, sigma, n) of a source: image dir (in-memory) or base64 TSV
    (streamed: never more than one batch of pixels)."""
    from ..eval_utils.dataset import iter_tsv_image_batches
    from ..eval_utils.fid import StreamingStats

    stats = StreamingStats()
    if is_tsv(path):
        batches = iter_tsv_image_batches(path, batch_size, img_size, limit)
    else:
        imgs = load_image_dir(path, img_size, limit)
        batches = (imgs[i:i + batch_size] for i in range(0, len(imgs), batch_size))
    for batch in batches:
        stats.update(np.asarray(extractor(batch)))
    mu, sigma = stats.finalize()
    return mu, sigma, stats.n


def load_source_images(path, img_size=256, limit=0) -> np.ndarray:
    """Materialize a source (dir or TSV) as [n,s,s,3] float32 in [0,1]."""
    if not is_tsv(path):
        return load_image_dir(path, img_size, limit)
    from ..eval_utils.dataset import TsvImageStream

    return np.stack([img for img, _i, _c in
                     TsvImageStream(path, img_size=img_size, limit=limit)])


def build_parser():
    p = argparse.ArgumentParser("cogview-tpu-torch fid")
    p.add_argument("--path1", required=True)
    p.add_argument("--path2", required=True)
    p.add_argument("--extractor", default="inception", choices=["inception", "vq"])
    p.add_argument("--inception-weights", default=None,
                   help="torchvision inception_v3 state-dict (.pth/.pt)")
    p.add_argument("--img-tokenizer-path", default=None,
                   help="VQ-VAE .pt for --extractor vq")
    p.add_argument("--inception-score", action="store_true",
                   help="also report IS of --path2")
    p.add_argument("--is-splits", type=int, default=10)
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--limit", type=int, default=0)
    p.add_argument("--device", default="cuda")
    return p


def main(argv=None):
    """Prints FID (and IS) and returns 0; the numbers are kept in
    ``main.last`` for callers that drive the CLI in-process."""
    args = build_parser().parse_args(argv)
    import torch

    from ..eval_utils.fid import InceptionFeatures, VQEncoderFeatures, frechet_distance
    from ..ops.precision import set_fp32_precision

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda but torch.cuda.is_available() is False")
    set_fp32_precision()

    if args.extractor == "inception":
        extractor = InceptionFeatures(weights_path=args.inception_weights, device=device)
        label = "FID" if extractor.pretrained else "FID(random-init inception)"
        if not extractor.pretrained:
            print("[warn] no --inception-weights: random-init InceptionV3 — "
                  "NOT comparable to published FID", file=sys.stderr)
    else:
        from ..config import VQVAEConfig
        from ..models import vqvae
        from ..models.convert import load_vqvae_checkpoint

        if args.img_tokenizer_path:
            params = load_vqvae_checkpoint(args.img_tokenizer_path, device)
        else:
            print("[warn] random VQ-VAE extractor (relative comparisons only)",
                  file=sys.stderr)
            params = vqvae.tree_to(
                vqvae.init_params(VQVAEConfig(), torch.Generator().manual_seed(0)), device)
        extractor = VQEncoderFeatures(params, device=device)
        label = "FID(vq-proxy)"

    mu1, s1, n1 = source_statistics(args.path1, extractor, args.batch_size, limit=args.limit)
    mu2, s2, n2 = source_statistics(args.path2, extractor, args.batch_size, limit=args.limit)
    fid = frechet_distance(mu1, s1, mu2, s2)
    print(f"{label}: {fid:.4f}  (n1={n1}, n2={n2})")
    main.last = {"fid": fid, "n1": n1, "n2": n2, "mu1": mu1, "sigma1": s1, "mu2": mu2,
                 "sigma2": s2}

    if args.inception_score:
        from ..eval_utils import inception
        from ..eval_utils.inception_score import inception_score

        if args.inception_weights:
            model = inception.load_model(args.inception_weights, device)
        else:
            print("[warn] random-init classifier for IS — numbers meaningless",
                  file=sys.stderr)
            model = inception.init_model(0, device=device)

        def classifier(batch):
            # IS feeds (-1, 1) images (inception_score.py:12)
            x = torch.as_tensor(np.asarray(batch * 2.0 - 1.0, np.float32), device=device)
            return torch.softmax(inception.logits(model, x, resize_input=True), -1).cpu().numpy()

        imgs2 = load_source_images(args.path2, limit=args.limit)
        mean, std = inception_score(imgs2, classifier, args.batch_size, args.is_splits)
        print(f"IS: {mean:.4f} +/- {std:.4f}  (n={len(imgs2)})")
        main.last.update(is_mean=mean, is_std=std)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
