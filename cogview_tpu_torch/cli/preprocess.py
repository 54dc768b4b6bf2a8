"""Preprocessing CLI (twin of cogview_tpu/cli/preprocess.py).

Streams images from a folder/zip/tar/rar/h5 source, looks up captions in a
TSV/JSON text source, VQ-encodes on the card, and writes training corpora:
CompactBinary .bin for text2image (what ``cli.pretrain --train-data``
reads), IndexedDataset for super-resolution pairs and pure text.

  python -m cogview_tpu_torch.cli.preprocess --task text2image \\
      --image-source imgs.zip --text-source captions.tsv \\
      --img-tokenizer-path vqvae.pt --output data/mycorpus_t2i.bin

``--task import-lmdb`` converts a reference LMDB corpus (pickled rows and a
'length' key) into an IndexedDataset for ``--dataset-type
TokenizedDataset`` with the pure-Python reader (data/lmdb_io.py).

Runs on a CUDA device by default and fails if there is none; ``--device
cpu`` runs on the CPU.  Images are decoded and resized by the port's
own readers, byte-equal to Pillow; an image of a format the port does not
read stops the run with a named error (preprocess/raw_datasets.py).
"""

from __future__ import annotations

import argparse
import sys
import time


def build_parser():
    p = argparse.ArgumentParser("cogview-tpu-torch preprocess")
    p.add_argument("--task", default="text2image",
                   choices=["text2image", "super-resolution", "text", "import-lmdb"])
    p.add_argument("--lmdb-path", default=None,
                   help="LMDB environment dir (or data.mdb) for import-lmdb")
    p.add_argument("--image-source", default=None,
                   help="dir | .zip | .tar[.gz] | .rar | .h5 of images")
    p.add_argument("--text-source", default=None, help=".tsv or .json captions")
    p.add_argument("--output", required=True)
    p.add_argument("--img-tokenizer-path", default=None)
    p.add_argument("--text-model-path", default=None)
    p.add_argument("--img-size", type=int, default=None,
                   help="default: 256 (t2i) / 512 (super-resolution)")
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--sampling-num", type=int, default=4,
                   help="SR patches sampled per image")
    p.add_argument("--seq-len", type=int, default=1089, help="text task row length")
    p.add_argument("--recover-grid", default=None, metavar="PNG",
                   help="debug: before writing the corpus, VQ-roundtrip the "
                        "first --batch-size images and save an "
                        "original-vs-recovered grid (reference "
                        "show_recover_results, preprocess/utils.py:23-31)")
    p.add_argument("--device", default="cuda")
    return p


def _import_lmdb(args, t0) -> int:
    import numpy as np

    from ..data.datasets import IndexedDataset
    from ..data.lmdb_io import LMDBCorpusReader

    src = LMDBCorpusReader(args.lmdb_path or args.image_source)

    def rows():
        for i in range(len(src)):
            row = src[i]
            if isinstance(row, (tuple, list)) and len(row) == 2:
                # (text, code) pairs -> the TextCodeDataset layout
                text, code = (np.asarray(r).ravel() for r in row)
                yield np.concatenate([text, [-1], code])
            else:
                yield np.asarray(row).ravel()

    IndexedDataset.write(args.output, rows())
    print(f"imported {len(src)} LMDB rows -> {args.output}.bin in {time.time() - t0:.1f}s")
    src.close()
    return 0


def main(argv=None, txt_tokenizer=None) -> int:
    """``txt_tokenizer`` replaces the SentencePiece text tokenizer (any
    object with ``num_tokens`` and ``EncodeAsIds``)."""
    args = build_parser().parse_args(argv)
    import torch

    from ..data.datasets import IndexedDataset
    from ..ops.precision import set_fp32_precision
    from ..preprocess.raw_datasets import TsvTextSource, open_image_source
    from ..preprocess.tokenize_images import (
        CompactBinaryWriter,
        make_cut_text_rows,
        make_super_resolution_rows,
        make_text_image_rows,
    )
    from ..tokenization import UnifiedTokenizer
    from ..tokenization.vq_tokenizer import TorchVQTokenizer

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda but torch.cuda.is_available() is False")
    set_fp32_precision()
    t0 = time.time()
    if args.task == "import-lmdb":
        return _import_lmdb(args, t0)

    if args.task == "text":
        tok = UnifiedTokenizer(txt_tokenizer=txt_tokenizer, text_model_path=args.text_model_path)
        with open(args.text_source or args.image_source, encoding="utf-8") as f:
            texts = [line.strip() for line in f if line.strip()]
        rows = []
        n = make_cut_text_rows(tok, texts, args.seq_len, rows)
        IndexedDataset.write(args.output, rows)
        print(f"wrote {n} rows -> {args.output}.bin in {time.time() - t0:.1f}s")
        return 0

    if args.img_tokenizer_path:
        vq = TorchVQTokenizer.from_checkpoint(args.img_tokenizer_path, device=device)
    else:
        print("[warn] no --img-tokenizer-path: random VQ-VAE", file=sys.stderr)
        vq = TorchVQTokenizer.random_init(device=device)
    tok = UnifiedTokenizer(img_tokenizer=vq, txt_tokenizer=txt_tokenizer,
                           text_model_path=args.text_model_path)
    text_source = TsvTextSource(args.text_source)
    img_size = args.img_size or (512 if args.task == "super-resolution" else 256)
    source = open_image_source(args.image_source, img_size=img_size)

    if args.recover_grid:
        import itertools

        import numpy as np

        from ..preprocess.recover_grid import write_recover_grid

        batch = [im for _id, im in itertools.islice(iter(source), args.batch_size)]
        if not batch:
            print("[warn] --recover-grid: image source is empty", file=sys.stderr)
        else:
            write_recover_grid(vq, np.stack(batch), args.recover_grid)
            print(f"recover grid ({len(batch)} images) -> {args.recover_grid}")
        source = open_image_source(args.image_source, img_size=img_size)

    if args.task == "text2image":
        writer = CompactBinaryWriter(args.output)
        n = make_text_image_rows(vq, tok, iter(source), text_source, writer,
                                 batch_size=args.batch_size, log_every=512)
        writer.close()
        dt = time.time() - t0
        print(f"wrote {n} rows -> {args.output} in {dt:.1f}s ({n / dt:.1f} images/s)")
    else:
        rows = []
        n = make_super_resolution_rows(
            vq, tok, iter(source), text_source, rows,
            img_size=img_size, sampling_num=args.sampling_num,
            batch_size=args.batch_size,
        )
        IndexedDataset.write(args.output, rows)
        print(f"wrote {n} rows -> {args.output}.bin in {time.time() - t0:.1f}s")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
