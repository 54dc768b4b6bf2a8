"""Archive and image sources for offline preprocessing (twin of
cogview_tpu/preprocess/raw_datasets.py).

A folder, zip, tar (streamed), RAR (through the system libarchive,
rar_reader.py) or HDF5 source yields ``(sample_id, normalized [h, w, 3]
float32)`` pairs ready for VQ encoding, in the JAX package's order; a TSV
or JSON file maps image names to captions.  Images are decoded by the
port's own readers (``models/vqvae.py::decode_image``: PNG, JPEG, BMP,
GIF) and resized as Pillow's bilinear filter does, byte-equal to Pillow's
``convert("RGB")`` and ``resize``.

The JAX package drops every image Pillow cannot open.  Here bytes of a
format the port reads that fail to decode, and bytes that are no image,
are skipped too, and counted in the source's ``skipped`` (a warning names
the count at the end); an image whose format the port does not read
(WebP, TIFF, arithmetic-coded JPEG, ...: ``UnsupportedImageError``) stops
the run with an error naming the file, since the JAX package would have
read it.
"""

from __future__ import annotations

import json
import os
import struct
import sys
import tarfile
import zipfile
import zlib
from typing import Dict, Iterator, Optional, Tuple

import numpy as np

from ..models.vqvae import decode_image, image_from_array, to_model_input
from ..utils.image_errors import UnsupportedImageError

IMG_EXTS = (".jpg", ".jpeg", ".png", ".bmp", ".webp")

# what a corrupt file of a format the port reads raises while it is decoded
DECODE_ERRORS = (ValueError, zlib.error, IndexError, struct.error)

__all__ = ["IMG_EXTS", "to_model_input", "ImageFolderDataset", "ZipDataset", "TarDataset",
           "RarDataset", "H5Dataset", "open_image_source", "TsvTextSource"]


class _Source:
    """Counts what it skips; subclasses yield (name, bytes) in ``_entries``."""

    def __init__(self, path, img_size: int = 256):
        self.path = path
        self.img_size = img_size
        self.skipped = 0

    def _entries(self) -> Iterator[Tuple[str, bytes]]:
        raise NotImplementedError

    def __iter__(self) -> Iterator[Tuple[str, np.ndarray]]:
        self.skipped = 0
        for name, data in self._entries():
            try:
                img = decode_image(data)
            except UnsupportedImageError as e:
                raise UnsupportedImageError(f"{name}: {e}") from None
            except DECODE_ERRORS:
                self.skipped += 1
                continue
            yield name, to_model_input(img, self.img_size)
        if self.skipped:
            print(f"[warn] {self.path}: skipped {self.skipped} undecodable images",
                  file=sys.stderr)


class ImageFolderDataset(_Source):
    def __init__(self, root: str, img_size: int = 256):
        super().__init__(root, img_size)
        self.root = root
        self.names = sorted(
            os.path.join(dp, f)
            for dp, _, fs in os.walk(root)
            for f in fs
            if f.lower().endswith(IMG_EXTS)
        )

    def _entries(self):
        for p in self.names:
            with open(p, "rb") as f:
                data = f.read()
            yield os.path.relpath(p, self.root), data


class ZipDataset(_Source):
    def _entries(self):
        with zipfile.ZipFile(self.path) as z:
            for info in z.infolist():
                if info.is_dir() or not info.filename.lower().endswith(IMG_EXTS):
                    continue
                yield info.filename, z.read(info)


class TarDataset(_Source):
    """Streaming tar reader: sequential decompression, constant memory."""

    def _entries(self):
        with tarfile.open(self.path, "r|*") as t:
            for member in t:
                if not member.isfile() or not member.name.lower().endswith(IMG_EXTS):
                    continue
                f = t.extractfile(member)
                if f is None:
                    continue
                yield member.name, f.read()


class RarDataset(_Source):
    """RAR4/RAR5 image source (libarchive decodes sequentially in constant
    memory).  Accepts a path or a binary stream."""

    def _entries(self):
        from .rar_reader import iter_rar_entries

        for name, data in iter_rar_entries(self.path):
            if name.lower().endswith(IMG_EXTS):
                yield name, data


class H5Dataset:
    """HDF5 image arrays: a dataset of [n, h, w, 3] uint8 (or [n, h, w],
    [n, h, w, 4]) plus optional 'names', each image read as Pillow's
    ``Image.fromarray`` reads it.  Needs h5py, imported when iterated."""

    def __init__(self, path: str, dataset: str = "images", img_size: int = 256):
        self.path = path
        self.dataset = dataset
        self.img_size = img_size

    def __iter__(self):
        try:
            import h5py
        except ImportError as e:
            raise ImportError(f"{self.path}: HDF5 image sources need h5py, which is not "
                              "installed; repack the images as a folder, zip or tar") from e

        with h5py.File(self.path, "r") as f:
            data = f[self.dataset]
            names = f.get("names")
            for i in range(len(data)):
                name = names[i].decode() if names is not None else f"{i}"
                try:
                    img = image_from_array(np.asarray(data[i]))
                except UnsupportedImageError as e:
                    raise UnsupportedImageError(f"{self.path}[{i}]: {e}") from None
                yield name, to_model_input(img, self.img_size)


def open_image_source(path: str, img_size: int = 256):
    if os.path.isdir(path):
        return ImageFolderDataset(path, img_size)
    if path.endswith(".zip"):
        return ZipDataset(path, img_size)
    if path.endswith((".tar", ".tar.gz", ".tgz")):
        return TarDataset(path, img_size)
    if path.endswith(".rar"):
        return RarDataset(path, img_size)
    if path.endswith((".h5", ".hdf5")):
        return H5Dataset(path, img_size=img_size)
    raise ValueError(f"unsupported image source: {path}")


class TsvTextSource:
    """'<image name>\\t<text>' lines (or JSON {name: text} files)."""

    def __init__(self, path: str):
        self.by_name: Dict[str, str] = {}
        if path.endswith(".json"):
            with open(path, encoding="utf-8") as f:
                data = json.load(f)
            if isinstance(data, dict):
                self.by_name = {str(k): str(v) for k, v in data.items()}
            else:  # list of {"uniqueKey"/"name": ..., "cnShortText"/"text": ...}
                for row in data:
                    key = row.get("uniqueKey") or row.get("name") or row.get("id")
                    txt = row.get("cnShortText") or row.get("text") or row.get("caption")
                    if key and txt:
                        self.by_name[str(key)] = str(txt)
        else:
            with open(path, encoding="utf-8") as f:
                for line in f:
                    parts = line.rstrip("\n").split("\t")
                    if len(parts) >= 2:
                        self.by_name[parts[0]] = parts[1]

    def lookup(self, name: str) -> Optional[str]:
        if name in self.by_name:
            return self.by_name[name]
        stem = os.path.splitext(os.path.basename(name))[0]
        if stem in self.by_name:
            return self.by_name[stem]
        if not hasattr(self, "_by_stem"):
            self._by_stem = {
                os.path.splitext(os.path.basename(k))[0]: v
                for k, v in self.by_name.items()
            }
        return self._by_stem.get(stem)
