from .raw_datasets import (
    H5Dataset,
    ImageFolderDataset,
    RarDataset,
    TarDataset,
    TsvTextSource,
    ZipDataset,
    open_image_source,
)
from .tokenize_images import (
    CompactBinaryWriter,
    make_cut_text_rows,
    make_super_resolution_rows,
    make_text_image_rows,
)

__all__ = [
    "ImageFolderDataset",
    "ZipDataset",
    "TarDataset",
    "RarDataset",
    "H5Dataset",
    "TsvTextSource",
    "open_image_source",
    "CompactBinaryWriter",
    "make_text_image_rows",
    "make_super_resolution_rows",
    "make_cut_text_rows",
]
