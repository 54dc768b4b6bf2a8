"""Pretraining data of the port: its own copy of ``cogview_tpu.data``'s
templates, datasets, LMDB reader and global-batch loader (numpy only)."""

from .datasets import BinaryDataset, IndexedDataset, get_dataset_by_type
from .loader import DataConfig, detect_new_datasets, make_loaders
from .templates import Code2CodeTemplate, PureTextTemplate, TextCodeTemplate

__all__ = [
    "BinaryDataset",
    "IndexedDataset",
    "get_dataset_by_type",
    "TextCodeTemplate",
    "Code2CodeTemplate",
    "PureTextTemplate",
    "DataConfig",
    "make_loaders",
    "detect_new_datasets",
]
