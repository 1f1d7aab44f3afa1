"""Datasets, transforms and the batch loader (port of `attentiondm_tpu/data`)."""
from .transforms import data_transform, inverse_data_transform, inverse_transform_uint8, logit_transform
from .datasets import (
    get_dataset,
    SyntheticDataset,
    Cifar10Dataset,
    ImageFolderDataset,
    CelebADataset,
    LSUNClassDataset,
    FFHQLmdbDataset,
)
from .lmdb_reader import LMDBReader, write_lmdb
from .loader import iterate_batches
from .synthetic import synthetic_batch

__all__ = [
    "synthetic_batch",
    "data_transform",
    "inverse_data_transform",
    "inverse_transform_uint8",
    "logit_transform",
    "get_dataset",
    "SyntheticDataset",
    "Cifar10Dataset",
    "ImageFolderDataset",
    "iterate_batches",
]
