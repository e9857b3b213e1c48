"""Data pipeline of the port: the image and LM datasets (ImageNet-format
folders and packed records in ``imagenet``), the numpy transforms, the
native batch assembly (``native``), and the sharded loader with its worker
pool and pinned-memory prefetch to the device."""

from .datasets import (
    CIFAR10, CIFAR10_CLASSES, SHAPE_CLASSES, ShapeImages, Subset,
    SyntheticImages, SyntheticTokens, TokenFile, cifar10,
)
from .imagenet import (
    ImageFolder, PackedImages, pack_image_folder, synthesize_packed_images,
)
from .loader import DataLoader, DataLoaderConfig, prefetch_to_device

__all__ = [
    "CIFAR10", "CIFAR10_CLASSES", "SHAPE_CLASSES", "ShapeImages", "Subset",
    "SyntheticImages", "SyntheticTokens", "TokenFile", "cifar10",
    "DataLoader", "DataLoaderConfig", "prefetch_to_device", "ImageFolder",
    "PackedImages", "pack_image_folder", "synthesize_packed_images",
]
