"""Data pipeline of the port: the image and LM datasets (ImageNet-format
folders and packed records in ``imagenet``), the numpy transforms, the
native batch assembly (``native``), the sharded loader with its worker
pool and pinned-memory prefetch to the device, and the device-resident
datasets (``device_cache``, ``token_cache``) that replace the loader
under ``--device-cache``."""

from .datasets import (
    CIFAR10, CIFAR10_CLASSES, SHAPE_CLASSES, ShapeImages, Subset,
    SyntheticImages, SyntheticTokens, TokenFile, cifar10,
)
from .device_cache import DeviceCachedImages
from .token_cache import DeviceCachedTokens
from .imagenet import (
    ImageFolder, PackedImages, pack_image_folder, synthesize_packed_images,
)
from .loader import DataLoader, DataLoaderConfig, prefetch_to_device

__all__ = [
    "CIFAR10", "CIFAR10_CLASSES", "SHAPE_CLASSES", "ShapeImages", "Subset",
    "SyntheticImages", "SyntheticTokens", "TokenFile", "cifar10",
    "DataLoader", "DataLoaderConfig", "prefetch_to_device", "ImageFolder",
    "PackedImages", "pack_image_folder", "synthesize_packed_images",
    "DeviceCachedImages", "DeviceCachedTokens",
]
