"""ctypes bindings to the repo's native batch assembly,
``csrc/fastbatch.cpp``: the counterpart of the JAX package's
``data/native.py``.

The library is built with g++ at first use into
``<repo>/build/fastbatch/libfastbatch-<hash>.so`` (the hash covers the
source and the flags, so an edited source is rebuilt), never into
``csrc/``; nothing is built at import time.  A failed build raises: a
caller never drops to numpy on its own.  The numpy versions of the same
semantics (``*_plain``) stay beside the bindings as their plain versions,
which the tests hold the library against.

Each binding adds one to its ``calls`` attribute per call, so a run can
show that the native code assembled its batches.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import subprocess

import numpy as np

from .transforms import bilinear_resize_reference

SOURCE = pathlib.Path(__file__).resolve().parents[2] / "csrc" / "fastbatch.cpp"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[2] / "build" / "fastbatch"
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-Wall", "-Wextra", "-pthread",
             "-shared")


def library_path() -> pathlib.Path:
    digest = hashlib.sha256(
        SOURCE.read_bytes() + " ".join(CXX_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"libfastbatch-{digest[:16]}.so"


def build() -> pathlib.Path:
    """Compile the library unless it is there; raises with g++'s output
    when the build fails."""
    lib = library_path()
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cxx = os.environ.get("CXX", "g++")
    res = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                         capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"building {SOURCE.name} with {cxx} failed:\n"
                           f"{res.stdout}{res.stderr}")
    os.replace(tmp, lib)
    return lib


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    p, i64, f32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_float
    lib.fb_gather_u8_to_f32.argtypes = [p, p, p, i64, i64, f32]
    lib.fb_gather_u8_normalize.argtypes = [p, p, p, i64, i64, i64, f32, p, p]
    lib.fb_gather_u16_to_i32.argtypes = [p, p, p, i64, i64, i64]
    lib.fb_crop_resize_flip_normalize.argtypes = [
        p, p, p, p, p, i64, i64, i64, i64, i64, i64, f32, p, p]
    lib.fb_crop_resize_flip_u8.argtypes = [
        p, p, p, p, p, i64, i64, i64, i64, i64, i64]
    for fn in (lib.fb_gather_u8_to_f32, lib.fb_gather_u8_normalize,
               lib.fb_gather_u16_to_i32, lib.fb_crop_resize_flip_normalize,
               lib.fb_crop_resize_flip_u8):
        fn.restype = None
    return lib


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


def _u8_images(images: np.ndarray) -> None:
    if images.dtype != np.uint8 or not images.flags.c_contiguous:
        raise ValueError("images must be a C-contiguous uint8 array")


def _indices(indices, n: int) -> np.ndarray:
    idx = np.ascontiguousarray(indices, np.int64)
    if idx.size and (idx.min() < 0 or idx.max() >= n):
        raise IndexError(f"indices out of range [0, {n})")
    return idx


def _counted(fn):
    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        wrapper.calls += 1
        return fn(*args, **kwargs)
    wrapper.calls = 0
    return wrapper


@_counted
def gather_images_u8(images: np.ndarray, indices, *,
                     scale: float = 1.0 / 255.0) -> np.ndarray:
    """(N, ...) uint8 + (B,) indices -> (B, ...) f32 scaled by ``scale``."""
    _u8_images(images)
    idx = _indices(indices, len(images))
    out = np.empty((len(idx), *images.shape[1:]), np.float32)
    _lib().fb_gather_u8_to_f32(_ptr(images), _ptr(idx), _ptr(out), len(idx),
                               int(np.prod(images.shape[1:])), scale)
    return out


def gather_images_u8_plain(images, indices, *, scale=1.0 / 255.0):
    return images[np.asarray(indices, np.int64)].astype(
        np.float32) * np.float32(scale)


@_counted
def gather_images_u8_normalized(images: np.ndarray, indices, mean, std, *,
                                scale: float = 1.0 / 255.0) -> np.ndarray:
    """Gather + ToTensor scaling + per-channel normalize (HWC)."""
    _u8_images(images)
    idx = _indices(indices, len(images))
    channels = images.shape[-1]
    mean32 = np.ascontiguousarray(np.broadcast_to(mean, channels), np.float32)
    std32 = np.ascontiguousarray(np.broadcast_to(std, channels), np.float32)
    out = np.empty((len(idx), *images.shape[1:]), np.float32)
    _lib().fb_gather_u8_normalize(
        _ptr(images), _ptr(idx), _ptr(out), len(idx),
        int(np.prod(images.shape[1:])), channels, scale, _ptr(mean32),
        _ptr(std32))
    return out


def gather_images_u8_normalized_plain(images, indices, mean, std, *,
                                      scale=1.0 / 255.0):
    x = gather_images_u8_plain(images, indices, scale=scale)
    return (x - np.asarray(mean, np.float32)) / np.asarray(std, np.float32)


@_counted
def gather_token_windows(tokens: np.ndarray, starts, seq_len: int
                         ) -> np.ndarray:
    """uint16 flat corpus + (B,) window indices -> (B, seq_len) int32;
    window i starts at element ``starts[i] * seq_len``."""
    if tokens.dtype != np.uint16:
        raise ValueError("tokens must be uint16")
    idx = _indices(starts, len(tokens) // seq_len)
    src = tokens if isinstance(tokens, np.memmap) \
        else np.ascontiguousarray(tokens)
    out = np.empty((len(idx), seq_len), np.int32)
    _lib().fb_gather_u16_to_i32(_ptr(src), _ptr(idx), _ptr(out), len(idx),
                                seq_len, seq_len)
    return out


def gather_token_windows_plain(tokens, starts, seq_len):
    starts = np.asarray(starts, np.int64)[:, None] * seq_len
    return tokens[starts + np.arange(seq_len)].astype(np.int32)


def _crop_args(images, indices, boxes, flips):
    _u8_images(images)
    idx = _indices(indices, len(images))
    boxes32 = np.ascontiguousarray(boxes, np.int32).reshape(len(idx), 4)
    _, hs, ws, _ = images.shape
    top, left, ch, cw = boxes32.T
    if ((top < 0) | (left < 0) | (ch < 1) | (cw < 1) | (top + ch > hs)
            | (left + cw > ws)).any():
        raise ValueError("crop boxes must lie inside the images")
    return idx, boxes32, np.ascontiguousarray(flips, np.uint8)


@_counted
def crop_resize_flip_normalize(images, indices, boxes, flips, out_size,
                               mean, std, *, scale: float = 1.0 / 255.0
                               ) -> np.ndarray:
    """Batched crop + bilinear resize + horizontal flip + scale +
    normalize.  images (N, H, W, C) uint8; boxes (B, 4) int32 (top, left,
    crop_h, crop_w); flips (B,) bool; returns (B, oh, ow, C) f32."""
    idx, boxes32, flips8 = _crop_args(images, indices, boxes, flips)
    n, hs, ws, c = images.shape
    oh, ow = out_size
    mean32 = np.ascontiguousarray(np.broadcast_to(mean, c), np.float32)
    std32 = np.ascontiguousarray(np.broadcast_to(std, c), np.float32)
    out = np.empty((len(idx), oh, ow, c), np.float32)
    _lib().fb_crop_resize_flip_normalize(
        _ptr(images), _ptr(idx), _ptr(boxes32), _ptr(flips8), _ptr(out),
        len(idx), hs, ws, c, oh, ow, scale, _ptr(mean32), _ptr(std32))
    return out


def _resized_plain(images, indices, boxes, flips, out_size):
    out = []
    for i, (top, left, ch, cw), flip in zip(indices, boxes, flips):
        crop = images[i, top:top + ch, left:left + cw]
        r = bilinear_resize_reference(crop, *out_size)
        out.append(r[:, ::-1] if flip else r)
    return np.stack(out)


def crop_resize_flip_normalize_plain(images, indices, boxes, flips, out_size,
                                     mean, std, *, scale=1.0 / 255.0):
    x = _resized_plain(images, indices, boxes, flips, out_size)
    return (x * np.float32(scale) - np.asarray(mean, np.float32)) \
        / np.asarray(std, np.float32)


@_counted
def crop_resize_flip_u8(images, indices, boxes, flips, out_size
                        ) -> np.ndarray:
    """The uint8 form: crop + resize + flip, rounded half up, with the
    scale and normalize left to the device."""
    idx, boxes32, flips8 = _crop_args(images, indices, boxes, flips)
    n, hs, ws, c = images.shape
    oh, ow = out_size
    out = np.empty((len(idx), oh, ow, c), np.uint8)
    _lib().fb_crop_resize_flip_u8(
        _ptr(images), _ptr(idx), _ptr(boxes32), _ptr(flips8), _ptr(out),
        len(idx), hs, ws, c, oh, ow)
    return out


def crop_resize_flip_u8_plain(images, indices, boxes, flips, out_size):
    x = _resized_plain(images, indices, boxes, flips, out_size)
    return np.floor(x + np.float32(0.5)).astype(np.uint8)
