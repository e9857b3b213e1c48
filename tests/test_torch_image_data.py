"""PyTorch port of the image data path against the JAX package.

- ``SyntheticImages``, ``ShapeImages`` and ``CIFAR10`` (read from a small
  archive this test writes) give bit-identical samples and batches;
- the numpy transforms give identical outputs for the same generator;
- the native batch assembly (``data/native.py``, ``csrc/fastbatch.cpp``
  built with g++) equals its numpy plain versions, and counts its calls;
- the loader's batch order equals JAX's, in-process and through the
  worker pool, with one and two shards;
- the CLI runs the reference's command on the host, defaults to ResNet-18
  on CIFAR-10, and without the archive raises JAX's FileNotFoundError.
"""

import os
import pickle
import tarfile

import numpy as np
import pytest
import torch

from pytorch_distributed_training_tpu import data as jdata
from pytorch_distributed_training_tpu.data import transforms as jtf
from pytorch_distributed_training_tpu_torch import data as tdata
from pytorch_distributed_training_tpu_torch.cli.main import (
    build_parser, main as cli_main,
)
from pytorch_distributed_training_tpu_torch.data import native
from pytorch_distributed_training_tpu_torch.data import transforms as ttf

SMALL = "num_filters=8,small_stem=true"


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: the cores are shared with the other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _assert_samples_equal(a: dict, b: dict):
    assert a.keys() == b.keys()
    for k in a:
        assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def _write_cifar(root, n_per_batch=6, seed=0, archive=False):
    """A CIFAR-10 python-version tree (5 train batches + test) of random
    bytes; with ``archive`` packed as the .tar.gz the reader unpacks."""
    rng = np.random.default_rng(seed)
    folder = os.path.join(root, "cifar-10-batches-py")
    os.makedirs(folder)
    for name in [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"]:
        entry = {"data": rng.integers(0, 256, (n_per_batch, 3072),
                                      dtype=np.uint8),
                 "labels": rng.integers(0, 10, n_per_batch).tolist()}
        with open(os.path.join(folder, name), "wb") as f:
            pickle.dump(entry, f)
    if archive:
        with tarfile.open(os.path.join(root, "cifar-10-python.tar.gz"),
                          "w:gz") as tf:
            tf.add(folder, arcname="cifar-10-batches-py")
        for name in os.listdir(folder):
            os.remove(os.path.join(folder, name))
        os.rmdir(folder)
    return root


# --- datasets ---------------------------------------------------------------

@pytest.mark.parametrize("size", [32, 8])
def test_synthetic_images_match_jax(size):
    kw = dict(n=50, image_size=size, num_classes=7, seed=3)
    j, t = jdata.SyntheticImages(**kw), tdata.SyntheticImages(**kw)
    assert len(t) == len(j) and t.classes == j.classes
    for i in (0, 1, 49, 53):
        _assert_samples_equal(t[i], j[i])


@pytest.mark.parametrize("train", [True, False])
def test_shape_images_match_jax(train):
    j = jdata.ShapeImages(n=100, train=train, seed=2)
    t = tdata.ShapeImages(n=100, train=train, seed=2)
    assert t.classes == j.classes == list(tdata.SHAPE_CLASSES)
    for i in (0, 7, 99, 131):
        _assert_samples_equal(t[i], j[i])


@pytest.mark.parametrize("archive", [False, True], ids=["folder", "tar.gz"])
def test_cifar10_matches_jax(tmp_path, archive):
    jroot = _write_cifar(str(tmp_path / "j"), archive=archive)
    troot = _write_cifar(str(tmp_path / "t"), archive=archive)
    for train in (True, False):
        j = jdata.CIFAR10(jroot, train=train)
        t = tdata.CIFAR10(troot, train=train)
        assert len(t) == len(j) == (30 if train else 6)
        assert t.classes == j.classes
        np.testing.assert_array_equal(t.images, j.images)
        for i in (0, len(t) - 1):
            _assert_samples_equal(t[i], j[i])
        idx = [5, 0, len(t) - 1, 2]
        _assert_samples_equal(t.get_batch(idx), j.get_batch(idx))
    norm = ttf.Compose([ttf.ToTensor(), ttf.Normalize()])
    jn = jdata.CIFAR10(jroot, transform=jtf.Compose(
        [jtf.ToTensor(), jtf.Normalize()]))
    tn = tdata.CIFAR10(troot, transform=norm)
    np.testing.assert_allclose(tn.get_batch([3, 1])["image"],
                               jn.get_batch([3, 1])["image"], rtol=1e-6,
                               atol=1e-6)


def test_cifar10_factory_and_missing_archive(tmp_path):
    syn = tdata.cifar10(str(tmp_path), synthetic=True)
    ref = jdata.cifar10(str(tmp_path), synthetic=True)
    assert len(syn) == len(ref) == 50_000
    _assert_samples_equal(syn[17], ref[17])
    with pytest.raises(FileNotFoundError) as got:
        tdata.cifar10(str(tmp_path))
    with pytest.raises(FileNotFoundError) as want:
        jdata.cifar10(str(tmp_path))
    assert str(got.value) == str(want.value)


# --- transforms -------------------------------------------------------------

def _pipelines(mod):
    return {
        "imagenet-train": mod.imagenet_train_transform(24),
        "imagenet-eval": mod.imagenet_eval_transform(24),
        "cifar-train": mod.cifar_train_transform(),
        "resize-crop": mod.Compose([mod.Resize(20), mod.CenterCrop(16)]),
        "crop-flip": mod.Compose([mod.RandomResizedCrop(16, scale=(0.5, 1.0)),
                                  mod.RandomHorizontalFlip(p=0.5)]),
    }


@pytest.mark.parametrize("name", sorted(_pipelines(ttf)))
def test_transforms_match_jax(name):
    img = np.random.default_rng(0).integers(0, 256, (40, 30, 3),
                                            dtype=np.uint8)
    t, j = _pipelines(ttf)[name], _pipelines(jtf)[name]
    for seed in range(4):
        a = t(img, np.random.default_rng(seed))
        b = j(img, np.random.default_rng(seed))
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    x = img.astype(np.float32)
    np.testing.assert_array_equal(ttf.bilinear_resize_reference(x, 13, 17),
                                  jtf.bilinear_resize_reference(x, 13, 17))


# --- the native library -----------------------------------------------------

def _u8(shape, seed=0):
    return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)


def test_native_gathers_match_plain():
    images = _u8((20, 6, 5, 3))
    idx = [4, 0, 19, 4]
    calls = native.gather_images_u8.calls
    np.testing.assert_array_equal(native.gather_images_u8(images, idx),
                                  native.gather_images_u8_plain(images, idx))
    assert native.gather_images_u8.calls == calls + 1
    mean, std = [0.4, 0.5, 0.6], [0.2, 0.25, 0.3]
    np.testing.assert_allclose(
        native.gather_images_u8_normalized(images, idx, mean, std),
        native.gather_images_u8_normalized_plain(images, idx, mean, std),
        rtol=1e-6, atol=1e-6)
    tokens = np.random.default_rng(1).integers(0, 50257, 1000).astype(
        np.uint16)
    np.testing.assert_array_equal(
        native.gather_token_windows(tokens, [3, 0, 61], 16),
        native.gather_token_windows_plain(tokens, [3, 0, 61], 16))
    with pytest.raises(IndexError):
        native.gather_images_u8(images, [20])
    with pytest.raises(ValueError):
        native.gather_images_u8(images.astype(np.float32), idx)


def test_native_crop_resize_flip_matches_plain():
    images = _u8((5, 20, 24, 3), seed=2)
    idx = [1, 4, 0]
    boxes = np.array([[0, 0, 20, 24], [3, 5, 9, 13], [10, 2, 7, 20]],
                     np.int32)
    flips = np.array([False, True, True])
    mean, std = jtf.IMAGENET_MEAN, jtf.IMAGENET_STD
    got = native.crop_resize_flip_normalize(images, idx, boxes, flips,
                                            (12, 10), mean, std)
    ref = native.crop_resize_flip_normalize_plain(images, idx, boxes, flips,
                                                  (12, 10), mean, std)
    # Separable lerps against the direct bilinear formula: f32 rounding.
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=0)
    got8 = native.crop_resize_flip_u8(images, idx, boxes, flips, (12, 10))
    ref8 = native.crop_resize_flip_u8_plain(images, idx, boxes, flips,
                                            (12, 10))
    diff = np.abs(got8.astype(np.int16) - ref8)
    assert diff.max() <= 1 and (diff > 0).mean() < 0.01
    with pytest.raises(ValueError, match="inside"):
        native.crop_resize_flip_u8(images, [0], [[15, 0, 9, 9]], [False],
                                   (4, 4))


def test_native_library_builds_outside_csrc():
    lib = native.build()
    assert lib.exists() and lib.parent == native.BUILD_DIR
    assert "csrc" not in lib.parts


def test_token_file_uses_the_native_gather(tmp_path):
    path = tmp_path / "corpus.bin"
    np.random.default_rng(0).integers(0, 50257, 1000).astype(
        np.uint16).tofile(path)
    t = tdata.TokenFile(str(path), seq_len=16)
    j = jdata.TokenFile(str(path), seq_len=16)
    calls = native.gather_token_windows.calls
    np.testing.assert_array_equal(t.get_batch([3, 0, 61])["tokens"],
                                  j.get_batch([3, 0, 61])["tokens"])
    assert native.gather_token_windows.calls == calls + 1


# --- the loader -------------------------------------------------------------

@pytest.mark.parametrize("workers", [0, 2])
@pytest.mark.parametrize("shards", [1, 2])
def test_loader_order_matches_jax(shards, workers):
    kw = dict(n=24, image_size=4, num_classes=5, seed=1)
    for shard in range(shards):
        jl = jdata.DataLoader(
            jdata.SyntheticImages(**kw),
            jdata.DataLoaderConfig(batch_size=8, seed=3, num_workers=0),
            shard_index=shard, num_shards=shards)
        tl = tdata.DataLoader(
            tdata.SyntheticImages(**kw),
            tdata.DataLoaderConfig(batch_size=8, seed=3,
                                   num_workers=workers),
            shard_index=shard, num_shards=shards)
        try:
            assert len(jl) == len(tl)
            for epoch in range(2):
                jl.set_epoch(epoch)
                tl.set_epoch(epoch)
                got, ref = list(tl), list(jl)
                assert len(got) == len(ref) > 0
                for a, b in zip(got, ref):
                    _assert_samples_equal(a, b)
        finally:
            tl.close()


def test_loader_takes_the_native_batch_path(tmp_path):
    root = _write_cifar(str(tmp_path))
    ds = tdata.CIFAR10(root)
    loader = tdata.DataLoader(ds, tdata.DataLoaderConfig(batch_size=4,
                                                         num_workers=2))
    jl = jdata.DataLoader(jdata.CIFAR10(root), jdata.DataLoaderConfig(
        batch_size=4, num_workers=0))
    calls = native.gather_images_u8.calls
    got = list(loader)
    for a, b in zip(got, jl):
        _assert_samples_equal(a, b)
    assert native.gather_images_u8.calls == calls + len(got) == calls + 7
    assert getattr(loader, "_pool_obj", None) is None


# --- the CLI ----------------------------------------------------------------

def test_cli_defaults_to_the_reference_run(tmp_path):
    args = build_parser().parse_args([])
    assert (args.model, args.dataset, args.batch_size, args.optimizer,
            args.learning_rate, args.weight_decay, args.precision,
            args.image_size, args.num_workers) == (
        "resnet18", "cifar10", 32, "adam", 0.1, 0.001, "f32", 32, 2)
    with pytest.raises(FileNotFoundError,
                       match="no network egress.*--synthetic-data"):
        cli_main(["--use-cpu", "--data-dir", str(tmp_path)])


@pytest.mark.parametrize("extra", [
    ["--dataset", "shapes", "--model-overrides", SMALL],
    ["--synthetic-data", "--model-overrides", "num_filters=8", "--eval",
     "--eval-steps", "1", "--num-workers", "0"],
    ["--dataset", "synthetic-images", "--image-size", "16", "--model",
     "resnet50", "--model-overrides", "num_filters=4", "--accum-steps", "2",
     "--optimizer", "sgd", "--precision", "bf16", "--num-workers", "0"],
], ids=["shapes", "cifar10-synthetic-eval", "resnet50-bf16"])
def test_cli_trains_an_image_model_on_the_host(capsys, extra):
    trainer = cli_main(["--use-cpu", "--batch-size", "8",
                        "--steps-per-epoch", "2", *extra])
    out = capsys.readouterr().out
    assert "process 0/1 | backend=cpu | devices=1" in out
    assert "training started" in out and "training finished" in out
    assert "elapsed time:" in out
    lines = [ln for ln in out.splitlines() if "examples_per_sec=" in ln]
    assert len(lines) == 1 and "step=2" in lines[0]
    assert "accuracy=" in lines[0]
    assert ("eval_accuracy=" in out) == ("--eval" in extra)
    assert trainer.state.step == 2
    assert np.isfinite(trainer.history[-1]["loss"])
    assert 0.0 <= trainer.history[-1]["accuracy"] <= 1.0


def test_cli_reads_a_cifar_archive_through_the_native_gather(tmp_path,
                                                             capsys):
    root = _write_cifar(str(tmp_path), n_per_batch=8, archive=True)
    calls = native.gather_images_u8.calls
    trainer = cli_main(["--use-cpu", "--data-dir", root, "--batch-size", "8",
                        "--steps-per-epoch", "3", "--model-overrides",
                        SMALL])
    assert trainer.state.step == 3
    assert native.gather_images_u8.calls == calls + 3
    assert "accuracy=" in capsys.readouterr().out


def test_cli_image_usage_errors():
    base = ["--use-cpu", "--synthetic-data"]
    with pytest.raises(SystemExit, match="--remat applies to transformer"):
        cli_main(base + ["--remat"])
    for ds in ("imagefolder:/x", "packed-images:/x"):
        with pytest.raises(FileNotFoundError, match="/x"):
            cli_main(base + ["--dataset", ds])
    with pytest.raises(SystemExit, match="pick a matching pair"):
        cli_main(base + ["--dataset", "synthetic-tokens"])


def test_cli_image_run_needs_a_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli_main(["--synthetic-data", "--steps-per-epoch", "2",
                  "--batch-size", "8"])
