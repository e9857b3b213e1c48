"""The port's ImageNet-format datasets (``data/imagenet.py``) against the
JAX package's, on files and image trees this test writes:

- ``synthesize_packed_images`` and ``pack_image_folder`` write files
  byte-equal to JAX's (the ``.classes`` sidecar included);
- ``PackedImages`` uint8 batches are bit-equal to JAX's for the same
  seed, epoch and indices, train and eval.  The JAX bindings are lent the
  port's build of the same ``csrc/fastbatch.cpp`` (the JAX package looks
  for a prebuilt ``csrc/libfastbatch.so``, which no one builds here), so
  both run the native path; the port's batch also equals its numpy plain
  version.  float32 batches are within 1e-6 of JAX's numpy path;
- ``ImageFolder`` gives JAX's samples, labels and transformed images;
- ``set_epoch`` reaches the dataset through the loader, batch for batch
  as JAX's loader;
- no fallback: a failed native build raises from ``get_batch``; without
  PIL an image folder raises a clear ImportError;
- the CLI trains a small ViT on the host from ``packed-images:`` and from
  ``imagefolder:``.
"""

import os

import numpy as np
import pytest
import torch
from PIL import Image

from pytorch_distributed_training_tpu import data as jdata
from pytorch_distributed_training_tpu.data import native as jnative
from pytorch_distributed_training_tpu_torch import data as tdata
from pytorch_distributed_training_tpu_torch.cli.main import main as cli_main
from pytorch_distributed_training_tpu_torch.data import native as tnative
from pytorch_distributed_training_tpu_torch.data import transforms as ttf

SMALL_VIT = "depth=2,hidden_dim=64,num_heads=4,mlp_dim=128"
CLASSES = ("ant", "bee", "cat")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def jax_native(monkeypatch):
    """The JAX bindings with the port's build of the same library."""
    monkeypatch.setattr(jnative, "_LIB", tnative._lib())
    monkeypatch.setattr(jnative, "_TRIED", True)


@pytest.fixture
def jax_numpy(monkeypatch):
    """The JAX bindings without a library: its numpy path."""
    monkeypatch.setattr(jnative, "_LIB", None)
    monkeypatch.setattr(jnative, "_TRIED", True)


@pytest.fixture(scope="module")
def packed(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("packed") / "train.pck")
    tdata.synthesize_packed_images(path, n=24, size=40, num_classes=5,
                                   seed=4)
    return path


def write_tree(root, seed=0, n=3):
    """A class-folder tree of PNG and JPEG images of assorted sizes (some
    smaller than the pack size, some not square)."""
    rng = np.random.default_rng(seed)
    for c, name in enumerate(CLASSES):
        os.makedirs(os.path.join(root, name))
        for i in range(n):
            h, w = (int(v) for v in rng.integers(20, 60, 2))
            arr = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
            ext = ".png" if (c + i) % 2 else ".jpg"
            Image.fromarray(arr).save(os.path.join(root, name, f"{i}{ext}"))
        with open(os.path.join(root, name, "notes.txt"), "w") as f:
            f.write("not an image")
    return root


def test_synthesized_file_is_byte_equal(tmp_path):
    a, b = str(tmp_path / "t.pck"), str(tmp_path / "j.pck")
    tdata.synthesize_packed_images(a, n=70, size=24, num_classes=9, seed=2)
    jdata.synthesize_packed_images(b, n=70, size=24, num_classes=9, seed=2)
    assert open(a, "rb").read() == open(b, "rb").read()


def test_packed_folder_is_byte_equal(tmp_path):
    root = write_tree(str(tmp_path / "tree"))
    a, b = str(tmp_path / "t.pck"), str(tmp_path / "j.pck")
    assert tdata.pack_image_folder(root, a, size=32) == 9
    assert jdata.pack_image_folder(root, b, size=32) == 9
    assert open(a, "rb").read() == open(b, "rb").read()
    assert open(a + ".classes").read() == open(b + ".classes").read() \
        == "\n".join(CLASSES)
    ds = tdata.PackedImages(a, crop_size=24)
    assert ds.classes == list(CLASSES) and len(ds) == 9
    with pytest.raises(ValueError, match="class list"):
        tdata.pack_image_folder(root, a, size=32, classes=["x"])


@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("epoch", [0, 3])
def test_packed_uint8_batches_bit_equal_to_jax(packed, jax_native, train,
                                               epoch):
    kw = dict(train=train, crop_size=32, seed=11, output_dtype="uint8")
    t, j = tdata.PackedImages(packed, **kw), jdata.PackedImages(packed, **kw)
    assert t.classes == j.classes and len(t) == len(j) == 24
    t.set_epoch(epoch)
    j.set_epoch(epoch)
    idx = [0, 5, 23, 5, 17, 2]
    calls = tnative.crop_resize_flip_u8.calls
    got, want = t.get_batch(idx), j.get_batch(idx)
    assert tnative.crop_resize_flip_u8.calls == calls + 1
    assert got["image"].dtype == np.uint8 and got["image"].shape == (
        6, 32, 32, 3)
    np.testing.assert_array_equal(got["image"], want["image"])
    np.testing.assert_array_equal(got["label"], want["label"])
    boxes, flips = t.params(np.asarray(idx))
    if train:
        np.testing.assert_array_equal(boxes,
                                      j._draw_params(np.asarray(idx))[0])
    plain = tnative.crop_resize_flip_u8_plain(t.images, idx, boxes, flips,
                                              (32, 32))
    np.testing.assert_array_equal(got["image"], plain)
    np.testing.assert_array_equal(t[5]["image"], got["image"][1])


def test_packed_float32_batches_match_jax(packed, jax_numpy):
    kw = dict(train=True, crop_size=32, seed=11)
    t, j = tdata.PackedImages(packed, **kw), jdata.PackedImages(packed, **kw)
    idx = list(range(24))
    got, want = t.get_batch(idx), j.get_batch(idx)
    assert got["image"].dtype == np.float32
    np.testing.assert_allclose(got["image"], want["image"], atol=1e-6,
                               rtol=0)


def test_packed_epochs_through_the_loader(packed, jax_native):
    kw = dict(crop_size=24, seed=1, output_dtype="uint8")
    cfg = dict(batch_size=8, seed=5)
    t = tdata.DataLoader(tdata.PackedImages(packed, **kw),
                         tdata.DataLoaderConfig(**cfg))
    j = jdata.DataLoader(jdata.PackedImages(packed, **kw),
                         jdata.DataLoaderConfig(**cfg))
    seen = []
    for epoch in (0, 1):
        t.set_epoch(epoch)
        j.set_epoch(epoch)
        assert t.dataset.epoch == epoch
        tb, jb = list(t), list(j)
        assert len(tb) == len(jb) == 3
        for a, b in zip(tb, jb):
            np.testing.assert_array_equal(a["image"], b["image"])
            np.testing.assert_array_equal(a["label"], b["label"])
        seen.append(tb[0]["image"])
    assert not np.array_equal(seen[0], seen[1])


def test_packed_images_refuse_a_bad_file_and_dtype(tmp_path, packed):
    bad = tmp_path / "bad.pck"
    bad.write_bytes(b"NOTPACKD" + bytes(32))
    with pytest.raises(ValueError, match="not a packed image file"):
        tdata.PackedImages(str(bad))
    with pytest.raises(ValueError, match="output_dtype"):
        tdata.PackedImages(packed, output_dtype="float16")


def test_no_numpy_fallback_when_the_build_fails(packed, monkeypatch):
    def fail():
        raise RuntimeError("building fastbatch.cpp with g++ failed")

    tnative._lib.cache_clear()
    monkeypatch.setattr(tnative, "build", fail)
    try:
        ds = tdata.PackedImages(packed, crop_size=24, output_dtype="uint8")
        with pytest.raises(RuntimeError, match="failed"):
            ds.get_batch([0, 1])
    finally:
        monkeypatch.undo()
        tnative._lib.cache_clear()


@pytest.mark.parametrize("recipe", ["train", "eval"])
def test_image_folder_matches_jax(tmp_path, recipe):
    root = write_tree(str(tmp_path))
    tf = {"train": (ttf.imagenet_train_transform(24),
                    jdata.imagenet_train_transform(24)),
          "eval": (ttf.imagenet_eval_transform(24),
                   jdata.imagenet_eval_transform(24))}[recipe]
    t = tdata.ImageFolder(root, transform=tf[0], seed=3)
    j = jdata.ImageFolder(root, transform=tf[1], seed=3)
    assert t.classes == j.classes == list(CLASSES)
    assert t.samples == j.samples and len(t) == 9
    for epoch in (0, 2):
        t.set_epoch(epoch)
        j.set_epoch(epoch)
        for i in range(len(t)):
            a, b = t[i], j[i]
            assert a["image"].dtype == np.float32
            assert a["image"].shape == (24, 24, 3)
            np.testing.assert_array_equal(a["image"], b["image"])
            assert a["label"] == b["label"]
    plain = tdata.ImageFolder(root)
    assert plain[0]["image"].max() <= 1.0


def test_image_folder_without_pil_says_so(tmp_path, monkeypatch):
    root = write_tree(str(tmp_path), n=1)
    ds = tdata.ImageFolder(root)
    monkeypatch.setitem(__import__("sys").modules, "PIL", None)
    with pytest.raises(ImportError, match="needs PIL"):
        ds[0]


def test_image_folder_refuses_empty_trees(tmp_path):
    with pytest.raises(FileNotFoundError, match="no class"):
        tdata.ImageFolder(str(tmp_path))
    os.makedirs(tmp_path / "a")
    with pytest.raises(FileNotFoundError, match="no images"):
        tdata.ImageFolder(str(tmp_path))


def _cli(extra, capsys):
    trainer = cli_main(["--use-cpu", "--model", "vit_b16", "--model-overrides",
                        SMALL_VIT, "--image-size", "32", "--batch-size", "8",
                        "--steps-per-epoch", "2", "--num-workers", "0",
                        "--optimizer", "adamw", "--learning-rate", "5e-4",
                        "--weight-decay", "0.05", "--grad-clip", "1.0",
                        "--eval", "--eval-steps", "1", *extra])
    out = capsys.readouterr().out
    assert "training started" in out and "training finished" in out
    lines = [ln for ln in out.splitlines() if "examples_per_sec=" in ln]
    assert len(lines) == 1 and "step=2" in lines[0]
    assert "eval_accuracy=" in out
    assert trainer.state.step == 2
    assert np.isfinite(trainer.history[-1]["loss"])
    model = trainer.state.model
    assert model.pos_embed.shape == (1, 5, 64)      # 2 x 2 patches + CLS
    return trainer, out


def test_cli_trains_a_vit_on_packed_records(packed, capsys):
    calls = tnative.crop_resize_flip_u8.calls
    trainer, out = _cli(["--dataset", f"packed-images:{packed}",
                         "--precision", "bf16", "--remat"], capsys)
    assert "warning: no .eval packed file found" in out
    assert tnative.crop_resize_flip_u8.calls >= calls + 2
    assert trainer.state.model.cfg.remat
    assert trainer.state.model.head.weight.shape == (5, 64)


def test_cli_trains_a_vit_on_an_image_folder(tmp_path, capsys):
    root = str(tmp_path / "tree")
    write_tree(os.path.join(root, "train"), n=6)
    write_tree(os.path.join(root, "val"), seed=1, n=2)
    trainer, out = _cli(["--dataset", f"imagefolder:{root}"], capsys)
    assert "warning" not in out
    assert trainer.state.model.head.weight.shape == (3, 64)
