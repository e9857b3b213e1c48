"""The port's device-resident datasets (``data/device_cache.py``,
``data/token_cache.py``) against the JAX package's, on the host.

The port's draws are its own (a ``torch.Generator`` on the cache's
device) and cannot equal JAX's threefry bits, so parity is held where the
draws enter: given JAX's own indices, boxes and flips (drawn here from
JAX's key splits), the port's ``assemble`` is bit-equal to JAX's
``_assemble_body`` in both crop modes and in eval; given JAX's window
starts, ``gather_windows`` is bit-equal to JAX's sampler; ``make_eval_fn``
gives JAX's metrics on converted weights (rtol 1e-5).  The port's own
draws are held to the properties of ``tests/test_device_cache.py`` and
``tests/test_lm_corpus.py``: every index once an epoch, epochs different
and deterministic, crops that are windows of their source, the partial
batch dropped, a step's draws independent of the steps before it, and
the refusals.  Data parallelism: two gloo ranks' rows concatenate to one
process's batch; a group spanning nodes is refused.  The CLI cases of
``tests/test_cli_and_aux.py::test_cli_device_cache`` run on the port's
CLI.
"""

import argparse
import dataclasses
import itertools
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pytorch_distributed_training_tpu.data import device_cache as jdc
from pytorch_distributed_training_tpu.data import (
    DeviceCachedTokens as JaxTokens,
)
from pytorch_distributed_training_tpu.models import create_model as jax_model
from pytorch_distributed_training_tpu.train import (
    create_train_state as jax_state, make_eval_step as jax_eval_step,
)
from pytorch_distributed_training_tpu_torch.cli.main import (
    _device_cache, build_optimizer, build_parser, main as cli_main,
)
from pytorch_distributed_training_tpu_torch.data import (
    DeviceCachedImages, DeviceCachedTokens, SyntheticImages, ShapeImages,
)
from pytorch_distributed_training_tpu_torch.data.device_cache import (
    assemble,
)
from pytorch_distributed_training_tpu_torch.data.lm_corpus import (
    synthesize_token_bin,
)
from pytorch_distributed_training_tpu_torch.data.loader import rank_rows
from pytorch_distributed_training_tpu_torch.data.token_cache import (
    gather_windows,
)
from pytorch_distributed_training_tpu_torch.models import (
    GPT2, GPT2Config, create_model, gpt2_params_from_jax,
)
from pytorch_distributed_training_tpu_torch.resilience import (
    AnomalyPolicy, init_resilience_state,
)
from pytorch_distributed_training_tpu_torch.train import (
    create_train_state, make_eval_step, make_train_step,
)
from tests import torch_dp_worker


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _source(n=32, h=12, w=12, c=3, classes=5, seed=0):
    rng = np.random.default_rng(seed)
    images = rng.integers(0, 255, (n, h, w, c), dtype=np.uint8)
    labels = rng.integers(0, classes, (n,), dtype=np.int32)
    return images, labels


def _cache(images, labels, **kw):
    return DeviceCachedImages((images, labels), device="cpu", **kw)


# --- assembly against JAX's, given JAX's draws --------------------------------

@pytest.mark.parametrize("mode", ["per-batch", "per-sample", "eval"])
def test_assemble_is_bit_equal_to_jax_assemble_body(mode):
    """JAX's ``batches``: idx from its permutation of (seed, epoch), the
    step key ``fold_in(key, step)`` split three ways (``_assemble_body``)
    into the box and the flips; the same values into the port's pure
    ``assemble``."""
    images, labels = _source(n=24, h=14, w=11)
    crop, batch = 8, 6
    train = mode != "eval"
    per_sample = mode == "per-sample"
    h, w = images.shape[1:3]
    key = jax.random.fold_in(jax.random.PRNGKey(3), 1)
    perm = np.asarray(jdc._permute(jnp.asarray(labels), key))
    for step in range(3):
        idx = perm[step * batch:(step + 1) * batch]
        k = jax.random.fold_in(key, step)
        want = jdc._assemble_body(jnp.asarray(images), jnp.asarray(labels),
                                  jnp.asarray(idx), k, crop, train, batch, h,
                                  w, per_sample)
        oy = ox = flip = None
        if train:
            ky, kx, kf = jax.random.split(k, 3)
            shape = (batch,) if per_sample else ()
            oy = jax.random.randint(ky, shape, 0, h - crop + 1)
            ox = jax.random.randint(kx, shape, 0, w - crop + 1)
            flip = jax.random.bernoulli(kf, 0.5, (batch,))
            oy, ox, flip = (torch.from_numpy(np.array(v).reshape(-1))
                            for v in (oy, ox, flip))
        got = assemble(torch.from_numpy(images), torch.from_numpy(labels),
                       torch.from_numpy(idx.astype(np.int64)), oy, ox, flip,
                       crop, train)
        np.testing.assert_array_equal(got["image"].numpy(),
                                      np.asarray(want["image"]))
        np.testing.assert_array_equal(got["label"].numpy(),
                                      np.asarray(want["label"]))
        if train and step == 0:
            assert flip.any() and not flip.all()   # both branches ran


# --- the port's own draws -------------------------------------------------------

def test_epoch_covers_every_index_once():
    images, labels = _source(n=32)
    ds = _cache(images, labels, crop_size=8)
    seen = []
    for b in ds.batches(epoch=0, batch_size=8):
        assert b["image"].shape == (8, 8, 8, 3)
        assert b["image"].dtype == torch.uint8
        assert b["label"].dtype == torch.int32
        seen.extend(b["label"].tolist())
    assert len(seen) == 32
    assert sorted(seen) == sorted(labels.tolist())
    perm = ds.permutation(0)
    assert sorted(perm.tolist()) == list(range(32))


def test_epochs_differ_and_are_deterministic():
    images, labels = _source(n=16)
    ds = _cache(images, labels, crop_size=8, seed=3)
    e0 = [b["image"] for b in ds.batches(0, 8)]
    e0_again = [b["image"] for b in _cache(images, labels, crop_size=8,
                                           seed=3).batches(0, 8)]
    e1 = [b["image"] for b in ds.batches(1, 8)]
    for a, b in zip(e0, e0_again):
        assert torch.equal(a, b)
    assert any(not torch.equal(a, b) for a, b in zip(e0, e1))


def test_a_steps_draws_do_not_depend_on_the_steps_before_it():
    """The CLI's mid-epoch resume skips the consumed steps with
    ``islice``: the steps after it are the uninterrupted epoch's."""
    images, labels = _source(n=40)
    ds = _cache(images, labels, crop_size=8, seed=5)
    full = list(ds.batches(2, 8))
    tail = list(itertools.islice(ds.batches(2, 8), 3, None))
    assert len(tail) == 2
    for a, b in zip(full[3:], tail):
        assert torch.equal(a["image"], b["image"])
        assert torch.equal(a["label"], b["label"])
    # and a step's box and flips are a function of (seed, epoch, step)
    for a, b in zip(ds.draws(2, 4, 8), ds.draws(2, 4, 8)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("per_sample_crop", [False, True])
def test_crops_are_windows_of_source_images(per_sample_crop):
    """Every augmented sample is an axis-aligned crop (possibly flipped)
    of its source record, found by brute force."""
    images, labels = _source(n=8, h=10, w=10)
    labels = np.arange(8, dtype=np.int32)     # the label names the source
    ds = _cache(images, labels, crop_size=6)
    (batch,) = list(ds.batches(0, 8, per_sample_crop=per_sample_crop))
    out, lbl = batch["image"].numpy(), batch["label"].numpy()
    boxes = set()
    for s in range(8):
        src = images[lbl[s]]
        found = [(oy, ox) for oy in range(5) for ox in range(5)
                 if np.array_equal(out[s], src[oy:oy + 6, ox:ox + 6])
                 or np.array_equal(out[s], src[oy:oy + 6, ox:ox + 6][:, ::-1])]
        assert found, f"sample {s} is not a crop/flip of its record"
        boxes.add(found[0])
    if not per_sample_crop:
        assert len(boxes) == 1


def test_eval_center_crop_exact():
    images, labels = _source(n=8, h=10, w=10)
    ds = _cache(images, labels, crop_size=6, train=False)
    (batch,) = list(ds.batches(epoch=0, batch_size=8))
    np.testing.assert_array_equal(batch["image"].numpy(),
                                  images[:, 2:8, 2:8, :])
    np.testing.assert_array_equal(batch["label"].numpy(), labels)


def test_partial_batch_dropped():
    images, labels = _source(n=20)
    ds = _cache(images, labels, crop_size=8)
    assert len(list(ds.batches(0, 8))) == 2   # 20 // 8


def test_rejects_bad_inputs():
    images, labels = _source(n=4, h=8, w=8)
    with pytest.raises(ValueError, match="smaller than crop"):
        _cache(images, labels, crop_size=16)
    with pytest.raises(ValueError, match="uint8"):
        _cache(images.astype(np.float32), labels, crop_size=8)


def test_entry_points_take_the_card_unless_asked(monkeypatch):
    images, labels = _source(n=4, h=8, w=8)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DeviceCachedImages((images, labels), crop_size=8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DeviceCachedTokens(np.arange(64))


@pytest.mark.parametrize("cls", [SyntheticImages, ShapeImages])
def test_record_views_are_the_jax_datasets(cls):
    """``.images`` / ``.labels``: uint8 records of the float samples
    (x 255), equal to the JAX package's views."""
    import pytorch_distributed_training_tpu.data.datasets as jds

    ds, ref = cls(n=12), getattr(jds, cls.__name__)(n=12)
    assert ds.images.dtype == np.uint8 and ds.labels.dtype == np.int32
    np.testing.assert_array_equal(ds.images, ref.images)
    np.testing.assert_array_equal(ds.labels, ref.labels)
    np.testing.assert_array_equal(
        ds.images[3], (ds[3]["image"] * 255.0).astype(np.uint8))


def test_make_epoch_fn_means_floats_and_keeps_the_last_int():
    """The eager epoch loop's reduction: float metrics averaged over the
    steps, integer ones (the gate's counters) the last step's."""
    images, labels = _source(n=16, h=12, w=12, classes=10)
    ds = _cache(images, labels, crop_size=8)
    model = create_model("resnet18", num_classes=10, device="cpu", seed=0,
                         cfg_overrides={"stage_sizes": (1, 1),
                                        "num_filters": 8, "small_stem": True})
    state = create_train_state(model, build_optimizer("adam", 1e-3,
                                                      weight_decay=0.0))
    state = dataclasses.replace(state,
                                resilience=init_resilience_state("cpu"))
    step = make_train_step(kind="image_classifier",
                           input_normalize=(ds.mean, ds.std),
                           anomaly_policy=AnomalyPolicy())
    seen = []

    def recorded(s, b):
        s, m = step(s, b)
        seen.append({k: v.clone() for k, v in m.items()})
        return s, m

    run_epoch = ds.make_epoch_fn(recorded, batch_size=8)
    state, m = run_epoch(state, 0)
    assert state.step == 2 and len(seen) == 2
    assert torch.equal(m["loss"], (seen[0]["loss"] + seen[1]["loss"]) / 2)
    assert m["skipped_total"].dtype == torch.int32
    assert torch.equal(m["skipped_total"], seen[1]["skipped_total"])


# --- data parallelism ------------------------------------------------------------

@pytest.mark.parametrize("micro", [1, 2])
def test_rank_rows_concatenate_to_the_one_process_batch(micro):
    """``rank_rows`` of a batch (a tensor or an array, trailing dims
    kept) is the batch at ``rank_rows`` of its row indices, and the ranks'
    rows together are the batch."""
    t = torch.arange(8 * 3).reshape(8, 3)
    seen = []
    for rank in range(2):
        rows = rank_rows(np.arange(8), rank, 2, micro)
        want = t[torch.from_numpy(rows)]
        assert torch.equal(rank_rows(t, rank, 2, micro), want)
        np.testing.assert_array_equal(rank_rows(t.numpy(), rank, 2, micro),
                                      want.numpy())
        seen.extend(rows.tolist())
    assert sorted(seen) == list(range(8))


def test_gloo_world_2_rows_are_the_world_1_batch(tmp_path):
    """Two gloo ranks build the CLI's caches (images and tokens) and keep
    their rows of each global batch; their rows, dealt back by the
    loader's rule, are one process's batches."""
    out = str(tmp_path / "rows")
    torch_dp_worker.launch([os.path.join("tests", "torch_dp_worker.py"),
                            "cache_rows", out], 2)
    ranks = [np.load(os.path.join(out, f"rank{r}.npz")) for r in range(2)]
    ref = torch_dp_worker.cache_rows(0, 1, None)
    for name, want in ref.items():
        got = np.empty_like(want)
        micro = torch_dp_worker.CACHE_ACCUM
        for r in range(2):
            rows = rank_rows(np.arange(want.shape[1]), r, 2, micro)
            got[:, rows] = ranks[r][name]
        np.testing.assert_array_equal(got, want, err_msg=name)


def test_a_group_across_nodes_is_refused(monkeypatch):
    args = build_parser().parse_args(["--device-cache", "--synthetic-data"])
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "1")
    with pytest.raises(SystemExit, match="single-host"):
        _device_cache(args, SyntheticImages(n=8), "image_classifier", "cpu",
                      rank=0, world=2)


# --- tokens ----------------------------------------------------------------------

def test_window_gather_is_bit_equal_to_jax_sample():
    """JAX's sampler draws its starts from the key; the same starts into
    ``gather_windows`` give its batch (uint16 ids above 2**15 included:
    they are stored as int16 and widened without the sign)."""
    rng = np.random.default_rng(0)
    stream = rng.integers(0, 2**16, 5_000).astype(np.uint16)
    jcache = JaxTokens(stream, seed=3)
    key = jax.random.PRNGKey(7)
    want = np.asarray(jcache.sample_batch_fn(4, 64)(jcache._tokens, key))
    starts = jax.random.randint(key, (4,), 0, stream.size - 64 + 1)
    cache = DeviceCachedTokens(stream, device="cpu")
    assert cache._tokens.dtype == torch.int16 and cache.nbytes == 10_000
    got = gather_windows(cache._tokens,
                         torch.from_numpy(np.asarray(starts, np.int64)), 64)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert int(want.max()) >= 2**15


def test_token_cache_sampling_shapes_and_determinism():
    rng = np.random.default_rng(0)
    stream = rng.integers(0, 500, 10_000).astype(np.uint16)
    cache = DeviceCachedTokens(stream, device="cpu", seed=3)
    b1 = list(cache.batches(0, 4, seq_len=64, steps=3))
    b2 = list(cache.batches(0, 4, seq_len=64, steps=3))
    b3 = list(cache.batches(1, 4, seq_len=64, steps=3))
    for a, b in zip(b1, b2):
        assert a["tokens"].shape == (4, 64)
        assert a["tokens"].dtype == torch.int32
        assert torch.equal(a["tokens"], b["tokens"])
    assert not torch.equal(b1[0]["tokens"], b3[0]["tokens"])
    row = b1[0]["tokens"][0].numpy()
    starts = np.flatnonzero(stream == row[0])
    assert any((stream[s:s + 64] == row).all() for s in starts)
    tail = list(itertools.islice(cache.batches(0, 4, seq_len=64, steps=3),
                                 2, None))
    assert torch.equal(tail[0]["tokens"], b1[2]["tokens"])


def test_last_token_can_be_drawn():
    """Starts are drawn in [0, n - L] inclusive."""
    cache = DeviceCachedTokens(np.arange(9, dtype=np.uint16), device="cpu")
    firsts = {int(b["tokens"][r, 0]) for b in cache.batches(
        0, 8, seq_len=8, steps=8) for r in range(8)}
    assert firsts == {0, 1}


def test_wide_ids_are_kept_as_given():
    stream = np.array([-1, 70_000, 3, 4, 5], np.int64)
    cache = DeviceCachedTokens(stream, device="cpu")
    assert cache._tokens.dtype == torch.int64
    starts = torch.tensor([0, 1])
    assert gather_windows(cache._tokens, starts, 2).tolist() == [
        [-1, 70_000], [70_000, 3]]


def _tiny_lm():
    cfg = dict(num_layers=2, hidden_dim=32, num_heads=2, vocab_size=512,
               max_seq_len=64)
    jm = jax_model("gpt2", cfg_overrides=cfg)
    state = jax_state(jm, jax.random.PRNGKey(0), jnp.zeros((1, 64),
                                                             jnp.int32),
                      optax.adam(1e-2), init_kwargs={"train": False})
    model = GPT2(GPT2Config(**cfg))
    model.load_state_dict(gpt2_params_from_jax(
        jax.tree_util.tree_map(np.asarray, state.params)))
    return state, create_train_state(
        model, build_optimizer("adam", 1e-2, weight_decay=0.0))


def test_eval_fn_gives_jax_metrics_on_converted_weights():
    stream = np.tile(np.arange(16, dtype=np.uint16), 200)   # 3200 tokens
    jstate, state = _tiny_lm()
    for max_batches in (None, 2):
        want = JaxTokens(stream, seed=0).make_eval_fn(
            jax_eval_step(kind="lm"), batch_size=4, seq_len=64,
            max_batches=max_batches)(jstate)
        got = DeviceCachedTokens(stream, device="cpu").make_eval_fn(
            make_eval_step(kind="lm"), batch_size=4, seq_len=64,
            max_batches=max_batches)(state)
        np.testing.assert_allclose(float(got["loss"]), float(want["loss"]),
                                   rtol=1e-5)


def test_train_fn_stacks_metrics_learns_and_chains():
    stream = np.tile(np.arange(16, dtype=np.uint16), 2000)
    _, state = _tiny_lm()
    cache = DeviceCachedTokens(stream, device="cpu", seed=0)
    run = cache.make_train_fn(make_train_step(kind="lm"), batch_size=4,
                              seq_len=64, steps_per_call=5)
    state, m0 = run(state, 0)
    state, m1 = run(state, 1)
    assert m0["loss"].shape == (5,)
    assert float(m1["loss"][-1]) < float(m0["loss"][0])
    assert state.step == 10


def test_token_cache_rejects_bad_streams():
    with pytest.raises(ValueError):
        DeviceCachedTokens(np.zeros((2, 2), np.uint16), device="cpu")
    with pytest.raises(ValueError):
        DeviceCachedTokens(np.zeros(1, np.uint16), device="cpu")
    cache = DeviceCachedTokens(np.arange(32, dtype=np.uint16), device="cpu")
    with pytest.raises(ValueError):
        cache.sample_batch_fn(2, 64)    # corpus shorter than seq
    with pytest.raises(ValueError):
        cache.make_eval_fn(make_eval_step(kind="lm"), batch_size=4,
                           seq_len=16)
    with pytest.raises(ValueError, match="seq_len"):
        next(cache.batches(0, 2))


# --- the CLI ---------------------------------------------------------------------

def test_cli_device_cache(capsys):
    """``tests/test_cli_and_aux.py::test_cli_device_cache`` on the port:
    the cached run trains; an LM dataset without a token stream is
    refused with JAX's message."""
    trainer = cli_main(["--use-cpu", "--synthetic-data", "--device-cache",
                        "--batch-size", "8", "--num-workers", "0",
                        "--learning-rate", "0.001", "--steps-per-epoch", "2",
                        "--model-overrides", "num_filters=8,small_stem=true"])
    assert "training finished" in capsys.readouterr().out
    assert trainer.state.step == 2
    with pytest.raises(SystemExit, match="token-stream dataset"):
        cli_main(["--use-cpu", "--model", "gpt2", "--dataset",
                  "synthetic-tokens", "--device-cache", "--batch-size", "8",
                  "--seq-len", "32", "--model-overrides",
                  "num_layers=1,hidden_dim=32,num_heads=2,vocab_size=64"])


def test_cli_token_file_cache_trains_and_evaluates(tmp_path, capsys):
    """An LM run on a token file through the cache (with the eval split
    as a Subset, whose token range the cache takes), two microbatches."""
    path = str(tmp_path / "train.bin")
    synthesize_token_bin(path, n_tokens=20_000, vocab_size=64, seed=0)
    trainer = cli_main([
        "--use-cpu", "--model", "gpt2", "--dataset", f"token-file:{path}",
        "--seq-len", "16", "--model-overrides",
        "num_layers=1,hidden_dim=32,num_heads=2,vocab_size=64,"
        "max_seq_len=32", "--batch-size", "8", "--accum-steps", "2",
        "--steps-per-epoch", "3", "--device-cache", "--eval",
        "--eval-steps", "2", "--num-workers", "0"])
    out = capsys.readouterr().out
    assert "eval_loss=" in out and "training finished" in out
    assert trainer.state.step == 3


def test_cli_warns_when_the_records_are_smaller_than_the_image_size(capsys):
    args = build_parser().parse_args(["--device-cache", "--dataset",
                                      "shapes", "--image-size", "40"])
    cache = _device_cache(args, ShapeImages(n=16), "image_classifier", "cpu",
                          rank=0, world=1)
    assert cache.crop_size == 32
    assert "stored record resolution 32px" in capsys.readouterr().err
    bad = argparse.Namespace(**{**vars(args), "dataset": "imagefolder:x"})
    with pytest.raises(SystemExit, match="uint8 records"):
        _device_cache(bad, object(), "image_classifier", "cpu", 0, 1)
