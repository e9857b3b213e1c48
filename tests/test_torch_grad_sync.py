"""The two-tier gradient sync of the PyTorch port (``--grad-sync``)
against the JAX package, on the CPU with gloo.

- Codecs, bit-exact with JAX on seeded inputs: int8, int4, top-k (ties
  and zero padding included), the bit packing and ``topk_k``; the byte
  model equal to each payload's ``nbytes``; ``auto_bucket_mb`` equal to
  JAX's at JAX's link constants; ``_BucketLayout``'s shape equal to
  JAX's; twins of ``tests/test_compress.py`` (codecs, byte model, sizer),
  ``tests/test_striping.py`` (stripe resolution and splitting, the ICI
  byte model, the sizer's pipelined regime, the CLI refusals) and
  ``tests/test_hier_sync.py`` (layout round trip, the DCN byte model,
  the sizer's policy in ``GradSync``).
- Four gloo ranks (``tests/torch_dp_worker.py``, one launch a family):
  ``all_gather``, ``reduce_scatter``, ``ppermute`` and ``all_to_all`` in
  f32, bf16 and uint8 against numpy; ``split_slice_groups`` at (S, L) in
  {(2, 2), (4, 1), (1, 4)}; the bucket sync (``GradSync._sync_buckets``)
  bitwise JAX's under ``shard_map`` on the 2-slice mesh of 4 devices for
  every mode x stripe {off, 2} x ``phase_overlap`` {off, on}; one train
  step per mode on ``tools/grad_sync_diag.py``'s tiny GPT-2 from JAX's
  weights against JAX's step (loss within 1e-5, parameters within 10 x
  JAX's ``PARAM_ATOL``; the leaves are laid out in another order, so
  quantized buckets differ), accumulation 4 with overlap within 1e-4,
  the error-feedback residual non-zero and fed back; the residual
  bitwise through a skipped step, restored by a rollback and restored
  as zeros from a checkpoint (JAX's behaviour).
- The CLI: JAX's refusals (exit 2), and torchrun runs of four CPU ranks
  (``--grad-sync-slices 2``) and of two nodes of two (the slice count
  detected).

Every multi-process launch has its own limit of at most 120 s, and the
ranks meet at a barrier before they leave the group.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from pytorch_distributed_training_tpu.comm import (
    GradSync as JaxGradSync, GradSyncConfig as JaxGradSyncConfig,
    MeshConfig, make_hybrid_mesh,
)
from pytorch_distributed_training_tpu.comm import compress as jcomp
from pytorch_distributed_training_tpu.comm import striping as jstripe
from pytorch_distributed_training_tpu.comm.hierarchical import (
    dcn_bytes_per_sync as jax_dcn_bytes,
)
from pytorch_distributed_training_tpu.compat import shard_map
from pytorch_distributed_training_tpu.parallel.sharding import shard_batch
from pytorch_distributed_training_tpu_torch.cli.main import main as cli_main
from pytorch_distributed_training_tpu_torch.comm import (
    GradSync, GradSyncConfig, collectives, resolve_stripe, split_stripes,
)
from pytorch_distributed_training_tpu_torch.comm import compress as tcomp
from pytorch_distributed_training_tpu_torch.comm import striping as tstripe
from pytorch_distributed_training_tpu_torch.comm.hierarchical import (
    dcn_bytes_per_sync,
)
from pytorch_distributed_training_tpu_torch.models import (
    gpt2_params_from_jax, gpt2_params_to_jax,
)
from tests.test_torch_multinode import _launch as launch_nodes
from tests.test_torch_train import _assert_params_close
from tests.torch_shared import shared
from tests.torch_dp_worker import (
    REPO, SLICE_SHAPES, STEP_RUNS, SYNC_BUCKET_MB, SYNC_MODES,
    SYNC_TOTAL, SYNC_VARIANTS, WIRE_DTYPES, collective_input, launch,
    sync_inputs,
)

# JAX's documented tolerances (tests/test_hier_sync.py:39-44).
GRAD_ATOL = {
    "hier": 1e-6, "hier-bf16": 5e-3, "hier-int8": 2e-2, "hier-int4": 5e-2,
}
PARAM_ATOL = {**GRAD_ATOL, "hier-topk": 2e-2}
WORLD = 4
LR = 1e-3      # tools/grad_sync_diag.py's adam


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rand(rows=3, cols=64, seed=0, scale=2.0):
    return (np.random.default_rng(seed).normal(size=(rows, cols))
            * scale).astype(np.float32)


def _np(x):
    """A JAX or torch array as numpy (bf16 widened to f32)."""
    if isinstance(x, torch.Tensor):
        return x.float().numpy() if x.dtype == torch.bfloat16 else x.numpy()
    x = np.asarray(x)
    return x.astype(np.float32) if x.dtype == jnp.bfloat16 else x


def _same(a, b) -> bool:
    a, b = _np(a), _np(b)
    return a.shape == b.shape and a.dtype == b.dtype and np.array_equal(a, b)


def _codec_inputs():
    """Seeded rows, one of rounded values (magnitude ties) and one zero
    tail (a padded bucket)."""
    x = _rand(rows=6, cols=64, seed=11)
    x[1] = np.round(x[1])
    x[2, 24:] = 0.0
    x[3] = np.tile([1.0, -1.0, 0.5, -0.5], 16)
    return x


# --- codecs, bitwise against JAX ---------------------------------------------

@pytest.mark.parametrize("codec", ["int8", "int4"])
def test_scaled_codecs_bitwise_jax(codec):
    x = _codec_inputs()
    enc_j = getattr(jcomp, f"encode_{codec}")(jnp.asarray(x))
    enc_t = getattr(tcomp, f"encode_{codec}")(torch.from_numpy(x))
    for a, b in zip(enc_j, enc_t):
        assert _same(a, b)
    dec_j = getattr(jcomp, f"decode_{codec}")(*enc_j)
    dec_t = getattr(tcomp, f"decode_{codec}")(*enc_t)
    assert _same(dec_j, dec_t)


@pytest.mark.parametrize("frac", [0.01, 0.1, 0.125, 0.5, 1.0])
def test_topk_codec_bitwise_jax_with_ties_and_padding(frac):
    x = _codec_inputs()
    enc_j = jcomp.encode_topk(jnp.asarray(x), frac)
    enc_t = tcomp.encode_topk(torch.from_numpy(x), frac)
    for a, b in zip(enc_j, enc_t):
        assert _same(a, b)
    assert _same(jcomp.decode_topk(*enc_j, 64),
                 tcomp.decode_topk(*enc_t, 64))


def test_bit_packing_bitwise_jax():
    mask = np.random.default_rng(3).random((5, 48)) < 0.3
    packed_j = jcomp._pack_bits(jnp.asarray(mask))
    packed_t = tcomp._pack_bits(torch.from_numpy(mask))
    assert _same(packed_j, packed_t)
    assert _same(jcomp._unpack_bits(packed_j, 48),
                 tcomp._unpack_bits(packed_t, 48))


def test_topk_k_equals_jax():
    for cols in (1, 7, 8, 64, 1000, 4096):
        for frac in (0.001, 0.05, 0.1, 0.5, 1.0):
            assert tcomp.topk_k(cols, frac) == jcomp.topk_k(cols, frac)


# --- twins of tests/test_compress.py:46-176 ----------------------------------

def test_int8_roundtrip_error_bounded_by_scale():
    x = torch.from_numpy(_rand())
    q, s = tcomp.encode_int8(x)
    assert q.dtype == torch.int8 and s.shape == (3, 1)
    err = (tcomp.decode_int8(q, s) - x).abs()
    assert bool((err <= s * 0.5 + 1e-7).all())


def test_int4_pack_unpack_matches_reference():
    x = _rand(seed=1)
    p, s = tcomp.encode_int4(torch.from_numpy(x))
    assert p.dtype == torch.uint8 and p.shape == (3, 32)
    assert s.dtype == torch.bfloat16
    d = tcomp.decode_int4(p, s).numpy()
    sf = s.float().numpy()
    ref = np.clip(np.round(x / sf), -7, 7) * sf
    np.testing.assert_allclose(d, ref, rtol=1e-6, atol=1e-6)
    assert (np.abs(d - x) <= sf * 0.5 + 1e-6).all()


def test_topk_selects_magnitude_topk_and_orders_by_position():
    x = _rand(seed=2)
    frac = 0.125
    k = tcomp.topk_k(64, frac)
    bitmap, q, s = tcomp.encode_topk(torch.from_numpy(x), frac)
    assert bitmap.shape == (3, 8) and q.shape == (3, k)
    d = tcomp.decode_topk(bitmap, q, s, 64).numpy()
    sf = s.float().numpy()
    for r in range(3):
        top = set(np.argsort(-np.abs(x[r]))[:k])
        assert set(np.flatnonzero(d[r])) == top
        idx = sorted(top)
        np.testing.assert_allclose(d[r][idx], x[r][idx],
                                   atol=sf[r, 0] * 0.5 + 1e-6)


def test_topk_k_floor_and_clamp():
    assert tcomp.topk_k(64, 0.1) == 6
    assert tcomp.topk_k(8, 0.01) == 1
    assert tcomp.topk_k(8, 1.0) == 8


def test_bucket_wire_bytes_match_encoder_payloads():
    cols = 64
    x = torch.from_numpy(_rand(rows=1, cols=cols))

    def nbytes(ts):
        return sum(t.numel() * t.element_size() for t in ts)

    assert tcomp.bucket_wire_bytes(cols, "int8") == nbytes(
        tcomp.encode_int8(x))
    assert tcomp.bucket_wire_bytes(cols, "int4") == nbytes(
        tcomp.encode_int4(x))
    for frac in (0.05, 0.1, 0.5):
        assert tcomp.bucket_wire_bytes(cols, "topk", topk_frac=frac) == \
            nbytes(tcomp.encode_topk(x, frac))
    assert tcomp.bucket_wire_bytes(cols, "bf16") == cols * 2
    assert tcomp.bucket_wire_bytes(cols, "f32") == cols * 4
    for codec in tcomp.CODECS:
        for c in (8, 64, 4096):
            assert tcomp.bucket_wire_bytes(c, codec) == \
                jcomp.bucket_wire_bytes(c, codec)
    with pytest.raises(ValueError):
        tcomp.bucket_wire_bytes(cols, "nope")


def test_auto_bucket_mb_bounds_and_mode_scaling():
    """At the port's own link constants (the H100 node's)."""
    total = 4 * 124_439_808
    hier = tcomp.auto_bucket_mb(total, mode="hier")
    bf16 = tcomp.auto_bucket_mb(total, mode="hier-bf16")
    expect = 10.0 * tcomp.LINK_LATENCY_S * tcomp.LINK_BYTES_PER_S / (1 << 20)
    assert hier == pytest.approx(expect, rel=0.01)
    assert bf16 == pytest.approx(2 * hier, rel=0.01)
    assert tcomp.auto_bucket_mb(total, mode="hier-int8") == pytest.approx(
        4 * hier, rel=0.01)
    assert tcomp.auto_bucket_mb(total, mode="hier-int4") == 64.0
    tiny = tcomp.auto_bucket_mb(400_000, mode="hier")
    assert tiny == pytest.approx(400_000 / (1 << 20), rel=0.01)
    capped = tcomp.auto_bucket_mb(total, mode="hier", microbatch_flops=1e11,
                                  peak_flops=1e15)
    assert capped < hier
    with pytest.raises(ValueError):
        tcomp.auto_bucket_mb(total, mode="nope")


@pytest.mark.parametrize("phase_overlap", [False, True])
@pytest.mark.parametrize("mode", SYNC_MODES)
def test_auto_bucket_mb_equals_jax_at_jax_constants(mode, phase_overlap):
    link = dict(latency_s=jcomp.DCN_LATENCY_S,
                dcn_bytes_per_s=jcomp.DCN_BYTES_PER_S)
    for total in (1024, 400_000, 12 << 20, 4 * 124_439_808, 4 * 774_030_080):
        for flops in (None, (1e12, 1e15), (1e14, 9.89e14)):
            kw = dict(mode=mode, phase_overlap=phase_overlap, topk_frac=0.1)
            if flops:
                kw.update(microbatch_flops=flops[0], peak_flops=flops[1])
            assert tcomp.auto_bucket_mb(total, **kw, **link) == \
                jcomp.auto_bucket_mb(total, **kw), (total, flops)


# --- the bucket layout -------------------------------------------------------

def test_bucket_layout_shape_equals_jax():
    for total in (13, 1000, 3000, 124_439_808):
        for bucket_mb in (2e-5, 0.002, 0.5, 42.725):
            for divisor in (1, 4, 8, 32):
                lt = tcomp._BucketLayout.build(
                    {"w": torch.empty(total, device="meta")},
                    bucket_mb=bucket_mb, divisor=divisor)
                lj = jcomp._BucketLayout.build(
                    {"w": jax.ShapeDtypeStruct((total,), jnp.float32)},
                    bucket_mb=bucket_mb, divisor=divisor)
                assert (lt.n_buckets, lt.bucket_elems) == \
                    (lj.n_buckets, lj.bucket_elems)


def test_bucket_layout_roundtrip():
    tree = {"a": torch.arange(13.0), "b.w": torch.arange(24.0).view(4, 6),
            "b.s": torch.ones(())}
    layout = tcomp._BucketLayout.build(tree, bucket_mb=2e-5, divisor=8)
    assert layout.n_buckets > 1 and layout.bucket_elems % 8 == 0
    buckets = layout.flatten(tree)
    assert buckets.shape == (layout.n_buckets, layout.bucket_elems)
    out = layout.unflatten(buckets)
    assert list(out) == list(tree)
    for k in tree:
        assert torch.equal(out[k], tree[k])
    assert torch.equal(layout.flatten(list(tree.values())), buckets)


# --- twins of tests/test_striping.py:51-141 and :201-241 ---------------------

def test_resolve_stripe_values():
    kw = dict(ici_size=4, n_slices=2)
    assert resolve_stripe("off", **kw) == 1
    assert resolve_stripe(None, **kw) == 1
    assert resolve_stripe(1, **kw) == 1
    assert resolve_stripe("auto", **kw) == 4
    assert resolve_stripe("auto", ici_size=2, n_slices=2) == 2
    assert resolve_stripe("auto", ici_size=8, n_slices=2) == 4
    assert resolve_stripe(3, **kw) == 3
    assert resolve_stripe("2", **kw) == 2


def test_resolve_stripe_single_slice_degrades_to_serial():
    assert resolve_stripe("auto", ici_size=8, n_slices=1) == 1
    assert resolve_stripe(4, ici_size=8, n_slices=1) == 1


def test_resolve_stripe_validation():
    with pytest.raises(ValueError, match=">= 1"):
        resolve_stripe(0, ici_size=4, n_slices=2)
    with pytest.raises(ValueError, match="exceeds the ICI"):
        resolve_stripe(5, ici_size=4, n_slices=2)


def test_split_stripes_partitions_exactly():
    x = torch.arange(2 * 11.0).view(2, 11)
    parts = split_stripes(x, 4)
    assert [p.shape[-1] for p in parts] == [3, 3, 3, 2]
    assert torch.equal(torch.cat(parts, dim=-1), x)
    jparts = jstripe.split_stripes(jnp.asarray(x.numpy()), 4)
    for a, b in zip(parts, jparts):
        assert _same(a, b)


def test_split_stripes_never_empty():
    assert [tuple(p.shape) for p in split_stripes(torch.ones(3, 1), 4)] \
        == [(3, 1)]
    assert len(split_stripes(torch.ones(2, 3), 4)) == 3


def test_ici_bytes_rs_ag_phases():
    phase = 2 * 3 * 1024 * 4
    assert tstripe.ici_bytes_per_sync(1024, 2, 4, "hier") == 2 * phase
    assert tstripe.ici_bytes_per_sync(1024, 2, 4, "hier", zero1=True) == phase
    assert tstripe.ici_bytes_per_sync(1024, 2, 1, "hier") == 0


def test_ici_bytes_stripe_rotations_add_wire_share():
    base = tstripe.ici_bytes_per_sync(4096, 2, 4, "hier-int8", n_buckets=2)
    striped = tstripe.ici_bytes_per_sync(4096, 2, 4, "hier-int8",
                                         n_buckets=2, stripe=4)
    wire = 2 * tcomp.bucket_wire_bytes((4096 // 4) // 2, "int8")
    assert striped - base == 2 * 2 * 4 * (wire * 3 // 4)
    assert tstripe.ici_bytes_per_sync(4096, 2, 4, "hier-int8",
                                      stripe=1) == base
    assert tstripe.ici_bytes_per_sync(4096, 1, 4, "hier-int8", stripe=4) \
        == tstripe.ici_bytes_per_sync(4096, 1, 4, "hier-int8")


def test_ici_bytes_rejects_unknown_mode():
    with pytest.raises(ValueError, match="unknown grad-sync mode"):
        tstripe.ici_bytes_per_sync(1024, 2, 4, "nope")


@pytest.mark.parametrize("mode", SYNC_MODES)
def test_byte_models_equal_jax(mode):
    for n, s, l, nb in ((1 << 20, 2, 4, 8), (3000, 2, 2, 3), (4096, 4, 1, 2),
                        (1 << 16, 1, 4, 1)):
        for stripe in (1, 2, 4):
            kw = dict(n_buckets=nb, topk_frac=0.1)
            assert tstripe.ici_bytes_per_sync(n, s, l, mode, stripe=stripe,
                                              **kw) == \
                jstripe.ici_bytes_per_sync(n, s, l, mode, stripe=stripe, **kw)
        assert dcn_bytes_per_sync(n, s, l, mode, **kw) == \
            jax_dcn_bytes(n, s, l, mode, **kw)


@pytest.mark.parametrize("mode", ["hier", "hier-int8", "hier-topk"])
def test_auto_bucket_phase_overlap_keeps_three_in_flight(mode):
    total_bytes = 124 * (1 << 20)
    mb_serial = tcomp.auto_bucket_mb(total_bytes, mode=mode)
    mb_pipe = tcomp.auto_bucket_mb(total_bytes, mode=mode, phase_overlap=True)
    assert mb_pipe <= mb_serial
    assert -(-(total_bytes / (1 << 20)) // mb_pipe) >= 3


def test_auto_bucket_phase_overlap_tiny_model_floor():
    assert tcomp.auto_bucket_mb(1024, mode="hier", phase_overlap=True) >= 1e-3


# --- twins of tests/test_hier_sync.py:290-350 --------------------------------

def test_dcn_bytes_int8_at_least_3x_below_flat():
    n, s, l = 1 << 20, 2, 4
    flat = dcn_bytes_per_sync(n, s, l, "flat")
    assert flat == dcn_bytes_per_sync(n, s, l, "hier")
    assert dcn_bytes_per_sync(n, s, l, "hier-bf16") * 2 == pytest.approx(
        flat, rel=0.01)
    assert flat >= 3 * dcn_bytes_per_sync(n, s, l, "hier-int8")
    assert dcn_bytes_per_sync(n, 1, 8, "flat") == 0


def test_dcn_bytes_int4_and_topk_ratios():
    n, s, l = 1 << 20, 2, 4
    flat = dcn_bytes_per_sync(n, s, l, "flat")
    int4 = dcn_bytes_per_sync(n, s, l, "hier-int4", n_buckets=8)
    topk = dcn_bytes_per_sync(n, s, l, "hier-topk", n_buckets=8)
    assert flat >= 7.9 * int4 and flat >= 15 * topk
    assert dcn_bytes_per_sync(n, s, l, "hier-topk", n_buckets=8,
                              topk_frac=0.05) < topk
    assert dcn_bytes_per_sync(n, s, l, "hier-int4", n_buckets=64) > int4


def test_grad_sync_config_checks():
    with pytest.raises(ValueError, match="auto"):
        GradSyncConfig(mode="hier", bucket_mb="big")
    with pytest.raises(ValueError, match="bucket_mb"):
        GradSyncConfig(mode="hier", bucket_mb=-1.0)
    with pytest.raises(ValueError, match="topk_frac"):
        GradSyncConfig(mode="hier-topk", topk_frac=0.0)
    with pytest.raises(ValueError, match="not in"):
        GradSyncConfig(mode="ring")
    with pytest.raises(ValueError, match="lane count"):
        GradSyncConfig(stripe="wide")
    with pytest.raises(ValueError, match=">= 1"):
        GradSyncConfig(stripe=0)
    assert GradSyncConfig(stripe="3").stripe == 3


def test_grad_sync_refuses_flat_and_zero1():
    # ZeRO-1 is ported: it is refused only where every hier mode is, on
    # a trivial axis (the four-rank steps in test_torch_parallel.py run
    # it).
    params = {"w": torch.zeros(8)}
    with pytest.raises(ValueError, match="mode='flat'"):
        GradSync(None, params, GradSyncConfig(mode="flat"))
    with pytest.raises(ValueError, match="trivial axis"):
        GradSync(None, params, GradSyncConfig(mode="hier", zero1=True))


def test_groups_and_perms_refuse_empty_or_duplicate_members():
    with pytest.raises(ValueError, match="empty group"):
        collectives.new_group([])
    with pytest.raises(ValueError, match="duplicate"):
        collectives.new_group([0, 1, 1])
    with pytest.raises(ValueError, match="repeats"):
        collectives.ppermute(torch.zeros(2), None, [(0, 1), (1, 1)])


# --- collectives on four gloo ranks ------------------------------------------

def _ranks(tmp_path_factory, task: str) -> list:
    out = tmp_path_factory.mktemp(task)
    launch(["tests/torch_dp_worker.py", task, str(out)], WORLD,
           timeout=120)
    return [dict(np.load(out / f"rank{r}.npz")) for r in range(WORLD)]


@pytest.fixture(scope="module")
def collectives_ranks(request, tmp_path_factory):
    return shared(request, tmp_path_factory, "torch_grad_sync_collectives4",
                  lambda: _ranks(tmp_path_factory, "collectives4"))


def _expected(op: str, xs: list, rank: int) -> np.ndarray:
    n = len(xs)
    if op in ("ag0", "ag_async"):
        return np.concatenate(xs, axis=0)
    if op == "ag1":
        return np.concatenate(xs, axis=1)
    if op == "ag_stack":
        return np.stack(xs, axis=1)
    if op == "rs0":
        return np.split(sum(xs), n, axis=0)[rank]
    if op == "rs1":
        return np.split(sum(np.tile(x, 2)[:, :8] for x in xs), n,
                        axis=1)[rank]
    if op == "perm_ring":
        return xs[(rank - 1) % n]
    if op == "perm_part":
        return {2: xs[0], 3: xs[3]}.get(rank, np.zeros_like(xs[0]))
    if op == "a2a":
        return np.concatenate([np.split(x, n, axis=0)[rank] for x in xs],
                              axis=1)
    raise KeyError(op)


@pytest.mark.parametrize("op", ["ag0", "ag1", "ag_stack", "rs0", "rs1",
                                "perm_ring", "perm_part", "a2a", "ag_async"])
@pytest.mark.parametrize("dtype", WIRE_DTYPES)
def test_collectives_on_four_ranks_equal_numpy(collectives_ranks, dtype, op):
    xs = [collective_input(r, dtype) for r in range(WORLD)]
    for r, res in enumerate(collectives_ranks):
        np.testing.assert_array_equal(res[f"{dtype}/{op}"],
                                      _expected(op, xs, r), err_msg=str(r))


def test_int16_payload_moves_as_bytes(collectives_ranks):
    want = np.concatenate([collective_input(r, "int16")
                           for r in range(WORLD)])
    for res in collectives_ranks:
        np.testing.assert_array_equal(res["int16/ag0"], want)


# --- the slice split ---------------------------------------------------------

@pytest.fixture(scope="module")
def slice_ranks(request, tmp_path_factory):
    return shared(request, tmp_path_factory, "torch_grad_sync_slices",
                  lambda: _ranks(tmp_path_factory, "slices"))


@pytest.mark.parametrize("shape", SLICE_SHAPES)
def test_split_slice_groups(slice_ranks, shape):
    s, l = shape
    for r, res in enumerate(slice_ranks):
        key = f"{s}x{l}"
        slice_index, lane = r // l, r % l
        ici = [slice_index * l + i for i in range(l)]
        dcn = [j * l + lane for j in range(s)]
        assert res[key].tolist() == [s, l, slice_index, lane, sum(ici),
                                     sum(dcn)]
        assert res[key + "/ici"].tolist() == ici
        assert res[key + "/dcn"].tolist() == dcn


def test_split_slice_groups_refuses_indivisible_and_trivial(slice_ranks):
    for res in slice_ranks:
        assert str(res["indivisible"]) == (
            "axis 'data' (size 4) not divisible into 3 slices")
        assert "needs size > 1" in str(res["trivial"])


# --- the bucket sync against JAX's -------------------------------------------

@pytest.fixture(scope="module")
def mesh4():
    return make_hybrid_mesh(MeshConfig(data=-1), devices=jax.devices()[:4],
                            n_slices=2)


@pytest.fixture(scope="module")
def bucket_ranks(request, tmp_path_factory):
    return shared(request, tmp_path_factory, "torch_grad_sync_bucket_sync",
                  lambda: _ranks(tmp_path_factory, "bucket_sync"))


def _jax_sync_buckets(mesh, mode, stripe, overlap):
    sync = JaxGradSync(mesh, {"w": jnp.zeros(SYNC_TOTAL)}, JaxGradSyncConfig(
        mode=mode, n_slices=2, bucket_mb=SYNC_BUCKET_MB, stripe=stripe,
        phase_overlap=overlap))
    lay = sync.layout
    ins = [sync_inputs(r, lay.n_buckets, lay.bucket_elems,
                       lay.bucket_elems // sync.ici_size)
           for r in range(WORLD)]
    buckets = np.stack([b for b, _ in ins])
    resid = np.stack([r for _, r in ins])
    axes = (sync.dcn_axis, sync.ici_axis)

    def local(b, r):
        out, nr = sync._sync_buckets(b[0], r[0] if sync.has_residual else ())
        return out[None], (nr[None] if sync.has_residual
                           else jnp.zeros((1, 1), jnp.float32))

    fn = shard_map(local, mesh=sync.smesh, in_specs=(P(axes), P(axes)),
                   out_specs=(P(axes), P(axes)), check_vma=False)
    out, nr = jax.jit(fn)(buckets, resid)
    return sync, np.asarray(out), np.asarray(nr), ins


# XLA:CPU rewrites hier-int8's f32 arithmetic inside the jitted sync: the
# scale's division by 127 becomes a multiplication by 1/127 (the f32
# scale then differs by an ulp in some rows, and a value on a rounding
# boundary may take the next int8 step), and the products ``q * scale``
# are contracted into fused multiply-adds in the residual ``err - q *
# scale`` and in the decoded sum ``q_0 * scale_0 + q_1 * scale_1``, one
# rounding where the port makes two.  int4 and top-k divide by a bf16
# scale, which blocks the rewrite, and their products are exact in f32
# (integers of at most 8 bits times 8-bit bf16 mantissas), so they stay
# bitwise.  hier-int8 is held to one quantization step of each payload.
FMA_CONTRACTED = {"hier-int8"}


def _within_one_step(got, want, step) -> bool:
    return bool((np.abs(got - want) <= step).all())


def _int8_steps(sync, ins):
    """Each rank's residual step (its row's ``max|err| / 127``) and
    output step (one step of each slice's payload, summed), from the
    inputs: ``err`` is the lane's columns of its slice's mean partial
    plus the residual."""
    lay, l = sync.layout, sync.ici_size
    shard = lay.bucket_elems // l
    steps = {}
    for r in range(WORLD):
        s, lane = divmod(r, l)
        part = sum(ins[s * l + i][0] * np.float32(1 / WORLD)
                   for i in range(l))[:, lane * shard:(lane + 1) * shard]
        steps[r] = np.abs(part + ins[r][1]).max(axis=1, keepdims=True) / 127
    # After the all-gather every rank holds every lane's block.
    out = np.concatenate([
        np.repeat(sum(steps[j * l + lane] for j in range(sync.n_slices)),
                  shard, axis=1) for lane in range(l)], axis=1)
    return steps, out


@pytest.mark.parametrize("stripe,overlap", SYNC_VARIANTS)
@pytest.mark.parametrize("mode", SYNC_MODES)
def test_bucket_sync_bitwise_jax(mesh4, bucket_ranks, mode, stripe, overlap):
    """Outputs and new residuals bitwise: two members per reduction, so
    no order of summation can differ; ``hier-int8`` within one
    quantization step (``FMA_CONTRACTED``)."""
    sync, out, resid, ins = _jax_sync_buckets(mesh4, mode, stripe, overlap)
    key = f"{mode}/{stripe}/{int(overlap)}"
    if mode in FMA_CONTRACTED:
        resid_step, out_step = _int8_steps(sync, ins)
    for r, res in enumerate(bucket_ranks):
        assert res[key + "/layout"].tolist() == [
            sync.layout.n_buckets, sync.layout.bucket_elems, sync.stripe]
        if mode in FMA_CONTRACTED:
            assert _within_one_step(res[key], out[r], out_step), (key, r)
            assert _within_one_step(res[key + "/resid"], resid[r],
                                    resid_step[r]), (key, r)
            continue
        assert np.array_equal(res[key], out[r]), (key, r)
        if sync.has_residual:
            assert np.array_equal(res[key + "/resid"], resid[r]), (key, r)


def test_striped_pipelined_bucket_sync_bitwise_serial(bucket_ranks):
    for mode in SYNC_MODES:
        for res in bucket_ranks:
            serial = res[f"{mode}/off/0"]
            for stripe, overlap in SYNC_VARIANTS[1:]:
                assert np.array_equal(res[f"{mode}/{stripe}/{int(overlap)}"],
                                      serial)


# --- train steps against JAX's -----------------------------------------------

def _jax_run(mesh, mode, accum, steps):
    from tools.grad_sync_diag import tiny_lm_setup

    state, step, batch, _ = tiny_lm_setup(mesh, mode, accum)
    with mesh:
        for _ in range(steps):
            state, metrics = step(state, shard_batch(batch, mesh))
    return float(metrics["loss"]), jax.tree_util.tree_map(np.asarray,
                                                          state.params), state


@pytest.fixture(scope="module")
def step_ranks(request, tmp_path_factory, mesh4):
    def compute():
        from tools.grad_sync_diag import tiny_lm_setup

        out = tmp_path_factory.mktemp("grad_sync_steps")
        state, _, _, _ = tiny_lm_setup(mesh4, "flat")
        init = gpt2_params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                           state.params))
        np.savez(out / "init.npz",
                 **{k: v.numpy() for k, v in init.items()})
        launch(["tests/torch_dp_worker.py", "grad_sync_steps", str(out)],
               WORLD, timeout=120)
        return [dict(np.load(out / f"rank{r}.npz")) for r in range(WORLD)]

    return shared(request, tmp_path_factory, "torch_grad_sync_steps",
                  compute)


def _port_params(res: dict, label: str):
    prefix = f"{label}/p/"
    return gpt2_params_to_jax({k[len(prefix):]: torch.from_numpy(v)
                               for k, v in res.items()
                               if k.startswith(prefix)})


def _ranks_identical(ranks, label):
    keys = [k for k in ranks[0] if k.startswith(f"{label}/")
            and not k.endswith("/resid1")]      # each rank's own row
    for res in ranks[1:]:
        for k in keys:
            assert np.array_equal(res[k], ranks[0][k]), k


@pytest.mark.parametrize("mode", ["flat", *SYNC_MODES])
def test_one_step_matches_jax(mesh4, step_ranks, mode):
    """Twin of test_hier_sync.py:128-141, port against JAX in the same
    mode: loss within 1e-5, parameters within 10 x PARAM_ATOL (the key
    bias to Adam's bound, see ``_assert_params_close``)."""
    loss, params, _ = _jax_run(mesh4, mode, 1, 1)
    _ranks_identical(step_ranks, mode)
    res = step_ranks[0]
    assert abs(float(res[f"{mode}/loss"]) - loss) < 1e-5
    _assert_params_close(_port_params(res, mode), params,
                         atol=10 * PARAM_ATOL.get(mode, 1e-6),
                         lr_bound=2 * LR)


def test_overlap_accumulation_matches_jax(mesh4, step_ranks):
    """Twin of test_hier_sync.py:240-247: hier, accumulation 4, the
    per-microbatch sync, two steps."""
    loss, params, _ = _jax_run(mesh4, "hier", 4, 2)
    _ranks_identical(step_ranks, "hier-accum4")
    res = step_ranks[0]
    assert abs(float(res["hier-accum4/loss"]) - loss) < 1e-5
    _assert_params_close(_port_params(res, "hier-accum4"), params,
                         atol=1e-4, lr_bound=4 * LR)


@pytest.mark.parametrize("mode", ["hier-int8", "hier-int4", "hier-topk"])
def test_error_feedback_state_is_carried(mesh4, step_ranks, mode):
    """Twin of test_hier_sync.py:258-288: the residual has JAX's
    per-device shape, is non-zero after a step, and is fed back (zeroing
    it between two steps changes the parameters)."""
    _, _, jstate = _jax_run(mesh4, mode, 1, 1)
    for res in step_ranks:
        resid = res[f"{mode}/resid1"]
        assert resid.shape == tuple(jstate.grad_sync_residual.shape[1:])
        assert np.abs(resid).max() > 0
    _ranks_identical(step_ranks, f"{mode}-2")
    fed = _port_params(step_ranks[0], f"{mode}-2")
    zeroed = _port_params(step_ranks[0], f"{mode}-2z")
    delta = max(np.abs(np.asarray(a) - np.asarray(b)).max() for a, b in zip(
        jax.tree_util.tree_leaves(fed), jax.tree_util.tree_leaves(zeroed)))
    assert delta > 0, "zeroing the EF residual changed nothing — EF is dead"


def test_step_runs_cover_every_mode():
    assert {m for _, m, _, _, _ in STEP_RUNS} == {"flat", *SYNC_MODES}


# --- the residual through the gate, a rollback and a checkpoint --------------

def test_skipped_step_leaves_the_residual_bitwise(step_ranks):
    for res in step_ranks:
        assert int(res["gate/skipped"]) == 1
        assert np.abs(res["gate/before"]).max() > 0
        assert np.array_equal(res["gate/after"], res["gate/before"])


def test_rollback_restores_the_residual(step_ranks):
    for res in step_ranks:
        assert not np.array_equal(res["rollback/moved"],
                                  res["rollback/staged"])
        assert np.array_equal(res["rollback/restored"],
                              res["rollback/staged"])


def test_checkpoint_restore_gives_a_zero_residual(step_ranks):
    """JAX saves no residual and its restore keeps the template's fresh
    zeros (checkpoint/manager.py:33-40, :320-338)."""
    for res in step_ranks:
        assert np.abs(res["rollback/restored"]).max() > 0
        assert not np.any(res["ckpt/restored"])
        assert not [n for n in res["ckpt/names"].tolist()
                    if "residual" in n]


# --- the CLI -----------------------------------------------------------------

def _usage_error(argv, capsys) -> str:
    with pytest.raises(SystemExit) as e:
        cli_main(["--use-cpu", "--synthetic-data", *argv])
    assert e.value.code == 2
    return capsys.readouterr().err


@pytest.mark.parametrize("argv,flag", [
    (["--grad-sync-stripe", "2"], "--grad-sync-stripe"),
    (["--grad-sync", "hier", "--distributed", "--grad-sync-stripe", "nope"],
     "--grad-sync-stripe"),
    (["--grad-sync", "hier", "--distributed", "--grad-sync-stripe", "0"],
     "--grad-sync-stripe"),
    (["--grad-sync-overlap", "on"], "--grad-sync-overlap"),
    (["--grad-sync-slices", "2"], "--grad-sync-slices"),
    (["--grad-sync-bucket-mb", "8"], "--grad-sync-bucket-mb"),
    (["--grad-sync", "hier", "--distributed", "--grad-sync-bucket-mb", "x"],
     "--grad-sync-bucket-mb"),
    (["--grad-sync", "hier", "--distributed", "--grad-sync-bucket-mb", "0"],
     "--grad-sync-bucket-mb"),
    (["--grad-sync", "hier-int8"], "--distributed"),
    (["--grad-sync", "ring"], "--grad-sync"),
])
def test_cli_refusals(argv, flag, capsys):
    """Twins of test_striping.py:273-304 and of the JAX CLI's checks
    (cli/main.py:767-820): usage errors naming the flag."""
    assert flag in _usage_error(argv, capsys)


def test_cli_grad_sync_needs_more_than_one_process(capsys, monkeypatch):
    """``--distributed`` outside torchrun is a world of one: refused as a
    usage error by the sync itself (JAX's trivial-axis check)."""
    for k in ("WORLD_SIZE", "RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    err = _usage_error(["--distributed", "--grad-sync", "hier",
                        "--steps-per-epoch", "1", "--num-workers", "0"],
                       capsys)
    assert "--grad-sync hier" in err


GPT2_ARGV = ["--use-cpu", "--model", "gpt2", "--dataset", "synthetic-tokens",
             "--seq-len", "32", "--model-overrides",
             "num_layers=2,hidden_dim=64,num_heads=2,vocab_size=256,"
             "max_seq_len=64", "--batch-size", "16", "--accum-steps", "2",
             "--steps-per-epoch", "3", "--num-workers", "0"]


# The fields of the JAX CLI's ``grad_sync_model`` record.
GRAD_SYNC_MODEL_FIELDS = {
    "record", "mode", "dcn_bytes_per_sync", "ici_bytes_per_sync",
    "n_elems_padded", "n_slices", "ici", "n_buckets", "topk_frac",
    "bucket_mb", "bucket_policy", "syncs_per_step", "stripe",
    "phase_overlap", "overlap_depth", "wall_serial_s", "wall_overlap_s",
    "wall_s", "bubble_s", "overlap_ratio",
}


def test_cli_four_ranks_hier_int8(tmp_path):
    """Four torchrun ranks under ``hier-int8`` in 2 slices, striped and
    pipelined, with ``--metrics-dir``: JAX's ``grad-sync:`` line on each
    rank; a rank log each, whose steps ``merge_timeline`` aligns; the
    ``grad_sync_model`` record with the JAX CLI's fields, its byte model
    JAX's ``dcn_bytes_per_sync`` / ``ici_bytes_per_sync`` on the record's
    layout and its wall the port's model of those bytes; the per-step
    DCN and ICI counters the record's bytes times its syncs a step."""
    from pytorch_distributed_training_tpu_torch import obs as tobs

    mdir = tmp_path / "tm"
    res = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", "4", "-m",
         "pytorch_distributed_training_tpu_torch.cli.main", "--distributed",
         *GPT2_ARGV, "--grad-sync", "hier-int8", "--grad-sync-slices", "2",
         "--grad-sync-stripe", "2", "--grad-sync-overlap", "on",
         "--metrics-dir", str(mdir)],
        cwd=REPO, capture_output=True, text=True, timeout=120,
        env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert res.returncode == 0, res.stdout + res.stderr
    out = res.stdout
    assert out.count("grad-sync: hier-int8 over 2 slice(s) x 2 ici, ") == 4
    assert "(auto), stripe=2 overlap=on" in out
    assert out.count("training finished") == 4
    assert "epoch=0 | step=3 |" in out
    logs = tobs.load_rank_logs(str(mdir))
    assert sorted(logs) == [0, 1, 2, 3]
    timeline = tobs.merge_timeline(logs)
    assert [row["step"] for row in timeline] == [0, 1, 2]
    assert all(not row["missing_ranks"] for row in timeline)
    records = []
    for rank, events in logs.items():
        tobs.validate_events(events)
        (rec,) = [e for e in events if e.get("record") == "grad_sync_model"]
        rec = {k: v for k, v in rec.items()
               if k not in ("v", "t", "rank", "kind")}
        assert set(rec) == GRAD_SYNC_MODEL_FIELDS
        records.append(rec)
        steps = [e for e in events if e["kind"] == "step"]
        assert all(e["counters"]["dcn_bytes"] == rec["dcn_bytes_per_sync"]
                   * rec["syncs_per_step"]
                   and e["counters"]["ici_bytes"] == rec["ici_bytes_per_sync"]
                   * rec["syncs_per_step"] for e in steps)
    assert all(r == records[0] for r in records)
    rec = records[0]
    assert (rec["mode"], rec["n_slices"], rec["ici"], rec["stripe"],
            rec["phase_overlap"], rec["syncs_per_step"]) == \
        ("hier-int8", 2, 2, 2, True, 2)
    assert rec["dcn_bytes_per_sync"] == jax_dcn_bytes(
        rec["n_elems_padded"], 2, 2, "hier-int8",
        n_buckets=rec["n_buckets"], topk_frac=rec["topk_frac"]) > 0
    assert rec["ici_bytes_per_sync"] == jstripe.ici_bytes_per_sync(
        rec["n_elems_padded"], 2, 2, "hier-int8", n_buckets=rec["n_buckets"],
        topk_frac=rec["topk_frac"], stripe=2)
    wall = tobs.grad_sync_wall_model(
        ici_bytes=rec["ici_bytes_per_sync"],
        dcn_bytes=rec["dcn_bytes_per_sync"], n_buckets=rec["n_buckets"],
        n_slices=2, ici_size=2, stripe=2, phase_overlap=True)
    assert {k: rec[k] for k in ("wall_serial_s", "wall_overlap_s",
                                "wall_s", "bubble_s", "overlap_ratio")} == \
        {k: wall[k] for k in ("wall_serial_s", "wall_overlap_s", "wall_s",
                              "bubble_s", "overlap_ratio")}


def test_two_nodes_detect_two_slices():
    outs = launch_nodes([GPT2_ARGV + ["--grad-sync", "hier"]] * 2, 2,
                        timeout=120)
    for out in outs:
        assert out.count("grad-sync: hier over 2 slice(s) x 2 ici, ") == 2
        assert out.count("training finished") == 2
