"""The port's decode-attention ops against the Pallas kernels.

The plain PyTorch versions of ``decode_attention`` / ``decode_attention_
multi`` are held against the JAX package's Pallas kernels run in
interpret mode (f32, atol 2e-5: summation order only), over a scalar
index, a per-row index vector, the idle-slot sentinel (index >= L) and
chunk widths 1..8.  The wrapper contract is pinned too: CPU tensors take
the plain version and count no launch, bad inputs raise, and the kernel
build raises instead of falling back when nvcc is missing.  The CUDA
kernel itself is compared with the plain version on a card by
tests/test_torch_cuda_kernels.py and chip_smoke.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_distributed_training_tpu.ops.pallas_attention import (
    decode_attention as jax_decode_attention,
    decode_attention_multi as jax_decode_attention_multi,
)
from pytorch_distributed_training_tpu_torch.ops import _build
from pytorch_distributed_training_tpu_torch.ops import decode_attention as da

B, H, L, DH = 4, 3, 40, 16


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: these tensors are tiny, and the cores are
    shared with the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(c, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, c, H, DH)).astype(np.float32)
    k = rng.standard_normal((B, H, L, DH)).astype(np.float32)
    v = rng.standard_normal((B, H, L, DH)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("index", [
    np.int32(17),                                  # lockstep: one scalar
    np.asarray([0, 9, L - 1, L], np.int32),        # ragged + sentinel row
])
def test_single_query_matches_pallas(index):
    q, k, v = _inputs(1, seed=1)
    ref = np.asarray(jax_decode_attention(
        jnp.asarray(q[:, 0]), jnp.asarray(k), jnp.asarray(v),
        jnp.asarray(index), interpret=True,
    ))
    idx = torch.as_tensor(np.asarray(index))
    out = da.decode_attention(
        torch.from_numpy(q[:, 0]), torch.from_numpy(k), torch.from_numpy(v),
        idx if idx.dim() else int(idx),
    )
    assert out.shape == (B, H, DH) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, atol=2e-5, rtol=0)


@pytest.mark.parametrize("c", range(1, 9))
def test_multi_query_matches_pallas(c):
    q, k, v = _inputs(c, seed=10 + c)
    # Row 2's chunk runs past the cache end; row 3 is the sentinel.
    index = np.asarray([0, 11, L - 3, L + 5], np.int32)
    ref = np.asarray(jax_decode_attention_multi(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(index),
        interpret=True,
    ))
    out = da.decode_attention_multi(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(index),
    )
    assert out.shape == (B, c, H, DH)
    np.testing.assert_allclose(out.numpy(), ref, atol=2e-5, rtol=0)


def test_bf16_rounds_probabilities_like_the_kernel():
    """bf16 inputs: p is rounded to bf16 before PV, as in the TPU kernel;
    the plain version agrees with the Pallas kernel to bf16 rounding."""
    q, k, v = _inputs(2, seed=3)
    index = np.asarray([4, 20, L - 1, L], np.int32)
    qb, kb, vb = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v))
    ref = np.asarray(jax_decode_attention_multi(
        qb, kb, vb, jnp.asarray(index), interpret=True,
    ).astype(jnp.float32))
    out = da.decode_attention_multi(
        *(torch.from_numpy(x).bfloat16() for x in (q, k, v)),
        torch.from_numpy(index),
    )
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), ref, atol=2e-2, rtol=2e-2)


def test_cpu_tensors_count_no_launch():
    q, k, v = _inputs(2, seed=4)
    before = (da.decode_attention.launches, da.decode_attention_multi.launches)
    da.decode_attention(torch.from_numpy(q[:, 0]), torch.from_numpy(k),
                        torch.from_numpy(v), 3)
    da.decode_attention_multi(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), 3)
    assert (da.decode_attention.launches,
            da.decode_attention_multi.launches) == before


def test_index_must_match_batch():
    q, k, v = _inputs(1, seed=5)
    with pytest.raises(ValueError, match="entries"):
        da.decode_attention(torch.from_numpy(q[:, 0]), torch.from_numpy(k),
                            torch.from_numpy(v), torch.tensor([1, 2]))


def test_kernel_checks_reject_what_it_cannot_take():
    """The CUDA wrapper's input checks, run on meta tensors (no card
    needed): non-CUDA tensors and chunk widths past 8 raise before any
    launch (the checks a card needs are in test_torch_cuda_kernels.py)."""
    meta = dict(device="meta")
    q = torch.empty(B, H, DH, **meta)
    kv = torch.empty(B, H, L, DH, **meta)
    with pytest.raises(ValueError, match="CUDA"):
        da._check(q, kv, kv, chunk_dims=0)
    with pytest.raises(ValueError, match="chunk width"):
        da._launch(torch.empty(B, 9, H, DH, **meta), kv, kv, 0, 1.0)


def test_build_raises_without_nvcc(monkeypatch):
    """No silent fallback: a missing compiler is an error."""
    monkeypatch.setenv("PATH", "/nonexistent")
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setattr(_build.os.path, "isfile", lambda p: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.nvcc_path()


def test_library_path_keyed_by_source_hash():
    path = _build.library_path("decode_attention.cu")
    assert path.parent == _build.BUILD_DIR
    assert path.name.startswith("decode_attention-") and path.suffix == ".so"
    assert path == _build.library_path("decode_attention.cu")
