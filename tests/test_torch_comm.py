"""The PyTorch port's process-group setup (``comm/init.py``), device
choice under torchrun (``utils/device.py``), collectives
(``comm/collectives.py``) and seeding (``utils/seeding.py``).

``initialize`` is held to the JAX twin's contract: a no-op without the
torchrun env, the JAX ``ValueError`` at ``WORLD_SIZE=2`` without an
address, and (the port's difference) a one-rank group at ``WORLD_SIZE=1``
with the env present.  The collectives run on two gloo processes
(``tests/torch_dp_worker.py``, each run under a 100 s limit).
"""

import random
import socket

import numpy as np
import pytest
import torch

from pytorch_distributed_training_tpu.utils.seeding import (
    seed_everything as jax_seed_everything,
)
from pytorch_distributed_training_tpu_torch.comm import collectives
from pytorch_distributed_training_tpu_torch.comm import init as comm_init
from pytorch_distributed_training_tpu_torch.utils import device as device_lib
from pytorch_distributed_training_tpu_torch.utils.seeding import (
    seed_everything,
)
from tests.torch_dp_worker import launch

ENV = ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")


@pytest.fixture
def clean_env(monkeypatch):
    for k in ENV:
        monkeypatch.delenv(k, raising=False)
    yield monkeypatch
    comm_init.shutdown()


def test_initialize_is_a_noop_without_env(clean_env):
    assert comm_init.initialize("cpu") is None
    assert not comm_init.is_initialized()
    assert (comm_init.process_count(), comm_init.process_index()) == (1, 0)
    assert comm_init.local_rank() == 0


def test_initialize_needs_an_address_above_world_one(clean_env):
    clean_env.setenv("WORLD_SIZE", "2")
    clean_env.setenv("RANK", "0")
    with pytest.raises(ValueError, match="MASTER_ADDR and MASTER_PORT"):
        comm_init.initialize("cpu")
    assert not comm_init.is_initialized()


def test_initialize_world_one_without_address_is_a_noop(clean_env):
    clean_env.setenv("WORLD_SIZE", "1")
    assert comm_init.initialize("cpu") is None
    assert not comm_init.is_initialized()


def test_initialize_creates_a_gloo_group_at_world_one(clean_env):
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    for k, v in dict(WORLD_SIZE="1", RANK="0", LOCAL_RANK="0",
                     MASTER_ADDR="localhost", MASTER_PORT=str(port)).items():
        clean_env.setenv(k, v)
    group = comm_init.initialize("cpu")
    try:
        assert group is not None and comm_init.is_initialized()
        assert torch.distributed.get_backend(group) == "gloo"
        assert (comm_init.process_count(), comm_init.process_index()) == (1, 0)
        assert comm_init.initialize("cpu") is group          # idempotent
        a, b = torch.tensor([1.0, 3.0]), torch.tensor([[2.0]])
        c = torch.randn(2, 3, 4, 5).contiguous(
            memory_format=torch.channels_last)
        d = torch.randn(3, 4, dtype=torch.bfloat16).t()
        got = collectives.pmean([a, b, c, d], group)
        assert [t.shape for t in got] == [a.shape, b.shape, c.shape, d.shape]
        assert all(t.dtype == torch.float32 for t in got)
        for g, t in zip(got, (a, b, c, d)):
            assert torch.equal(g, t.float())
        # The channels_last gradient comes back in its memory format.
        assert got[2].stride() == c.stride()
    finally:
        comm_init.shutdown()
    assert not comm_init.is_initialized()


@pytest.mark.parametrize("local_rank,count,want", [
    (None, 4, 2), ("0", 1, 0), ("5", 4, 1), ("3", 8, 3),
])
def test_local_rank_picks_the_card(clean_env, local_rank, count, want):
    """``LOCAL_RANK % device_count()`` (the reference's defect 1 repaired),
    made current; without ``LOCAL_RANK`` the current card."""
    chosen = []
    clean_env.setattr(torch.cuda, "is_available", lambda: True)
    clean_env.setattr(torch.cuda, "device_count", lambda: count)
    clean_env.setattr(torch.cuda, "current_device", lambda: 2)
    clean_env.setattr(torch.cuda, "set_device", chosen.append)
    if local_rank is not None:
        clean_env.setenv("LOCAL_RANK", local_rank)
    dev = device_lib.resolve_device(None)
    assert dev == torch.device("cuda", want)
    assert chosen == ([] if local_rank is None else [want])
    assert device_lib.resolve_device("cpu") == torch.device("cpu")


def test_collectives_over_two_gloo_ranks(tmp_path):
    launch(["tests/torch_dp_worker.py", "collectives", str(tmp_path)])
    r = [np.load(tmp_path / f"rank{i}.npz") for i in range(2)]
    for res in r:
        np.testing.assert_array_equal(res["mean_a"], np.full((3, 2), 1.5))
        np.testing.assert_array_equal(res["mean_b"], np.arange(4) * 1.5)
        assert str(res["mean_b_dtype"]) == "torch.float32"
        np.testing.assert_array_equal(res["mean_one"], [1.0])
        np.testing.assert_array_equal(res["bcast_f"], np.zeros(5))
        np.testing.assert_array_equal(res["bcast_i"], np.zeros(2))
        np.testing.assert_array_equal(res["sum"], [3.0, 6.0])
        # Rank p's loss is (p + 1) * sum(y): the cotangents 1 and 2 sum.
        np.testing.assert_array_equal(res["dsum"], [3.0, 3.0])


def test_seed_everything_seeds_the_ambient_generators():
    gen = seed_everything(7)
    a = (random.random(), np.random.rand(), torch.rand(1).item(),
         torch.rand(1, generator=gen).item())
    gen = seed_everything(7)
    b = (random.random(), np.random.rand(), torch.rand(1).item(),
         torch.rand(1, generator=gen).item())
    assert a == b
    jax_seed_everything(7)
    assert (random.random(), np.random.rand()) == a[:2]

