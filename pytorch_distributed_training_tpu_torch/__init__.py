"""PyTorch + CUDA port of ``pytorch_distributed_training_tpu``.

The JAX package beside this one is the reference: every module here has a
twin at the same path there, and the tests in ``tests/test_torch_*.py``
hold each against it on converted weights.  This package imports
``torch`` and numpy only — never ``jax``, ``flax`` or the JAX package.

Ported so far (serving, paged serving, LM and image training, data
parallelism):

- ``models``  GPT-2 (dense) with the contiguous and paged KV-cache decode
  modes, dropout and remat for training, the flax <-> torch weight bridge
  (``models.convert``), and lockstep ``generate``.
- ``ops``     attention dispatch (``ops.attention``), the decode, paged and
  flash-attention kernels (``ops.decode_attention``,
  ``ops.paged_attention``, ``ops.flash_attention``: hand-written CUDA for
  Hopper in ``csrc/``, built by nvcc at first use), the losses.
- ``serve``   the slot and paged pools, prompt-lookup drafter,
  continuous-batching engine (with speculative verify), scheduler and SLO
  metrics.
- ``train``   precision policy, optax-style optimizers, state, train and
  eval steps, the epoch loop; ``parallel`` gradient accumulation and
  data-parallel replication; ``data`` the LM and image datasets, the
  corpus builder and the loader.
- ``comm``    the process group under torchrun, the data-parallel
  collectives, the KV codec.
- ``cli``     image and LM training (``--distributed``: one process per
  GPU) and the ``--serve`` subset of the reference CLI.

Entry points run on CUDA unless the caller asks for the CPU
(``device="cpu"`` / ``--use-cpu``); without CUDA and without that request
they raise.
"""

__version__ = "0.1.0"
