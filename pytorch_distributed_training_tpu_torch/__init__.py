"""PyTorch + CUDA port of ``pytorch_distributed_training_tpu``.

The JAX package beside this one is the reference: every module here has a
twin at the same path there, and the tests in ``tests/test_torch_*.py``
hold each against it on converted weights.  This package imports
``torch`` and numpy only — never ``jax``, ``flax`` or the JAX package.

Ported so far (the serving slice):

- ``models``  GPT-2 (dense) with the contiguous KV-cache decode modes, the
  flax → torch weight bridge (``models.convert``), and lockstep
  ``generate``.
- ``ops``     plain causal attention and the two decode-attention kernels
  (``ops.decode_attention``), hand-written CUDA for Hopper in
  ``csrc/decode_attention.cu``, built by nvcc at first use.
- ``serve``   the contiguous slot pool, prompt-lookup drafter,
  continuous-batching engine (with speculative verify), scheduler and SLO
  metrics.
- ``train``   the precision policy (dtype map only).
- ``cli``     the ``--serve`` subset of the reference CLI.

Entry points run on CUDA unless the caller asks for the CPU
(``device="cpu"`` / ``--use-cpu``); without CUDA and without that request
they raise.
"""

__version__ = "0.1.0"
