"""Deterministic seeding: the counterpart of the JAX package's
``utils/seeding.py``.

The reference seeds nothing.  The port's model init, dropout and data
order already draw from explicit generators and seeds; this covers the
ambient ones (python's ``random``, numpy's and torch's global state) and
hands back an explicit generator where JAX hands back its root
``PRNGKey``.
"""

# graftcheck: disable-file=global-rng — the seeding helper: seeding the
# process-global generators is what it is for.

from __future__ import annotations

import random

import numpy as np
import torch


def seed_everything(seed: int) -> torch.Generator:
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    return torch.Generator().manual_seed(seed)
