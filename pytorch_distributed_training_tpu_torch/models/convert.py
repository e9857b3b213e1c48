"""Weight bridge: the JAX package's GPT-2 param tree → this port's
``state_dict``.

The tree is nested mappings of arrays (numpy, or anything ``np.asarray``
takes), as ``GPT2.init(...)["params"]`` returns it.  What changes on the
way:

- flax ``Dense`` kernels are (in, out); ``nn.Linear`` weights are
  (out, in), so kernels are transposed;
- flax ``LayerNorm`` names its parameters ``scale``/``bias``; torch's are
  ``weight``/``bias`` (both use epsilon 1e-6 here, ``models/gpt2.py``);
- ``wte`` doubles as the LM head when embeddings are tied, so there is no
  ``lm_head`` entry then.

No training or downloading is involved: tests build the JAX params from
its own init and compare the two models on the same inputs.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _dense(tree: Mapping, prefix: str, out: dict) -> None:
    out[f"{prefix}.weight"] = _t(tree["kernel"]).t().contiguous()
    if "bias" in tree:
        out[f"{prefix}.bias"] = _t(tree["bias"])


def _layer_norm(tree: Mapping, prefix: str, out: dict) -> None:
    out[f"{prefix}.weight"] = _t(tree["scale"])
    out[f"{prefix}.bias"] = _t(tree["bias"])


def gpt2_params_from_jax(tree: Mapping) -> dict[str, torch.Tensor]:
    """Map a flax GPT-2 param tree to ``GPT2.state_dict()`` keys (f32)."""
    out = {"wte": _t(tree["wte"]), "wpe": _t(tree["wpe"])}
    layer = 0
    while f"block_{layer}" in tree:
        blk = tree[f"block_{layer}"]
        p = f"blocks.{layer}"
        if "attn" not in blk:
            raise NotImplementedError(
                f"block_{layer} is not a dense block (MoE is not yet ported)"
            )
        _layer_norm(blk["ln1"], f"{p}.ln1", out)
        _dense(blk["attn"]["qkv"], f"{p}.attn.qkv", out)
        _dense(blk["attn"]["proj"], f"{p}.attn.proj", out)
        _layer_norm(blk["ln2"], f"{p}.ln2", out)
        _dense(blk["mlp_up"], f"{p}.mlp_up", out)
        _dense(blk["mlp_down"], f"{p}.mlp_down", out)
        layer += 1
    _layer_norm(tree["ln_final"], "ln_final", out)
    if "lm_head" in tree:
        _dense(tree["lm_head"], "lm_head", out)
    return out
