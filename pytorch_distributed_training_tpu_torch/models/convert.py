"""Weight bridge between the JAX package's GPT-2, ResNet and ViT param
trees and this port's ``state_dict``, both ways.

The tree is nested mappings of arrays (numpy, or anything ``np.asarray``
takes), as ``GPT2.init(...)["params"]`` returns it.  What changes on the
way:

- flax ``Dense`` kernels are (in, out); ``nn.Linear`` weights are
  (out, in), so kernels are transposed;
- flax ``LayerNorm`` names its parameters ``scale``/``bias``; torch's are
  ``weight``/``bias`` (both use epsilon 1e-6 here, ``models/gpt2.py``);
- ``wte`` doubles as the LM head when embeddings are tied, so there is no
  ``lm_head`` entry then;
- flax ``Conv`` kernels are HWIO, ``nn.Conv2d`` weights OIHW; the ResNet's
  BatchNorm ``scale``/``bias`` are parameters of the same names and its
  ``batch_stats`` ``mean``/``var`` are buffers; flax's auto-names
  (``BasicBlock_i`` / ``Bottleneck_i``, ``Conv_j``, ``BatchNorm_j``) map to
  ``blocks.i``, ``convj``, ``bnj``, and ``conv_init``/``bn_init`` live
  under the port's ``stem``;
- the ViT's ``block_i`` become ``blocks.i``; its ``cls_token`` and
  ``pos_embed`` keep their (1, 1, D) and (1, N, D) shapes.

No downloading is involved: tests build the JAX params from its own
init, compare the two models on the same inputs, and map the port's
parameters back (``gpt2_params_to_jax``) to compare weights after the
same training steps leaf by leaf.
"""

from __future__ import annotations

import re
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


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().to("cpu", torch.float32).numpy()


def gpt2_params_to_jax(params: Mapping[str, torch.Tensor]) -> dict:
    """The inverse of ``gpt2_params_from_jax``: ``GPT2.state_dict()`` (or
    a name → tensor mapping of the same keys) as the flax GPT-2 param
    tree of f32 numpy arrays."""
    def dense(prefix):
        out = {"kernel": _np(params[f"{prefix}.weight"]).T.copy()}
        if f"{prefix}.bias" in params:
            out["bias"] = _np(params[f"{prefix}.bias"])
        return out

    def layer_norm(prefix):
        return {"scale": _np(params[f"{prefix}.weight"]),
                "bias": _np(params[f"{prefix}.bias"])}

    tree = {"wte": _np(params["wte"]), "wpe": _np(params["wpe"])}
    layer = 0
    while f"blocks.{layer}.ln1.weight" in params:
        p = f"blocks.{layer}"
        tree[f"block_{layer}"] = {
            "ln1": layer_norm(f"{p}.ln1"),
            "attn": {"qkv": dense(f"{p}.attn.qkv"),
                     "proj": dense(f"{p}.attn.proj")},
            "ln2": layer_norm(f"{p}.ln2"),
            "mlp_up": dense(f"{p}.mlp_up"),
            "mlp_down": dense(f"{p}.mlp_down"),
        }
        layer += 1
    tree["ln_final"] = layer_norm("ln_final")
    if "lm_head.weight" in params:
        tree["lm_head"] = dense("lm_head")
    return tree


def _resnet_key(path: tuple[str, ...]) -> str:
    """A flax ResNet leaf path -> the port's ``state_dict`` key."""
    head, *rest = path
    leaf = "weight" if rest[-1] == "kernel" else rest[-1]
    m = re.fullmatch(r"(?:BasicBlock|Bottleneck)_(\d+)", head)
    if m:
        inner = re.sub(r"^Conv_(\d+)$", r"conv\1", rest[0])
        inner = re.sub(r"^BatchNorm_(\d+)$", r"bn\1", inner)
        return f"blocks.{m.group(1)}.{inner}.{leaf}"
    if head in ("conv_init", "bn_init"):
        return f"stem.{head}.{leaf}"
    return f"{head}.{leaf}"


def _from_flax_leaf(x) -> torch.Tensor:
    t = _t(x)
    if t.ndim == 4:
        return t.permute(3, 2, 0, 1).contiguous()   # HWIO -> OIHW
    if t.ndim == 2:
        return t.t().contiguous()                   # Dense (in, out)
    return t


def resnet_params_from_jax(params: Mapping,
                           batch_stats: Mapping) -> dict[str, torch.Tensor]:
    """Map a flax ResNet's ``params`` and ``batch_stats`` trees to the
    port's ``ResNet.state_dict()`` keys (f32)."""
    out: dict[str, torch.Tensor] = {}

    def walk(tree, path):
        for k, v in tree.items():
            if isinstance(v, Mapping):
                walk(v, path + (k,))
            else:
                out[_resnet_key(path + (k,))] = _from_flax_leaf(v)

    walk(params, ())
    walk(batch_stats, ())
    return out


def resnet_params_to_jax(state: Mapping[str, torch.Tensor]
                         ) -> tuple[dict, dict]:
    """The inverse of ``resnet_params_from_jax``: a ``ResNet.state_dict()``
    (or a name -> tensor mapping of its keys) as the flax ``(params,
    batch_stats)`` trees of f32 numpy arrays.  ``batch_stats`` holds the
    running statistics the mapping has."""
    kind = ("Bottleneck" if any(".conv2." in k or ".bn2." in k for k in state)
            else "BasicBlock")
    params: dict = {}
    stats: dict = {}
    for key, value in state.items():
        *mods, leaf = key.split(".")
        if mods[0] == "stem":
            path = [mods[1]]
        elif mods[0] == "blocks":
            inner = re.sub(r"^conv(\d+)$", r"Conv_\1", mods[2])
            inner = re.sub(r"^bn(\d+)$", r"BatchNorm_\1", inner)
            path = [f"{kind}_{mods[1]}", inner]
        else:
            path = mods
        x = _np(value)
        if x.ndim == 4:
            x = x.transpose(2, 3, 1, 0).copy()      # OIHW -> HWIO
        elif x.ndim == 2:
            x = x.T.copy()
        tree = stats if leaf in ("mean", "var") else params
        for p in path:
            tree = tree.setdefault(p, {})
        tree["kernel" if leaf == "weight" else leaf] = x
    return params, stats


def vit_params_from_jax(tree: Mapping) -> dict[str, torch.Tensor]:
    """Map a flax ``VisionTransformer`` param tree to the port's
    ``VisionTransformer.state_dict()`` keys (f32)."""
    out = {"cls_token": _t(tree["cls_token"]),
           "pos_embed": _t(tree["pos_embed"])}
    out["patch_embed.weight"] = _from_flax_leaf(tree["patch_embed"]["kernel"])
    out["patch_embed.bias"] = _t(tree["patch_embed"]["bias"])
    layer = 0
    while f"block_{layer}" in tree:
        blk = tree[f"block_{layer}"]
        p = f"blocks.{layer}"
        _layer_norm(blk["ln1"], f"{p}.ln1", out)
        _dense(blk["attn"]["qkv"], f"{p}.attn.qkv", out)
        _dense(blk["attn"]["proj"], f"{p}.attn.proj", out)
        _layer_norm(blk["ln2"], f"{p}.ln2", out)
        _dense(blk["mlp"]["fc1"], f"{p}.mlp.fc1", out)
        _dense(blk["mlp"]["fc2"], f"{p}.mlp.fc2", out)
        layer += 1
    _layer_norm(tree["ln_final"], "ln_final", out)
    _dense(tree["head"], "head", out)
    return out


def vit_params_to_jax(params: Mapping[str, torch.Tensor]) -> dict:
    """The inverse of ``vit_params_from_jax``: the port's ViT
    ``state_dict()`` (or a name -> tensor mapping of its keys) as the flax
    param tree of f32 numpy arrays."""
    def dense(prefix):
        return {"kernel": _np(params[f"{prefix}.weight"]).T.copy(),
                "bias": _np(params[f"{prefix}.bias"])}

    def layer_norm(prefix):
        return {"scale": _np(params[f"{prefix}.weight"]),
                "bias": _np(params[f"{prefix}.bias"])}

    tree = {
        "patch_embed": {
            "kernel": _np(params["patch_embed.weight"]).transpose(
                2, 3, 1, 0).copy(),                  # OIHW -> HWIO
            "bias": _np(params["patch_embed.bias"]),
        },
        "cls_token": _np(params["cls_token"]),
        "pos_embed": _np(params["pos_embed"]),
    }
    layer = 0
    while f"blocks.{layer}.ln1.weight" in params:
        p = f"blocks.{layer}"
        tree[f"block_{layer}"] = {
            "ln1": layer_norm(f"{p}.ln1"),
            "attn": {"qkv": dense(f"{p}.attn.qkv"),
                     "proj": dense(f"{p}.attn.proj")},
            "ln2": layer_norm(f"{p}.ln2"),
            "mlp": {"fc1": dense(f"{p}.mlp.fc1"),
                    "fc2": dense(f"{p}.mlp.fc2")},
        }
        layer += 1
    tree["ln_final"] = layer_norm("ln_final")
    tree["head"] = dense("head")
    return tree
