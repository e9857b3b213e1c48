"""Model registry: the same names as the JAX package's
``models/registry.py``: the GPT-2s (``gpt2_moe`` is GPT-2 124M with 8
experts in every odd block, ``models/moe.py``), the ResNets and the
ViTs."""

from __future__ import annotations

from .gpt2 import gpt2_124m, gpt2_large, gpt2_medium, gpt2_xl
from .resnet import resnet18, resnet34, resnet50, resnet101, resnet152
from .vit import vit_b16, vit_l16, vit_s16

def _gpt2_moe(cfg_overrides: dict | None = None, **kw):
    """GPT-2 with Switch-style MoE MLPs in every odd block."""
    return gpt2_124m({"num_experts": 8, **(cfg_overrides or {})}, **kw)


_LM_FACTORIES = {
    "gpt2": gpt2_124m,
    "gpt2_moe": _gpt2_moe,
    "gpt2_medium": gpt2_medium,
    "gpt2_large": gpt2_large,
    "gpt2_xl": gpt2_xl,
}
_IMAGE_FACTORIES = {
    "resnet18": resnet18,
    "resnet34": resnet34,
    "resnet50": resnet50,
    "resnet101": resnet101,
    "resnet152": resnet152,
}
_VIT_FACTORIES = {
    "vit_s16": vit_s16,
    "vit_b16": vit_b16,
    "vit_l16": vit_l16,
}
MODEL_NAMES = sorted({*_LM_FACTORIES, *_IMAGE_FACTORIES, *_VIT_FACTORIES})


def model_kind(name: str) -> str:
    """"lm" for the language models, "image_classifier" for the rest."""
    if name not in MODEL_NAMES:
        raise ValueError(f"Unknown model {name!r}; available: {MODEL_NAMES}")
    return "lm" if name.startswith("gpt2") else "image_classifier"


def create_model(name: str, *, num_classes: int | None = None, dtype=None,
                 device=None, seed: int = 0,
                 cfg_overrides: dict | None = None,
                 image_size: int | None = None):
    """Build a model by registry name, weights drawn from ``seed``.
    ``num_classes`` sizes a classifier's head (1000 by default; the
    reference sizes it from the dataset) and is ignored for LMs.
    ``image_size`` sizes a ViT's position table (224 by default; the
    other models take any size).  ``device`` defaults to CUDA
    (``utils.device``)."""
    model_kind(name)
    if name in _VIT_FACTORIES:
        return _VIT_FACTORIES[name](
            1000 if num_classes is None else num_classes, cfg_overrides,
            image_size=224 if image_size is None else image_size,
            device=device, dtype=dtype, seed=seed,
        )
    if name in _IMAGE_FACTORIES:
        return _IMAGE_FACTORIES[name](
            1000 if num_classes is None else num_classes, cfg_overrides,
            device=device, dtype=dtype, seed=seed,
        )
    return _LM_FACTORIES[name](
        cfg_overrides, device=device, dtype=dtype, seed=seed
    )
