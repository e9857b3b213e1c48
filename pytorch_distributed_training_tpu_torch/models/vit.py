"""Vision Transformer: the counterpart of the JAX package's
``models/vit.py`` (ViT-S/16, ViT-B/16, ViT-L/16).

Dosovitskiy et al. 2020: a 16x16 patch convolution, a CLS token, learned
position embeddings, pre-LN encoder blocks (tanh-approximated GELU MLP),
a final LayerNorm and a linear head on the CLS token.  The parameter
layout follows flax's so that ``models/convert.py`` maps a JAX param tree
onto this module one to one; LayerNorm uses flax's epsilon, 1e-6.

Where it differs from PyTorch's usual ViT:

- the patch convolution pads like flax's ``"SAME"``: nothing when the
  image side is a multiple of the patch, else ``ceil(side / p) * p``
  minus the side, the odd pixel at the bottom/right;
- ``pos_embed`` is sized when the model is built, from ``image_size``;
- the input is NCHW (the train step's ``channels_last`` view of an NHWC
  batch); the patches are taken in the NHWC reshape's row-major order;
- the head computes in f32 on the weights it is given (the JAX head's
  ``dtype=float32``); everything else runs in the dtype of the weights
  the forward runs on (the train step's compute-dtype copies).

Attention is ``models/layers.SelfAttention`` with ``causal=False`` and
the layout ``attn_layout`` (default ``"bhld2"``, as in JAX).  Training:
dropout draws its masks from an explicit generator the train step hands
down, and ``remat`` runs each block under ``torch.utils.checkpoint``,
whose recompute draws the same masks again.  ``new_stats`` and ``group``
are accepted for the image train step's sake and ignored: a ViT has no
running statistics.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..utils.device import resolve_device
from .gpt2 import LN_EPS, _site_generator, dropout, lecun_normal_
from .layers import SelfAttention


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    num_classes: int = 1000
    patch_size: int = 16
    hidden_dim: int = 768
    depth: int = 12
    num_heads: int = 12
    mlp_dim: int = 3072
    dropout_rate: float = 0.0
    remat: bool = False
    attn_layout: str = "bhld2"


def same_padding(size: int, patch: int) -> tuple[int, int]:
    """flax ``"SAME"`` padding of one side for a patch-strided conv:
    (before, after)."""
    total = max(-(-size // patch) * patch - size, 0)
    return total // 2, total - total // 2


class MlpBlock(nn.Module):
    def __init__(self, hidden_dim: int, mlp_dim: int, *, device=None):
        super().__init__()
        self.fc1 = nn.Linear(hidden_dim, mlp_dim, device=device)
        self.fc2 = nn.Linear(mlp_dim, hidden_dim, device=device)

    def forward(self, x, rate: float = 0.0, generator=None):
        x = dropout(F.gelu(self.fc1(x), approximate="tanh"), rate, generator)
        return dropout(self.fc2(x), rate, generator)


class EncoderBlock(nn.Module):
    def __init__(self, cfg: ViTConfig, *, device=None):
        super().__init__()
        d = cfg.hidden_dim
        self.ln1 = nn.LayerNorm(d, eps=LN_EPS, device=device)
        self.attn = SelfAttention(d, cfg.num_heads, causal=False,
                                  attn_layout=cfg.attn_layout, device=device)
        self.ln2 = nn.LayerNorm(d, eps=LN_EPS, device=device)
        self.mlp = MlpBlock(d, cfg.mlp_dim, device=device)
        self.dropout_rate = cfg.dropout_rate

    def forward(self, x, dropout_seed=None):
        """``dropout_seed``: the block's three masks come from one
        generator seeded with it, so a rematerialized forward draws the
        same masks again."""
        gen = _site_generator(dropout_seed, x.device)
        x = x + dropout(self.attn(self.ln1(x)), self.dropout_rate, gen)
        return x + self.mlp(self.ln2(x), self.dropout_rate, gen)


def _block_call(block, params, x, dropout_seed):
    """One block as a function of its parameters, so the backward's
    recompute runs on the tensors the forward ran on."""
    return torch.func.functional_call(block, params, (x,),
                                      {"dropout_seed": dropout_seed})


class VisionTransformer(nn.Module):
    """(B, C, H, W) images -> (B, num_classes) f32 logits."""

    def __init__(self, cfg: ViTConfig, *, image_size: int = 224,
                 in_channels: int = 3, device=None):
        super().__init__()
        self.cfg = cfg
        self.image_size = image_size
        d, p = cfg.hidden_dim, cfg.patch_size
        self.patch_embed = nn.Conv2d(in_channels, d, p, p, device=device)
        side = -(-image_size // p)
        self.cls_token = nn.Parameter(torch.empty(1, 1, d, device=device))
        self.pos_embed = nn.Parameter(
            torch.empty(1, side * side + 1, d, device=device))
        self.blocks = nn.ModuleList(
            EncoderBlock(cfg, device=device) for _ in range(cfg.depth))
        self.ln_final = nn.LayerNorm(d, eps=LN_EPS, device=device)
        self.head = nn.Linear(d, cfg.num_classes, device=device)

    @property
    def dropout_rate(self) -> float:
        return self.cfg.dropout_rate

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """Fresh weights from ``generator`` by the JAX model's rules:
        ``cls_token`` zero, ``pos_embed`` ~ N(0, 0.02), the patch
        convolution and every dense kernel lecun-normal (truncated at 2
        sigma), biases zero, LayerNorm 1/0.  The draws differ from
        ``jax.random``'s; parity tests convert the JAX weights."""
        self.cls_token.zero_()
        self.pos_embed.normal_(0.0, 0.02, generator=generator)
        for m in self.modules():
            if isinstance(m, (nn.Linear, nn.Conv2d)):
                lecun_normal_(m.weight, generator)
                m.bias.zero_()
            elif isinstance(m, nn.LayerNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()

    def forward(self, x, new_stats: dict | None = None, group=None,
                generator: torch.Generator | None = None):
        """In training mode with ``dropout_rate > 0``, ``generator`` (a
        CPU ``torch.Generator``) is required: every dropout site draws its
        seed from it on the host.  ``new_stats`` and ``group`` are
        ignored."""
        cfg = self.cfg
        drop = self.training and cfg.dropout_rate > 0.0
        if drop and generator is None:
            raise ValueError(
                "dropout_rate > 0 in training needs an explicit generator "
                "(the train step hands one down)"
            )
        seeds = (
            torch.randint(2**62, (cfg.depth + 1,), generator=generator)
            .tolist() if drop else [None] * (cfg.depth + 1)
        )
        w = self.patch_embed.weight
        x = x.to(w.dtype)
        p = cfg.patch_size
        (top, bottom), (left, right) = (same_padding(s, p)
                                        for s in x.shape[2:])
        if top or bottom or left or right:
            x = F.pad(x, (left, right, top, bottom))
        x = F.conv2d(x, w, self.patch_embed.bias, stride=p)
        b, d = x.shape[0], x.shape[1]
        # (B, D, h, w) -> (B, h*w, D), row-major over (h, w) as the NHWC
        # reshape takes them.
        x = x.permute(0, 2, 3, 1).reshape(b, -1, d)
        if x.shape[1] + 1 != self.pos_embed.shape[1]:
            raise ValueError(
                f"{x.shape[1]} patches, but pos_embed was sized for "
                f"{self.pos_embed.shape[1] - 1} (image_size "
                f"{self.image_size})"
            )
        x = torch.cat([self.cls_token.to(x.dtype).expand(b, 1, d), x], 1)
        x = dropout(x + self.pos_embed.to(x.dtype), cfg.dropout_rate,
                    _site_generator(seeds[0], x.device))
        remat = cfg.remat and self.training and torch.is_grad_enabled()
        for i, block in enumerate(self.blocks):
            if remat:
                x = checkpoint(_block_call, block,
                               dict(block.named_parameters()), x,
                               seeds[i + 1], use_reentrant=False)
            else:
                x = block(x, dropout_seed=seeds[i + 1])
        cls = self.ln_final(x)[:, 0]
        return F.linear(cls.float(), self.head.weight.float(),
                        self.head.bias.float())


def _make(defaults: dict, num_classes, cfg_overrides, image_size, device,
          dtype, seed) -> VisionTransformer:
    cfg = ViTConfig(**{**defaults, "num_classes": num_classes,
                       **(cfg_overrides or {})})
    device = resolve_device(device)
    model = VisionTransformer(cfg, image_size=image_size, device=device)
    if device.type != "meta":
        model.init_weights(torch.Generator(device=device).manual_seed(seed))
    return model.to(dtype) if dtype is not None else model


def vit_b16(num_classes: int = 1000, cfg_overrides: dict | None = None, *,
            image_size: int = 224, device=None, dtype=None,
            seed: int = 0) -> VisionTransformer:
    """ViT-Base/16: 12 layers, 768 hidden, 12 heads, 3072 MLP (86.6M
    parameters at 224 px).  Weights are drawn in f32 from ``seed``, then
    cast to ``dtype``; ``device`` defaults to CUDA (``utils.device``),
    ``device="meta"`` builds shapes only; ``cfg_overrides`` sets any
    ``ViTConfig`` field."""
    return _make({}, num_classes, cfg_overrides, image_size, device, dtype,
                 seed)


def vit_s16(num_classes: int = 1000, cfg_overrides: dict | None = None, *,
            image_size: int = 224, device=None, dtype=None,
            seed: int = 0) -> VisionTransformer:
    """ViT-Small/16: 12 layers, 384 hidden, 6 heads, 1536 MLP (22M)."""
    return _make({"hidden_dim": 384, "num_heads": 6, "mlp_dim": 1536},
                 num_classes, cfg_overrides, image_size, device, dtype, seed)


def vit_l16(num_classes: int = 1000, cfg_overrides: dict | None = None, *,
            image_size: int = 224, device=None, dtype=None,
            seed: int = 0) -> VisionTransformer:
    """ViT-Large/16: 24 layers, 1024 hidden, 16 heads, 4096 MLP (304M)."""
    return _make({"hidden_dim": 1024, "depth": 24, "num_heads": 16,
                  "mlp_dim": 4096},
                 num_classes, cfg_overrides, image_size, device, dtype, seed)
