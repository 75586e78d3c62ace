# Copied from swat_tpu/models/configs.py, with ResNetConfig held here (swat_tpu's lives in the Flax ResNet module); the port keeps its own copy, permanently (it imports nothing of swat_tpu).
"""Model configuration registry.

Mirrors the reference's ``model_cfg`` strings (reference utils/extras.py:97-120
and utils/parser.py:17-22): ``{arch}_{family}_{pretraining}`` e.g.
``vitb32_openclip_laion400m``.  The reference resolves these to OpenCLIP /
CLIP library models; here they resolve to Flax module configurations whose
parameters are loaded from converted OpenCLIP checkpoints
(`swat_tpu.models.loader`).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class VisionConfig:
    image_size: int = 224
    patch_size: int = 32
    width: int = 768
    layers: int = 12
    heads: int = 12
    # output embedding dim (shared image/text space)
    embed_dim: int = 512
    quick_gelu: bool = True

    @property
    def grid(self) -> int:
        return self.image_size // self.patch_size

    @property
    def seq_len(self) -> int:
        return self.grid * self.grid + 1  # + class token


@dataclasses.dataclass(frozen=True)
class TextConfig:
    context_length: int = 77
    vocab_size: int = 49408
    width: int = 512
    layers: int = 12
    heads: int = 8
    embed_dim: int = 512
    quick_gelu: bool = True


@dataclasses.dataclass(frozen=True)
class CLIPConfig:
    name: str
    vision: VisionConfig
    text: TextConfig

    @property
    def embed_dim(self) -> int:
        return self.vision.embed_dim


def _vit(name, patch, width, layers, heads, embed_dim, quick_gelu,
         text_width=512, text_heads=8, text_layers=12, image_size=224):
    return CLIPConfig(
        name=name,
        vision=VisionConfig(
            image_size=image_size, patch_size=patch, width=width,
            layers=layers, heads=heads, embed_dim=embed_dim,
            quick_gelu=quick_gelu,
        ),
        text=TextConfig(
            width=text_width, heads=text_heads, layers=text_layers,
            embed_dim=embed_dim, quick_gelu=quick_gelu,
        ),
    )


# reference utils/extras.py:97-114 — OPENCLIP_MODEL_DIC
MODEL_REGISTRY = {
    # LAION-400M pretraining (the paper's headline model is vitb32 here)
    "vitb32_openclip_laion400m": _vit("ViT-B-32-quickgelu", 32, 768, 12, 12, 512, True),
    "vitb16_openclip_laion400m": _vit("ViT-B-16", 16, 768, 12, 12, 512, False),
    "vitl14_openclip_laion400m": _vit(
        "ViT-L-14", 14, 1024, 24, 16, 768, False,
        text_width=768, text_heads=12, text_layers=12),
    # LAION-2B
    "vitb32_openclip_laion2b": _vit("ViT-B-32", 32, 768, 12, 12, 512, False),
    "vitb16_openclip_laion2b": _vit("ViT-B-16", 16, 768, 12, 12, 512, False),
    "vitl14_openclip_laion2b": _vit(
        "ViT-L-14", 14, 1024, 24, 16, 768, False,
        text_width=768, text_heads=12, text_layers=12),
    # OpenAI weights (always quickgelu) — reference CLIP_MODEL_DIC utils/extras.py:116-120
    "vitb32_clip": _vit("ViT-B/32", 32, 768, 12, 12, 512, True),
    "vitb16_clip": _vit("ViT-B/16", 16, 768, 12, 12, 512, True),
    "vitb32_openclip_openai": _vit("ViT-B-32-quickgelu", 32, 768, 12, 12, 512, True),
    "vitb16_openclip_openai": _vit("ViT-B-16", 16, 768, 12, 12, 512, True),
    "vitl14_openclip_openai": _vit(
        "ViT-L-14", 14, 1024, 24, 16, 768, True,
        text_width=768, text_heads=12, text_layers=12),
}

@dataclasses.dataclass(frozen=True)
class ResNetConfig:
    """OpenAI's modified ResNet image tower (``models/resnet.py``); the
    text tower of an RN50 model is a ``TextConfig`` as for the ViTs."""
    image_size: int = 224
    width: int = 64
    layers: tuple = (3, 4, 6, 3)
    embed_dim: int = 1024
    heads: int = 32          # attention-pool heads
    quick_gelu: bool = True  # text tower activation (vision uses ReLU)

    @property
    def seq_len(self) -> int:  # attnpool tokens: the grid and its mean
        g = self.image_size // 32
        return g * g + 1


def _rn50(name):
    return CLIPConfig(
        name=name,
        vision=ResNetConfig(image_size=224, width=64, layers=(3, 4, 6, 3),
                            embed_dim=1024, heads=32, quick_gelu=True),
        text=TextConfig(width=512, heads=8, layers=12, embed_dim=1024,
                        quick_gelu=True),
    )


MODEL_REGISTRY["rn50_openclip_openai"] = _rn50("RN50")
MODEL_REGISTRY["rn50_clip"] = _rn50("RN50")

# tiny config for unit tests (not in the reference)
MODEL_REGISTRY["test_tiny"] = CLIPConfig(
    name="test-tiny",
    vision=VisionConfig(image_size=32, patch_size=8, width=64, layers=2,
                        heads=4, embed_dim=32, quick_gelu=True),
    text=TextConfig(context_length=16, vocab_size=512, width=32, layers=2,
                    heads=4, embed_dim=32, quick_gelu=True),
)


def get_model_config(model_cfg: str) -> CLIPConfig:
    if model_cfg not in MODEL_REGISTRY:
        raise KeyError(
            f"unknown model_cfg {model_cfg!r}; known: {sorted(MODEL_REGISTRY)}")
    return MODEL_REGISTRY[model_cfg]
