"""VGG-16 — the paper's own evaluation model (Simonyan & Zisserman 2015).

Used to validate the burst-parallel planner against the paper's claims
(Fig 1/3/5, Fig 9/10, Table 3). This is a CNN so it is described by a layer
list rather than ModelConfig; models/vgg.py consumes it. Input 3x224x224,
global batch = 32 for the strong-scaling experiments (paper Fig 9a).
"""
from __future__ import annotations

from dataclasses import dataclass, field


@dataclass(frozen=True)
class ConvSpec:
    name: str
    in_ch: int
    out_ch: int
    spatial: int       # input H=W
    kernel: int = 3
    pool_after: bool = False


@dataclass(frozen=True)
class DenseSpec:
    name: str
    in_dim: int
    out_dim: int


# Standard VGG-16: 13 conv + 3 dense (paper Table 1: 21 "layers" counts pools)
VGG16_LAYERS = (
    ConvSpec("conv1_1", 3, 64, 224),
    ConvSpec("conv1_2", 64, 64, 224, pool_after=True),
    ConvSpec("conv2_1", 64, 128, 112),
    ConvSpec("conv2_2", 128, 128, 112, pool_after=True),
    ConvSpec("conv3_1", 128, 256, 56),
    ConvSpec("conv3_2", 256, 256, 56),
    ConvSpec("conv3_3", 256, 256, 56, pool_after=True),
    ConvSpec("conv4_1", 256, 512, 28),
    ConvSpec("conv4_2", 512, 512, 28),
    ConvSpec("conv4_3", 512, 512, 28, pool_after=True),
    ConvSpec("conv5_1", 512, 512, 14),
    ConvSpec("conv5_2", 512, 512, 14),
    ConvSpec("conv5_3", 512, 512, 14, pool_after=True),
    DenseSpec("fc6", 512 * 7 * 7, 4096),
    DenseSpec("fc7", 4096, 4096),
    DenseSpec("fc8", 4096, 1000),
)


@dataclass(frozen=True)
class VGGConfig:
    name: str = "vgg16"
    layers: tuple = VGG16_LAYERS
    num_classes: int = 1000
    image_size: int = 224
    # paper Fig 9(a): strong scaling with global batch 32
    global_batch: int = 32


CONFIG = VGGConfig()
