"""VGG-16 in PyTorch — the paper's own evaluation model.

The port of ``repro/models/vgg.py``.  Parameters keep the reference's
layouts, so the ``.npz`` bridge carries them leaf for leaf: convolution
weights HWIO ``(k, k, in, out)``, dense weights ``(in, out)``.  Images come
in NHWC, as in the reference; ``forward`` runs the convolutions in NCHW
(``F.conv2d`` with the weights permuted to OIHW, padding ``k // 2``: the
reference's ``SAME`` for the odd kernels), adds the bias, then ReLU, then a
2x2/2 max pool where ``pool_after`` is set.  Before the first dense layer
the activations are flattened in NHWC order (H, W, C), the order of
``fc6``'s rows.  No ReLU after the last dense layer.  The reference
computes the convolutions with ``lax.conv`` outside any Pallas kernel;
here they are library calls (cuDNN on the card).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch._device import DeviceLike
from repro_torch.configs.vgg16 import ConvSpec, VGGConfig
from repro_torch.models.layers import ParamSpec, init_params, softmax_xent


def vgg_schema(vcfg: VGGConfig) -> dict:
    schema: dict = {}
    for spec in vcfg.layers:
        if isinstance(spec, ConvSpec):
            schema[spec.name] = {
                "w": ParamSpec(
                    (spec.kernel, spec.kernel, spec.in_ch, spec.out_ch),
                    ("norm", "norm", "embed", "mlp"),
                ),
                "b": ParamSpec((spec.out_ch,), ("mlp",), init="zeros"),
            }
        else:
            schema[spec.name] = {
                "w": ParamSpec((spec.in_dim, spec.out_dim), ("embed", "mlp")),
                "b": ParamSpec((spec.out_dim,), ("mlp",), init="zeros"),
            }
    return schema


def forward(params: dict, images, vcfg: VGGConfig) -> torch.Tensor:
    """images: (B, H, W, 3) -> logits (B, num_classes)."""
    h = torch.as_tensor(images).permute(0, 3, 1, 2)  # NCHW
    last = vcfg.layers[-1].name
    for spec in vcfg.layers:
        p = params[spec.name]
        if isinstance(spec, ConvSpec):
            h = F.conv2d(h, p["w"].permute(3, 2, 0, 1), p["b"], padding=spec.kernel // 2)
            h = F.relu(h)
            if spec.pool_after:
                h = F.max_pool2d(h, kernel_size=2, stride=2)
        else:
            if h.dim() == 4:
                h = h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)  # NHWC order
            h = h @ p["w"] + p["b"]
            if spec.name != last:
                h = F.relu(h)
    return h


def loss_fn(params: dict, batch: dict, vcfg: VGGConfig) -> tuple:
    logits = forward(params, batch["images"], vcfg)
    labels = torch.as_tensor(batch["labels"], device=logits.device).long()
    xent = softmax_xent(logits[:, None, :], labels[:, None])
    return xent, {"loss": xent}


def init(generator: torch.Generator, vcfg: VGGConfig, device: DeviceLike = None) -> dict:
    """Random parameters with the reference's std rules, on ``device``
    (default: the card), from ``generator`` (which lives there)."""
    return init_params(vgg_schema(vcfg), generator, device)
