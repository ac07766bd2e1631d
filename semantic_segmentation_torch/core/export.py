"""Serving export: the trained segmenter as one ``torch.export`` artifact
(program and weights) — the port of ``semantic_segmentation_tpu/core/
export.py``.

The artifact keeps the JAX artifact's interface, so a serving client does
not care which package wrote it: (N, H, W, C) float images in [0, 1] in;
sigmoid probabilities (N, H, W) for one class, softmax (N, H, W, classes)
for more, out, with no threshold (the evaluate() protocol of
``unet/evaluate.py:29-33`` minus the final threshold/argmax). The batch
dimension is symbolic (``torch.export.Dim``) unless pinned; torch
specialises an example dimension of size 0 or 1, so the program is traced
at batch 2 (or the pinned batch).

``model.compute_dtype=bfloat16`` exports the net's forward inside
``torch.autocast`` (captured in the program as a ``wrap_with_autocast``
region on the export device's type), which computes what the eager eval
computes; ``float32`` exports it without.
"""

from __future__ import annotations

import contextlib

import torch
import torch._dynamo.exc
import torch.fx.experimental._config


class Predict(torch.nn.Module):
    """images (N, H, W, C) -> probabilities, the net in eval mode."""

    def __init__(self, net: torch.nn.Module, n_classes: int,
                 compute_dtype: str = "float32"):
        super().__init__()
        self.net, self.n_classes = net.eval(), n_classes
        if compute_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"compute_dtype {compute_dtype!r}")
        self.bf16 = compute_dtype == "bfloat16"

    def forward(self, images):
        x = images.float().permute(0, 3, 1, 2)
        amp = (torch.autocast(x.device.type, dtype=torch.bfloat16)
               if self.bf16 else contextlib.nullcontext())
        with amp:
            logits = self.net(x)
        if self.n_classes == 1:
            return torch.sigmoid(logits[:, 0].float())
        return torch.softmax(logits.float(), dim=1).permute(0, 2, 3, 1)


def make_predict_fn(net: torch.nn.Module, n_classes: int,
                    compute_dtype: str = "float32") -> Predict:
    """The inference module over ``net``'s frozen weights."""
    return Predict(net, n_classes, compute_dtype)


def export_seg(net: torch.nn.Module, n_classes: int, image_size: int,
               n_channels: int, batch: int = 0,
               compute_dtype: str = "float32"):
    """The ``torch.export.ExportedProgram`` of the predict head on the
    device ``net`` lives on. ``batch`` 0 exports a symbolic batch
    dimension (one artifact, any batch size); a positive value pins it."""
    predict = make_predict_fn(net, n_classes, compute_dtype)
    device = next(net.parameters()).device
    example = torch.rand(batch if batch > 0 else 2, image_size, image_size,
                         n_channels, device=device)
    if batch > 0:
        with torch.no_grad():
            return torch.export.export(predict, (example,))
    # cuDNN's convolutions take a batch of at most 65535
    dynamic = {"images": {0: torch.export.Dim("batch", min=1, max=65535)}}
    try:
        with torch.no_grad():
            return torch.export.export(predict, (example,),
                                       dynamic_shapes=dynamic)
    except torch._dynamo.exc.UserError:
        # torch 2.11 traces a dynamic size as 2 or more unless told to
        # trace it obliviously (later versions do so by default)
        with torch.no_grad(), torch.fx.experimental._config.patch(
                backed_size_oblivious=True):
            return torch.export.export(predict, (example,),
                                       dynamic_shapes=dynamic)


def load_exported(path: str):
    """The callable of an artifact written by ``torch.export.save``:
    images on the device it was exported on -> probabilities, without
    autograd."""
    module = torch.export.load(path).module()

    def predict(images):
        with torch.no_grad():
            return module(images)

    return predict
