"""Conv-neck encoder, ``ENCODER_TYPE: conv`` (counterpart of
``memotr_tpu/models/conv_encoder.py``).

Per layer, per pyramid level, a pre-norm residual conv block

    x = x + Conv3x3(LN(x));  x = x + W2 relu(W1 LN(x))

with padded pixels zeroed before the conv, so padding never reaches the
valid region; then the windowed encoder's cross-level fusion
(``cross_level_fuse``).  A final LayerNorm closes the stack.  Dropout
follows the conv and the FFN's hidden activation and output, per level;
``USE_CHECKPOINT`` checkpoints each layer (``models/dropout.py``).  The sine
position embeddings are unused (the convolution carries position); the
decoder still gets them.  The 3x3 conv and the dense layers are library
calls (cuDNN, cuBLAS): no hand-written kernel.

Parameter names are the JAX trees' under the port's module names
(``layers.<i>.{conv3x3, norm1, linear1, linear2, norm2, topdown_mix,
bottomup_mix}``, ``final_norm``), so ``checkpoint/convert.py`` maps a JAX
model onto it (the conv kernel HWIO -> OIHW).
"""
from __future__ import annotations

from typing import List

import torch
import torch.nn.functional as F
from torch import nn

from .dropout import Dropout, run_layer
from .layers import LayerNorm, Linear
from .resnet import Conv2d
from .windowed_encoder import (Shapes, cross_level_fuse, flatten_levels,
                               split_levels)


class ConvEncoderLayer(nn.Module):
    def __init__(self, d_model: int, d_ffn: int, n_levels: int,
                 use_bottomup: bool = True,
                 dtype: torch.dtype = torch.float32, dropout: float = 0.0):
        super().__init__()
        self.dropout_conv = Dropout(dropout)
        self.dropout_hidden = Dropout(dropout)
        self.dropout_ffn = Dropout(dropout)
        self.conv3x3 = Conv2d(d_model, d_model, 3, padding=1,
                              compute_dtype=dtype)
        self.norm1 = LayerNorm(d_model)
        self.linear1 = Linear(d_model, d_ffn, compute_dtype=dtype)
        self.linear2 = Linear(d_ffn, d_model, compute_dtype=dtype)
        self.norm2 = LayerNorm(d_model)
        # the JAX layer creates the mixes only where fusion runs
        multi = n_levels > 1
        self.topdown_mix = Linear(d_model, d_model, compute_dtype=dtype) \
            if multi else None
        self.bottomup_mix = Linear(d_model, d_model, compute_dtype=dtype) \
            if multi and use_bottomup else None

    def forward(self, levels: List[torch.Tensor], masks: List[torch.Tensor]
                ) -> List[torch.Tensor]:
        """levels (B, H_l, W_l, C); masks (B, H_l, W_l) True = pad."""
        out = []
        for lvl, (x, m) in enumerate(zip(levels, masks)):
            xz = self.norm1(x).to(x.dtype).masked_fill(m[..., None], 0.0)
            c = self.conv3x3(xz.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
            x = x + self.dropout_conv(c, call=lvl)
            h = F.relu(self.linear1(self.norm2(x).to(x.dtype)))
            f = self.linear2(self.dropout_hidden(h, call=lvl))
            x = x + self.dropout_ffn(f, call=lvl)
            out.append(x)
        return cross_level_fuse(out, self.topdown_mix, self.bottomup_mix)


class ConvEncoder(nn.Module):
    """Drop-in replacement for the deformable ``Encoder`` (same forward
    signature)."""

    def __init__(self, num_layers: int, d_model: int, d_ffn: int,
                 n_levels: int, use_bottomup: bool = True,
                 dtype: torch.dtype = torch.float32, dropout: float = 0.0,
                 use_checkpoint: bool = False):
        super().__init__()
        self.use_checkpoint = use_checkpoint
        self.layers = nn.ModuleList(
            ConvEncoderLayer(d_model, d_ffn, n_levels, use_bottomup, dtype,
                             dropout)
            for _ in range(num_layers))
        self.final_norm = LayerNorm(d_model)

    def forward(self, src: torch.Tensor, spatial_shapes: Shapes,
                valid_ratios: torch.Tensor, pos: torch.Tensor,
                padding_mask: torch.Tensor) -> torch.Tensor:
        del valid_ratios, pos
        levels = split_levels(src, spatial_shapes)
        masks = split_levels(padding_mask, spatial_shapes)
        for layer in self.layers:
            levels = run_layer(layer, levels, masks,
                               use_checkpoint=self.use_checkpoint)
        return flatten_levels([self.final_norm(lv).to(lv.dtype)
                               for lv in levels])
