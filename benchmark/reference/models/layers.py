"""Shared building blocks (counterpart of ``memotr_tpu/models/layers.py``).

Parameters are float32; matmuls run in the module's compute dtype
(``dtype``), and LayerNorm runs in float32 with eps 1e-5.  Names follow the
reference ``state_dict``: ``MLP.layers.{i}``, ``FFN.linear1/linear2/norm``,
and the joint ``in_proj_weight``/``in_proj_bias`` of
``nn.MultiheadAttention``.  Only inference is referenced, so there is
no dropout.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn


class Linear(nn.Linear):
    """``nn.Linear`` that runs in ``compute_dtype`` with float32 parameters."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__(in_features, out_features, bias=bias)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        bias = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), bias)


class LayerNorm(nn.LayerNorm):
    """LayerNorm computed in float32 whatever the input dtype."""

    def __init__(self, n: int):
        super().__init__(n, eps=1e-5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.float(), self.normalized_shape, self.weight,
                            self.bias, self.eps)


class MLP(nn.Module):
    """Linear stack with ReLU between layers, none after the last."""

    def __init__(self, input_dim: int, hidden_dim: int, output_dim: int,
                 num_layers: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        dims = [input_dim] + [hidden_dim] * (num_layers - 1) + [output_dim]
        self.layers = nn.ModuleList(
            Linear(dims[i], dims[i + 1], compute_dtype=dtype)
            for i in range(num_layers))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < len(self.layers) - 1:
                x = F.relu(x)
        return x


class FFN(nn.Module):
    """linear-relu-linear + residual + LayerNorm."""

    def __init__(self, d_model: int, d_ffn: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.linear1 = Linear(d_model, d_ffn, compute_dtype=dtype)
        self.linear2 = Linear(d_ffn, d_model, compute_dtype=dtype)
        self.norm = LayerNorm(d_model)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.linear2(F.relu(self.linear1(x)))
        return self.norm(x + h)


class MultiheadAttention(nn.Module):
    """Dot-product attention with ``nn.MultiheadAttention`` semantics and
    parameter layout, written out in plain torch ops (batch-first).

    ``key_padding_mask`` True = ignore that key; masked logits are filled
    with ``finfo(float32).min`` and the softmax runs in float32.
    """

    def __init__(self, embed_dim: int, num_heads: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        assert embed_dim % num_heads == 0
        self.num_heads = num_heads
        self.dtype = dtype
        self.in_proj_weight = nn.Parameter(torch.empty(3 * embed_dim, embed_dim))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * embed_dim))
        self.out_proj = Linear(embed_dim, embed_dim, compute_dtype=dtype)
        nn.init.xavier_uniform_(self.in_proj_weight)

    def forward(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                key_padding_mask: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        dt = self.dtype
        e = q.shape[-1]
        w = self.in_proj_weight.to(dt)
        bias = self.in_proj_bias.to(dt)
        qp = F.linear(q.to(dt), w[:e], bias[:e])
        kp = F.linear(k.to(dt), w[e:2 * e], bias[e:2 * e])
        vp = F.linear(v.to(dt), w[2 * e:], bias[2 * e:])

        def split(x):
            b, n, _ = x.shape
            return x.view(b, n, self.num_heads, -1).transpose(1, 2)

        qh, kh, vh = split(qp), split(kp), split(vp)
        head_dim = e // self.num_heads
        scale = torch.tensor(head_dim, dtype=torch.float32).sqrt().to(dt)
        # the mask fill happens in float32: finfo(float32).min overflows bf16
        logits = (torch.matmul(qh, kh.transpose(-1, -2)) / scale).float()
        if key_padding_mask is not None:
            neg = torch.finfo(torch.float32).min
            logits = logits.masked_fill(key_padding_mask[:, None, None, :],
                                        neg)
        attn = torch.softmax(logits, dim=-1).to(vh.dtype)
        out = torch.matmul(attn, vh)
        b, h, n, d = out.shape
        return self.out_proj(out.transpose(1, 2).reshape(b, n, h * d))
