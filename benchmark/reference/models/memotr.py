"""MeMOTR top-level model (counterpart of ``memotr_tpu/models/memotr.py``).

One frame in, detection + track predictions out: ResNet-50 -> three 1x1
projections of layer2/3/4 plus a 3x3 stride-2 level off layer4, each with
GroupNorm(32) in float32 and a sine position embedding of its downsampled
mask -> DAB detection queries concatenated with the fixed track slots ->
deformable transformer with per-layer class/box heads.

Parameter names follow the reference MeMOTR ``state_dict`` (the key set
``memotr_tpu/checkpoint/torch_convert.py`` parses), so a reference ``.pth``
loads with ``load_state_dict`` and ``convert_torch_state_dict`` turns this
model's state dict into the JAX parameter trees.  The query updater is a
submodule (``query_updater.*``), as in the reference.  Only what the
benchmark's cells run is here: DAB queries, inference, and the encoder of
each ``ENCODER_TYPE`` that has a part (``encoders/<ENCODER_TYPE>.py``);
``build_model`` refuses any other option.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn

from ..utils.misc import inverse_sigmoid
from . import encoders
from .decoder import bbox_head
from .layers import Linear
from .position_embedding import sine_position_embedding
from .query_updater import QueryUpdater
from .resnet import Conv2d, ResNet50
from .transformer import DeformableTransformer

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
NUM_CLASSES = {"DanceTrack": 1, "SportsMOT": 1, "MOT17": 1, "MOT17_SPLIT": 1,
               "BDD100K": 8}
# options the reference does not implement, with the value it assumes (an
# ENCODER_TYPE is implemented where it has a part: ``encoders.build``)
UNSUPPORTED = {"USE_DAB": True, "DROPOUT": 0.0, "EXTRA_TRACK_ATTN": False}


def _downsample_mask(mask: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Nearest downsample of a (B, H, W) bool mask with source index
    ``floor(i * H_in / H_out)``, as torch's ``F.interpolate(mode="nearest")``
    computes it on the reference's float mask."""
    _, hh, ww = mask.shape
    ri = torch.arange(h, device=mask.device) * hh // h
    ci = torch.arange(w, device=mask.device) * ww // w
    return mask[:, ri][:, :, ci]


class GroupNorm32(nn.GroupNorm):
    """GroupNorm computed in float32 whatever the input dtype.  A group of
    one value (a 1x1 level with as many groups as channels) normalizes to
    0, as flax's GroupNorm computes it; torch's ``group_norm`` refuses a
    batch of one such sample, so that case is written out."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float()
        if x[0].numel() == self.num_groups:
            shape = (1, -1) + (1,) * (x.dim() - 2)
            return (x - x) * self.weight.view(shape) + self.bias.view(shape)
        return F.group_norm(x, self.num_groups, self.weight, self.bias,
                            self.eps)


class MeMOTR(nn.Module):
    def __init__(self, encoder: nn.Module, num_classes: int = 1,
                 n_det_queries: int = 300, n_feature_levels: int = 4,
                 hidden_dim: int = 256, ffn_dim: int = 1024, n_heads: int = 8,
                 n_dec_points: int = 4, n_dec_layers: int = 6,
                 merge_det_track_layer: int = 0,
                 update_threshold: float = 0.5,
                 long_memory_lambda: float = 0.01,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        c = hidden_dim
        self.num_classes = num_classes
        self.n_det_queries = n_det_queries
        self.hidden_dim = c
        self.n_dec_layers = n_dec_layers
        self.n_feature_levels = n_feature_levels
        self.dtype = dtype
        # reference nesting: backbone.backbone.backbone.<torchvision names>
        self.backbone = nn.ModuleDict(
            {"backbone": nn.ModuleDict({"backbone": ResNet50(dtype)})})
        projs = []
        in_ch = ResNet50.num_channels
        for i in range(n_feature_levels):
            if i < len(in_ch):
                conv = Conv2d(in_ch[i], c, 1, compute_dtype=dtype)
            else:
                conv = Conv2d(in_ch[-1] if i == len(in_ch) else c, c, 3,
                              stride=2, padding=1, compute_dtype=dtype)
            projs.append(nn.Sequential(conv, GroupNorm32(min(32, c), c)))
        self.feature_projs = nn.ModuleList(projs)

        self.det_query_embed = nn.Parameter(torch.randn(n_det_queries, c))
        self.det_anchor = nn.Parameter(torch.randn(n_det_queries, 4))

        self.transformer = DeformableTransformer(
            encoder, d_model=c, d_ffn=ffn_dim, n_levels=n_feature_levels,
            n_heads=n_heads, n_dec_points=n_dec_points,
            n_dec_layers=n_dec_layers, n_det_queries=n_det_queries,
            merge_det_track_layer=merge_det_track_layer, dtype=dtype)

        prior = -torch.log(torch.tensor((1 - 0.01) / 0.01)).item()
        self.class_embed = nn.ModuleList()
        for _ in range(n_dec_layers):
            head = Linear(c, num_classes, compute_dtype=torch.float32)
            nn.init.constant_(head.bias, prior)
            self.class_embed.append(head)
        self.bbox_embed = nn.ModuleList(
            bbox_head(c, -2.0 if i == 0 else 0.0, dtype)
            for i in range(n_dec_layers))
        # the reference shares the box heads with the decoder's refinement,
        # so its state dict carries them twice
        self.transformer.decoder.bbox_embed = self.bbox_embed

        self.query_updater = QueryUpdater(
            c, ffn_dim, update_threshold=update_threshold,
            long_memory_lambda=long_memory_lambda, dtype=dtype)

    def forward(self, images: torch.Tensor, img_mask: torch.Tensor,
                track_query_embed: torch.Tensor, track_ref_pts: torch.Tensor,
                track_mask: torch.Tensor) -> Dict[str, torch.Tensor]:
        """images (B, H, W, 3) normalized; img_mask (B, H, W) True = pad;
        track_query_embed (B, S, C); track_ref_pts (B, S, 4) logit space;
        track_mask (B, S) True = live slot.

        Returns (L = decoder layers, N = Nd + S): pred_logits (B, N, K),
        pred_boxes (B, N, 4), last_ref_pts (B, N, 4) logit space,
        det_query_embed, outputs (B, N, C) and queries (L, B, N, C)."""
        b = images.shape[0]
        # NHWC -> NCHW view with channels_last strides (no copy)
        x = images.permute(0, 3, 1, 2).to(self.dtype)
        feats = self.backbone["backbone"]["backbone"](x)

        srcs, masks, poss = [], [], []
        for i, proj in enumerate(self.feature_projs):
            inp = feats[i] if i < len(feats) else \
                (feats[-1] if i == len(feats) else srcs[-1])
            src = proj(inp)
            m = _downsample_mask(img_mask, src.shape[2], src.shape[3])
            srcs.append(src.to(self.dtype))
            masks.append(m)
            poss.append(sine_position_embedding(m, self.hidden_dim // 2))

        det_query = self.det_query_embed
        det_refs = self.det_anchor
        ref_pts = torch.cat([det_refs[None].expand(b, -1, -1),
                             track_ref_pts.float()], dim=1)
        query_embed = torch.cat(
            [det_query[None].expand(b, -1, -1).to(self.dtype),
             track_query_embed.to(self.dtype)], dim=1)
        query_mask = torch.cat(
            [torch.zeros((b, self.n_det_queries), dtype=torch.bool,
                         device=images.device), ~track_mask], dim=1)

        dec = self.transformer(srcs, masks, poss, query_embed, ref_pts,
                               query_mask, self.class_embed)
        # refs[-2] is the reference entering the last layer
        last_ref = dec["refs"][-2] if self.n_dec_layers > 1 \
            else dec["init_reference"]
        return {
            "pred_logits": dec["logits"][-1],
            "pred_boxes": dec["boxes"][-1],
            "last_ref_pts": inverse_sigmoid(last_ref),
            "det_query_embed": det_query,
            "outputs": dec["outputs"][-1].float(),
            "queries": dec["queries"],
        }


def build_model(config: dict) -> MeMOTR:
    """Build from a flat UPPER_CASE config (the keys of
    ``memotr_tpu.models.memotr.build_model``); refuses the options the
    reference does not implement, and an ``ENCODER_TYPE`` without a
    part."""
    for key, value in UNSUPPORTED.items():
        if config.get(key, value) != value:
            raise ValueError(f"the reference implements {key}={value!r} "
                             f"only, not {config[key]!r}")
    dtype = DTYPES[config.get("DTYPE", "bfloat16")]
    return MeMOTR(
        encoders.build(config, dtype),
        num_classes=NUM_CLASSES[config["DATASET"]],
        n_det_queries=config["NUM_DET_QUERIES"],
        n_feature_levels=config["NUM_FEATURE_LEVELS"],
        hidden_dim=config["HIDDEN_DIM"],
        ffn_dim=config["FFN_DIM"],
        n_heads=config["NUM_HEADS"],
        n_dec_points=config["NUM_DEC_POINTS"],
        n_dec_layers=config["NUM_DEC_LAYERS"],
        merge_det_track_layer=config.get("MERGE_DET_TRACK_LAYER", 0),
        update_threshold=config.get("UPDATE_THRESH", 0.5),
        long_memory_lambda=config.get("LONG_MEMORY_LAMBDA", 0.01),
        dtype=dtype,
    )
