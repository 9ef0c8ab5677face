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
submodule (``query_updater.*``), as in the reference.  ``DROPOUT``,
``EXTRA_TRACK_ATTN`` and ``USE_CHECKPOINT`` are those of the JAX package
(``models/dropout.py``, ``models/decoder.py``).
"""
from __future__ import annotations

import warnings
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..config import cfg_get, num_classes_for_dataset
from ..utils.misc import inverse_sigmoid
from ..utils.profiling import span
from .decoder import bbox_head
from .dropout import number_sites
from .layers import Linear
from .position_embedding import sine_position_embedding
from .query_updater import QueryUpdater
from .resnet import Conv2d, ResNet50
from .transformer import DeformableTransformer

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


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
    def __init__(self, num_classes: int = 1, n_det_queries: int = 300,
                 n_feature_levels: int = 4, hidden_dim: int = 256,
                 ffn_dim: int = 1024, n_heads: int = 8, n_enc_points: int = 4,
                 n_dec_points: int = 4, n_enc_layers: int = 6,
                 n_dec_layers: int = 6, merge_det_track_layer: int = 0,
                 use_dab: bool = True,
                 encoder_type: str = "deformable",
                 windowed_window: int = 8, windowed_lepe: bool = True,
                 windowed_bottomup: bool = True,
                 windowed_relpos: bool = True,
                 windowed_prenorm: bool = False,
                 windowed_shared_cpb: bool = False,
                 hybrid_deform_min_level: int = 1,
                 update_threshold: float = 0.5,
                 long_memory_lambda: float = 0.01,
                 dtype: torch.dtype = torch.float32, dropout: float = 0.0,
                 extra_track_attn: bool = False,
                 use_checkpoint: bool = False):
        super().__init__()
        c = hidden_dim
        self.num_classes = num_classes
        self.n_det_queries = n_det_queries
        self.hidden_dim = c
        self.use_dab = use_dab
        self.n_dec_layers = n_dec_layers
        self.n_feature_levels = n_feature_levels
        self.encoder_type = encoder_type
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

        qdim = c if use_dab else 2 * c
        self.det_query_embed = nn.Parameter(torch.randn(n_det_queries, qdim))
        if use_dab:
            self.det_anchor = nn.Parameter(torch.randn(n_det_queries, 4))

        self.transformer = DeformableTransformer(
            d_model=c, d_ffn=ffn_dim, n_levels=n_feature_levels,
            n_heads=n_heads, n_enc_points=n_enc_points,
            n_dec_points=n_dec_points, n_enc_layers=n_enc_layers,
            n_dec_layers=n_dec_layers, n_det_queries=n_det_queries,
            merge_det_track_layer=merge_det_track_layer, use_dab=use_dab,
            encoder_type=encoder_type, window=windowed_window,
            use_lepe=windowed_lepe, use_bottomup=windowed_bottomup,
            use_relpos=windowed_relpos, prenorm=windowed_prenorm,
            shared_cpb=windowed_shared_cpb,
            deform_min_level=hybrid_deform_min_level, dtype=dtype,
            dropout=dropout, extra_track_attn=extra_track_attn,
            use_checkpoint=use_checkpoint)
        if not use_dab:
            # D-DETR infers 2-d reference points from the positional half
            self.transformer.reference_points = nn.Linear(c, 2)

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
            c, ffn_dim, use_dab=use_dab, update_threshold=update_threshold,
            long_memory_lambda=long_memory_lambda, dtype=dtype,
            dropout=dropout)
        number_sites(self)

    def forward(self, images: torch.Tensor, img_mask: torch.Tensor,
                track_query_embed: torch.Tensor, track_ref_pts: torch.Tensor,
                track_mask: torch.Tensor,
                eval_ctx: Optional[Dict] = None) -> Dict[str, torch.Tensor]:
        """images (B, H, W, 3) normalized; img_mask (B, H, W) True = pad;
        track_query_embed (B, S, C or 2C); track_ref_pts (B, S, 4) logit
        space; track_mask (B, S) True = live slot; eval_ctx: the sequence
        constants of ``models/eval_cache.py`` for this ``img_mask`` (sine
        position maps, windowed CPB tables), or None to compute them.

        Returns (L = decoder layers, N = Nd + S): pred_logits (B, N, K),
        pred_boxes (B, N, 4), last_ref_pts / init_ref_pts (B, N, 4) logit
        space, query_mask (B, N), det_query_embed, outputs (B, N, C),
        all_logits (L, B, N, K), all_boxes (L, B, N, 4), queries
        (L, B, N, C), memory (B, S, C) (the encoder's output over the S
        flattened pyramid tokens) and memory_mask (B, S), True = padding."""
        b = images.shape[0]
        with span("model.backbone"):
            # NHWC -> NCHW view with channels_last strides (no copy)
            x = images.permute(0, 3, 1, 2).to(self.dtype)
            feats = self.backbone["backbone"]["backbone"](x)

        srcs, masks, poss = [], [], []
        with span("model.neck"):
            for i, proj in enumerate(self.feature_projs):
                inp = feats[i] if i < len(feats) else \
                    (feats[-1] if i == len(feats) else srcs[-1])
                src = proj(inp)
                m = _downsample_mask(img_mask, src.shape[2], src.shape[3])
                srcs.append(src.to(self.dtype))
                masks.append(m)
                if eval_ctx is None:
                    poss.append(sine_position_embedding(
                        m, self.hidden_dim // 2))
                else:
                    pos = eval_ctx["pos_embeds"][i]
                    if pos.shape[1:3] != m.shape[1:]:
                        raise ValueError(
                            f"eval cache has a {tuple(pos.shape[1:3])} "
                            f"position map for a {tuple(m.shape[1:])} "
                            f"level {i}")
                    poss.append(pos)

        det_query = self.det_query_embed
        if self.use_dab:
            det_refs = self.det_anchor
        else:
            rp = self.transformer.reference_points(det_query[:, :self.hidden_dim])
            det_refs = torch.cat([rp, torch.zeros_like(rp)], dim=-1)
        ref_pts = torch.cat([det_refs[None].expand(b, -1, -1),
                             track_ref_pts.float()], dim=1)
        query_embed = torch.cat(
            [det_query[None].expand(b, -1, -1).to(self.dtype),
             track_query_embed.to(self.dtype)], dim=1)
        query_mask = torch.cat(
            [torch.zeros((b, self.n_det_queries), dtype=torch.bool,
                         device=images.device), ~track_mask], dim=1)

        dec = self.transformer(
            srcs, masks, poss, query_embed, ref_pts, query_mask,
            self.class_embed,
            eval_ctx["cpb_tables"] if eval_ctx is not None else None)
        # refs[-2] is the reference entering the last layer
        last_ref = dec["refs"][-2] if self.n_dec_layers > 1 \
            else dec["init_reference"]
        return {
            "pred_logits": dec["logits"][-1],
            "pred_boxes": dec["boxes"][-1],
            "last_ref_pts": inverse_sigmoid(last_ref),
            "init_ref_pts": inverse_sigmoid(dec["init_reference"]),
            "query_mask": query_mask,
            "det_query_embed": det_query,
            "outputs": dec["outputs"][-1].float(),
            "all_logits": dec["logits"],
            "all_boxes": dec["boxes"],
            "queries": dec["queries"],
            "memory": dec["memory"],
            "memory_mask": dec["memory_mask"],
        }


def build_model(config: dict) -> MeMOTR:
    """Build from a flat UPPER_CASE config; reads the same keys as
    ``memotr_tpu.models.memotr.build_model`` (plus the updater's)."""
    encoder_type = cfg_get(config, "ENCODER_TYPE")
    if (cfg_get(config, "WINDOWED_PRENORM")
            and encoder_type in ("windowed", "hybrid")
            and int(config["HIDDEN_DIM"]) >= 256):
        # the JAX package's measured trap (QUALITY.md round 4)
        warnings.warn(
            "WINDOWED_PRENORM=True with HIDDEN_DIM>=256 is a known-bad "
            "combination (31.2 vs 50.2 HOTA at width 256, QUALITY.md); "
            "use post-norm at deployment width.", stacklevel=2)
    return MeMOTR(
        num_classes=num_classes_for_dataset(config["DATASET"]),
        n_det_queries=config["NUM_DET_QUERIES"],
        n_feature_levels=config["NUM_FEATURE_LEVELS"],
        hidden_dim=config["HIDDEN_DIM"],
        ffn_dim=config["FFN_DIM"],
        n_heads=config["NUM_HEADS"],
        n_enc_points=config["NUM_ENC_POINTS"],
        n_dec_points=config["NUM_DEC_POINTS"],
        n_enc_layers=config["NUM_ENC_LAYERS"],
        n_dec_layers=config["NUM_DEC_LAYERS"],
        merge_det_track_layer=cfg_get(config, "MERGE_DET_TRACK_LAYER"),
        use_dab=cfg_get(config, "USE_DAB"),
        encoder_type=encoder_type,
        windowed_window=int(cfg_get(config, "WINDOW_SIZE")),
        windowed_lepe=bool(cfg_get(config, "WINDOWED_LEPE")),
        windowed_bottomup=bool(cfg_get(config, "WINDOWED_BOTTOMUP")),
        windowed_relpos=bool(cfg_get(config, "WINDOWED_RELPOS")),
        windowed_prenorm=bool(cfg_get(config, "WINDOWED_PRENORM")),
        windowed_shared_cpb=bool(cfg_get(config, "WINDOWED_SHARED_CPB")),
        hybrid_deform_min_level=int(cfg_get(config,
                                            "HYBRID_DEFORM_MIN_LEVEL")),
        update_threshold=cfg_get(config, "UPDATE_THRESH", 0.5),
        long_memory_lambda=cfg_get(config, "LONG_MEMORY_LAMBDA", 0.01),
        dtype=DTYPES[cfg_get(config, "DTYPE")],
        dropout=float(cfg_get(config, "DROPOUT")),
        extra_track_attn=bool(cfg_get(config, "EXTRA_TRACK_ATTN")),
        use_checkpoint=bool(cfg_get(config, "USE_CHECKPOINT")),
    )
