"""The port's checkpoint files and pretrained-weight key remaps.

- ``save_checkpoint`` / ``load_checkpoint``: one torch file per checkpoint
  in the reference's format, ``{"model": state_dict, "optimizer": ...,
  "states": {"start_epoch", "global_iters"}}`` (the ``model`` entry is what
  ``engine/submit.load_state_dict_file`` reads), plus ``"rng"``: the host
  generators' states (``random``, ``np.random``) and the track-selection
  generator's, so that a resumed run draws what an unbroken one would.
  Every entry is tensors, numbers, strings and containers of them, so the
  file loads with ``weights_only=True``.
- ``remap_pretrained_dab`` (counterpart of
  ``memotr_tpu/checkpoint/torch_convert.remap_pretrained_dab``): the
  reference's key remaps of a DAB-Deformable-DETR checkpoint into
  reference MeMOTR names, which are the port's.
"""
from __future__ import annotations

import os
import random
import re
from typing import Dict, Optional

import numpy as np
import torch


def remap_pretrained_dab(sd: Dict[str, torch.Tensor], num_classes: int
                         ) -> Dict[str, torch.Tensor]:
    """The class head's rows 1:1+K of COCO's 91 (dropped for more than 3
    classes: BDD100K keeps its own init), ``query_embed`` / ``tgt_embed``
    -> ``det_query_embed``, ``refpoint_embed`` -> ``det_anchor``, and the
    ``backbone.0.body`` / ``input_proj`` prefixes."""
    out = {}
    for k, v in sd.items():
        if "class_embed" in k and v.dim() >= 1 and v.shape[0] > 8:
            if num_classes in (1, 2, 3):
                out[k] = v[1:1 + num_classes]
        elif re.match(r"^(transformer\.)?(query_embed|tgt_embed)", k):
            out["det_query_embed"] = v
        elif "refpoint_embed" in k:
            out["det_anchor"] = v
        elif k.startswith("backbone.0.body"):
            out["backbone.backbone.backbone" + k[15:]] = v
        elif k.startswith("input_proj"):
            out["feature_projs" + k[10:]] = v
        else:
            out[k] = v
    return out


def host_rng_state(generator: Optional[torch.Generator] = None) -> Dict:
    """The states of ``random``, ``np.random`` and ``generator``."""
    name, keys, pos, has_gauss, cached = np.random.get_state()
    state = {"python": random.getstate(),
             "numpy": {"name": name,
                       "keys": torch.from_numpy(keys.astype(np.int64)),
                       "pos": int(pos), "has_gauss": int(has_gauss),
                       "cached_gaussian": float(cached)}}
    if generator is not None:
        state["generator"] = generator.get_state()
    return state


def set_host_rng_state(state: Dict,
                       generator: Optional[torch.Generator] = None) -> None:
    version, internal, gauss = state["python"]
    random.setstate((version, tuple(internal), gauss))
    n = state["numpy"]
    np.random.set_state((n["name"], n["keys"].numpy().astype(np.uint32),
                         n["pos"], n["has_gauss"], n["cached_gaussian"]))
    if generator is not None and "generator" in state:
        generator.set_state(state["generator"])


def save_checkpoint(path: str, model: torch.nn.Module,
                    optimizer: Optional[torch.optim.Optimizer] = None,
                    states: Optional[Dict[str, int]] = None,
                    rng: Optional[Dict] = None) -> None:
    """Writes ``{"model"[, "optimizer", "states", "rng"]}`` to ``path``
    (the model's tensors on the CPU); the file appears whole or not at
    all."""
    ckpt = {"model": {k: v.detach().cpu()
                      for k, v in model.state_dict().items()}}
    if optimizer is not None:
        ckpt["optimizer"] = optimizer.state_dict()
    if states is not None:
        ckpt["states"] = {k: int(v) for k, v in states.items()}
    if rng is not None:
        ckpt["rng"] = rng
    tmp = f"{path}.tmp"
    torch.save(ckpt, tmp)
    os.replace(tmp, path)


def load_checkpoint(path: str) -> Dict:
    return torch.load(path, map_location="cpu", weights_only=True)
