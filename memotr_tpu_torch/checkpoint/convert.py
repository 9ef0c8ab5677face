"""JAX parameter trees -> reference-format PyTorch state dict.

The inverse of ``memotr_tpu.checkpoint.torch_convert.convert_torch_state_dict``
(numpy only; tensors are made at the end):

- Dense ``kernel (in, out)`` -> Linear ``weight (out, in)`` (transpose);
- Conv ``kernel`` HWIO -> OIHW;
- LayerNorm/GroupNorm ``scale`` -> ``weight``;
- separate ``q_proj``/``k_proj``/``v_proj`` -> the joint ``in_proj_weight`` /
  ``in_proj_bias`` of ``nn.MultiheadAttention``;
- the ``frozen`` collection -> FrozenBatchNorm buffers;
- the box heads also under the decoder alias ``transformer.decoder.bbox_embed``.

Trees are nested dicts of array-likes (``np.asarray`` is applied to every
leaf), so Orbax-restored JAX params convert without importing JAX here.
"""
from __future__ import annotations

import re
from typing import Dict, Iterator, Tuple

import numpy as np
import torch


def _leaves(tree: Dict, prefix: Tuple[str, ...] = ()
            ) -> Iterator[Tuple[Tuple[str, ...], np.ndarray]]:
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def _module_name(path: Tuple[str, ...], tree: str) -> str:
    """Flax module path (without the leaf name) -> torch module name."""
    if tree == "updater":
        p = list(path)
        if p[0] == "confidence_weight_net":
            p[0] = "confidence_weight_net.0"
        return "query_updater." + ".".join(p).replace("layers_", "layers.")
    head, rest = path[0], list(path[1:])
    if head == "backbone":
        names = ["backbone.backbone.backbone"]
        for r in rest:
            m = re.fullmatch(r"layer(\d)_(\d+)", r)
            if m:
                names.append(f"layer{m.group(1)}.{m.group(2)}")
            else:
                names.append({"downsample_conv": "downsample.0",
                              "downsample_bn": "downsample.1"}.get(r, r))
        return ".".join(names)
    m = re.fullmatch(r"feature_proj_(\d+)_(conv|norm)", head)
    if m:
        return f"feature_projs.{m.group(1)}.{0 if m.group(2) == 'conv' else 1}"
    if head == "reference_points":
        return "transformer.reference_points"
    assert head == "transformer", path
    stack, rest = rest[0], rest[1:]
    if stack == "decoder" and rest:
        m = re.fullmatch(r"(class_embed|bbox_embed)_(\d+)", rest[0])
        if m:
            return ".".join([f"{m.group(1)}.{m.group(2)}"] + rest[1:]
                            ).replace("layers_", "layers.")
    name = ".".join(["transformer", stack] + rest)
    return re.sub(r"layers?_(\d+)", r"layers.\1", name)


def state_dict_from_jax(params: Dict, uparams: Dict, frozen: Dict
                        ) -> Dict[str, torch.Tensor]:
    """(model params, updater params, frozen BN stats) -> state dict that
    ``memotr_tpu_torch.models.memotr.MeMOTR.load_state_dict`` takes with
    ``strict=True``."""
    sd: Dict[str, np.ndarray] = {}
    mha: Dict[str, Dict[str, Dict[str, np.ndarray]]] = {}
    for tree_name, tree in (("model", params), ("updater", uparams)):
        for path, v in _leaves(tree):
            if path == ("transformer", "level_embed"):
                sd["transformer.level_embed"] = v
                continue
            if len(path) == 1:                       # det_query_embed, ...
                sd[path[0]] = v
                continue
            leaf, parent = path[-1], path[:-1]
            if parent[-1] in ("q_proj", "k_proj", "v_proj"):
                base = _module_name(parent[:-1], tree_name)
                mha.setdefault(base, {}).setdefault(leaf, {})[parent[-1]] = v
                continue
            name = _module_name(parent, tree_name)
            if leaf == "kernel":
                sd[name + ".weight"] = v.transpose(3, 2, 0, 1) if v.ndim == 4 \
                    else v.T
            elif leaf == "scale":
                sd[name + ".weight"] = v
            else:
                sd[name + "." + leaf] = v
    for path, v in _leaves(frozen):
        sd[_module_name(path[:-1], "model") + "." + path[-1]] = v
    for base, parts in mha.items():
        sd[base + ".in_proj_weight"] = np.concatenate(
            [parts["kernel"][n].T for n in ("q_proj", "k_proj", "v_proj")])
        sd[base + ".in_proj_bias"] = np.concatenate(
            [parts["bias"][n] for n in ("q_proj", "k_proj", "v_proj")])
    for k in [k for k in sd if k.startswith("bbox_embed.")]:
        sd["transformer.decoder." + k] = sd[k]
    return {k: torch.from_numpy(np.ascontiguousarray(v, dtype=np.float32))
            for k, v in sd.items()}
