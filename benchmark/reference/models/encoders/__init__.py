"""The reference's encoder parts, one file per ``ENCODER_TYPE``.

``<ENCODER_TYPE>.py`` in this directory exposes ``build(config, dtype)``:
the encoder as an ``nn.Module`` whose call is the program's encoder call,
``(src, spatial_shapes, valid_ratios, pos, padding_mask) -> memory``, and
whose parameter names are the program's under ``transformer.encoder``.
``build`` below finds the part by its file, as the harness finds a
metric's reader, so a configuration with another encoder brings its part
as a new file and edits nothing here.
"""
from __future__ import annotations

import importlib.util
import sys
from pathlib import Path

import torch
from torch import nn

HERE = Path(__file__).resolve().parent
ROOT = HERE.parents[3]
DEFAULT = "deformable"


def part_file(encoder_type: str) -> Path:
    return HERE / f"{encoder_type}.py"


def build(config: dict, dtype: torch.dtype) -> nn.Module:
    """The configuration's encoder from its part; a ``ValueError`` that
    names the file to add where there is none."""
    kind = config.get("ENCODER_TYPE") or DEFAULT
    path = part_file(str(kind))
    if not (isinstance(kind, str) and kind.isidentifier() and path.is_file()):
        raise ValueError(
            f"the reference has no part for ENCODER_TYPE={kind!r}: add "
            f"{path.relative_to(ROOT)} with build(config, dtype)")
    name = f"{__name__}.{kind}"
    if name not in sys.modules:
        spec = importlib.util.spec_from_file_location(name, path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[name] = mod
        spec.loader.exec_module(mod)
    return sys.modules[name].build(config, dtype)
