"""The program's grid layers attend inside contiguous blocks instead of
strided groups: its grid transpose and the inverse are the identity, in
every grid layer of the windowed and hybrid encoders.  Every shape and
bias table stays as it was; the grid transpose is the program's own
layout (the reference partitions the map directly), so this is the fault
of a broken transpose."""
from __future__ import annotations

ENCODERS = ("windowed", "hybrid")


def plant(patch) -> None:
    from memotr_tpu_torch.models import windowed_encoder
    patch(windowed_encoder, "grid_transpose", lambda t, win: t)
    patch(windowed_encoder, "grid_untranspose", lambda t, win: t)
