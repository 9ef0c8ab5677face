"""The program's window attention (K2) runs without its position bias,
in every window and grid layer of the windowed and hybrid encoders."""
from __future__ import annotations

ENCODERS = ("windowed", "hybrid")


def plant(patch) -> None:
    from memotr_tpu_torch.models import windowed_encoder
    orig = windowed_encoder.window_attention

    def attention(x, pos, mask, w_in, b_in, w_out, b_out, bias, *rest):
        return orig(x, pos, mask, w_in, b_in, w_out, b_out, None, *rest)
    patch(windowed_encoder, "window_attention", attention)
