"""Device ms of everything launched inside the program's ``encoder.attn``
spans (the windowed layers' padding, grid transpose, K2 and crop), mean a
step of the traced window."""
from benchmark.metrics.program_spans import device_ms


def read(run):
    return device_ms(run, ("encoder.attn",))
