"""Device ms of everything launched inside the program's ``encoder.ffn``
spans (the windowed layers' residual add, norms and FFN), mean a step of
the traced window."""
from benchmark.metrics.program_spans import device_ms


def read(run):
    return device_ms(run, ("encoder.ffn",))
