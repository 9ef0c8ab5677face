"""Device ms of everything launched inside the program's ``model.decoder``
span, mean a step of the traced window."""
from benchmark.metrics.program_spans import device_ms


def read(run):
    return device_ms(run, ("model.decoder",))
