"""Device ms of everything launched inside the program's ``step.tracker``
and ``step.updater`` spans, mean a step of the traced window."""
from benchmark.metrics.program_spans import device_ms


def read(run):
    return device_ms(run, ("step.tracker", "step.updater"))
