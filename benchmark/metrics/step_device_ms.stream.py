"""Device ms of everything launched inside the program's ``submit.step``
span, mean a step of the traced window: the device's own time a step."""
from benchmark.metrics.program_spans import device_ms


def read(run):
    return device_ms(run, ("submit.step",))
