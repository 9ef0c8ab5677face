"""Device operations (kernels, copies, sets) launched inside the program's
``submit.step`` span, mean a step of the traced window."""
from benchmark.metrics.program_spans import device_per_step


def read(run):
    got = device_per_step(run, ("submit.step",))
    return None if got is None else got[0]
