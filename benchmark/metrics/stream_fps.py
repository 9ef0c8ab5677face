"""Lane-frames whose results the writer wrote inside the window, per
second of the window."""
from benchmark.metrics.common import rate


def read(run):
    return rate(run)
