"""Share of the traced window in which no operation runs on the device:
1 - (union of the device's operation intervals) / window, in %."""
from benchmark.metrics.common import idle_percent


def read(run):
    return idle_percent(run)
