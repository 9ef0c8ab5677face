"""Host ms of each call of the frame step (the streamer's ``_step``, as
the benchmark times it), mean over the untraced window."""
from benchmark.metrics.common import dispatch_ms


def read(run):
    return dispatch_ms(run)
