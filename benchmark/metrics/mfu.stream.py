"""Model FLOPs a frame (``counting.stream_frame_flops``: matrix products
and convolutions) x frames/s of the run's untraced window (host clock) /
the peak of the configuration's dtype, in %."""
from benchmark.metrics.common import stream_mfu


def read(run):
    return stream_mfu(run)
