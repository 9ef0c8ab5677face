"""Host ms a step that the dispatch thread spent blocked in the program's
``submit.wait_input`` (on the prefetch queue) or ``submit.wait_writer``
(on the writer's queue), in the traced window.  Read under the profiler,
which slows every thread's host work (about twice): it shows whether and
where the dispatch thread waits on the others, not the untraced wait."""
from benchmark.metrics.program_spans import wait_ms


def read(run):
    return wait_ms(run)
