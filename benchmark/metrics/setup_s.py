"""Seconds from the start of set-up (model, weights, inputs) to the end of
the warm-up over the cell's own shapes."""


def read(run):
    return run.setup_s
