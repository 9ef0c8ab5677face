"""K2 forward (window and grid attention): least time from the calls'
shapes / device time of the kernels launched under the ``window_attn_fwd``
op, in %.  A call's map (B, Hp, Wp, C) is x as the op received it (padded,
grid-transposed), its group size L the bias table's last dimension; calls
without a bias table are left out."""
from benchmark import counting
from benchmark.metrics.common import roofline

OP = "memotr_tpu_torch::window_attn_fwd"
X, BIAS = 0, 7


def read(run):
    heads = run.config["NUM_HEADS"]
    dtype = run.config["DTYPE"]

    def biased(c):
        s = c["shapes"]
        return len(s) > BIAS and s[X] and s[BIAS]

    def bound(c):
        b, h, w, ch = c["shapes"][X]
        return counting.k2_fwd_ms(b, h, w, ch, c["shapes"][BIAS][-1], heads,
                                  True, dtype)
    return roofline(run, OP, biased, bound)
