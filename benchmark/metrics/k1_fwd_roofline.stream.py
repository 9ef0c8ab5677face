"""K1 forward at the encoder's shapes (Lq = S): least time from the calls'
shapes / device time of the kernels launched under the ``msda_fwd`` op,
in %."""
from benchmark import counting
from benchmark.metrics.common import msda_dims, roofline

OP = "memotr_tpu_torch::msda_fwd"


def read(run):
    m, d, levels = msda_dims(run)
    points = run.config["NUM_ENC_POINTS"]
    dtype = run.config["DTYPE"]

    def encoder(c):
        s = c["shapes"]
        return len(s) >= 3 and s[0] and s[2] and s[2][1] == s[0][1]

    def bound(c):
        v, loc = c["shapes"][0], c["shapes"][2]
        return counting.k1_fwd_ms(v[0], v[1], loc[1], m, d, levels, points,
                                  dtype)
    return roofline(run, OP, encoder, bound)
