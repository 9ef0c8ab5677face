"""The port's serving export of the windowed model against the JAX
package's (float32, CPU): tests/test_serving.py's configuration itself
(64x96 frames, C = 32, 12 detection queries, 8 slots, 1 windowed encoder
layer over 4 levels, 2 decoder layers), with the helpers of
``test_torch_serving.py``.  The port's artifact steps 3 frames through K2
(the ``window_attn_fwd`` op, one node a level) and K1 (``msda_fwd``, one
a decoder layer); JAX's ``make_eval_step_packed`` (this file's one JAX
compile) the same frames: ids, labels, alive and overflow equal, boxes and
scores within 1e-4."""
import pytest

from test_serving import CONFIG
from test_torch_serving import assert_rows_match, op_nodes, serve_both
from test_torch_serving import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("serving_windowed") / "artifact")
    return serve_both(CONFIG, out)


def test_windowed_rows_match_jax(served):
    _, got, want = served
    assert_rows_match(got, want)


def test_windowed_graph_holds_the_op_nodes(served):
    assert op_nodes(served[0]) == {
        "window_attn_fwd": CONFIG["NUM_ENC_LAYERS"]
        * CONFIG["NUM_FEATURE_LEVELS"],
        "msda_fwd": CONFIG["NUM_DEC_LAYERS"]}
