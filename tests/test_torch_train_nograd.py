"""``NO_GRAD_FRAMES=1`` against the JAX package (float32, CPU): the 2-frame
clip of test_torch_train_step.py with frame 0 under ``torch.no_grad()``.
Frame 0 adds to the loss but no gradient; the gradients come from frame 1
alone, through the track state frame 0 left.  Loss rtol 1e-4, gradients
as ``_assert_grads_close`` in test_torch_train_step.py states.
"""
import jax
import jax.numpy as jnp
import numpy as np

from memotr_tpu.engine.trainer import make_accum_steps
from memotr_tpu_torch.engine.trainer import BATCH_KEYS, Trainer
from test_torch_port_weights import to_jax_trees
from test_torch_train_step import one_torch_thread  # noqa: F401
from test_torch_train_step import (CFG, _assert_grads_close, _batch,
                                   _jax_setup, _leaves, _port_grads,
                                   _port_model)


def test_no_grad_first_frame_matches_jax():
    cfg = dict(CFG, NO_GRAD_FRAMES=1)
    model = _port_model()
    batch = _batch(model)
    params, uparams, frozen = to_jax_trees(model.state_dict())
    jmodel, jupd, jcrit, opt, cs, labels, trainable = _jax_setup(
        cfg, params, uparams)
    grad_step, _ = make_accum_steps(jmodel, jupd, jcrit, opt, cs, labels, 1)
    jgrads, jlogs = grad_step(
        trainable, {"frozen": frozen},
        {k: jnp.asarray(batch[k]) for k in BATCH_KEYS},
        jax.random.PRNGKey(0), None)
    tr = Trainer(model, cfg, device="cpu")
    logs = tr.grad_step(tr.batch_to_device(batch), tr.generator)
    np.testing.assert_allclose(float(logs["total_loss"]),
                               float(jlogs["total_loss"]), rtol=1e-4)
    want = _leaves(jgrads)
    live = _assert_grads_close(_leaves(_port_grads(model)), want)
    # the updater runs only on frame 0's postprocess: no gradient reaches it
    updater = [k for k in want if "updater" in k]
    assert all(not np.any(want[k]) for k in updater)
    assert live > 0.8 * (len(want) - len(updater))
