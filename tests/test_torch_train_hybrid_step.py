"""The port's training gradients of the hybrid MeMOTR against the JAX
package's (float32, CPU).

The tiny model of test_torch_train_windowed_step.py with ``ENCODER_TYPE:
hybrid`` (``HYBRID_DEFORM_MIN_LEVEL`` 1: window / grid attention on level
0, deformable attention on levels 1-3, both in every layer), its JAX trees
filled from a numpy seed and loaded into the port through
``state_dict_from_jax``, on the same 2-frame B=2 clip.  One gradient step
of the port's ``Trainer`` (``grad_step``, CPU) against JAX's
``make_accum_steps`` gradient step (one JAX compile, in the module
fixture): every loss and log (rtol 1e-4) and every parameter's gradient
before clipping, per leaf as ``_assert_grads_close`` in
test_torch_train_step.py holds them.  The deformable ``coarse`` layers'
sampling offsets fall to the "points" group, as JAX's ``label_tree``
gives.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from memotr_tpu.engine.trainer import make_accum_steps
from memotr_tpu_torch.engine import trainer as port_trainer
from memotr_tpu_torch.engine.trainer import BATCH_KEYS, Trainer
from test_torch_train_step import _assert_grads_close, _batch, _jax_setup
from test_torch_train_step import one_torch_thread  # noqa: F401
from test_torch_train_windowed_step import (CFG as WINDOWED_CFG, compiled,
                                            port_grads, port_named,
                                            trainable_names)
from test_torch_windowed_slice import jax_trees, port_model

CFG = dict(WINDOWED_CFG, ENCODER_TYPE="hybrid")


@pytest.fixture(scope="module")
def runs():
    params, uparams, frozen = jax_trees(CFG, seed=22)
    model = port_model(CFG, (params, uparams, frozen))
    batch = _batch(model)
    jmodel, jupd, jcrit, opt, cs, labels, trainable = _jax_setup(
        CFG, params, uparams)
    grad_step, _ = make_accum_steps(jmodel, jupd, jcrit, opt, cs, labels, 1)
    jgrads, jlogs = compiled(grad_step, trainable, {"frozen": frozen},
                             {k: jnp.asarray(batch[k]) for k in BATCH_KEYS},
                             jax.random.PRNGKey(0), None)
    tr = Trainer(model, CFG, device="cpu")
    logs = tr.grad_step(tr.batch_to_device(batch), tr.generator)
    return {"model": model, "logs": logs, "jlogs": jlogs,
            "grads": port_grads(model),
            "jgrads": port_named((jgrads["model"], jgrads["updater"]),
                                 frozen)}


def test_losses_and_logs_match_jax(runs):
    logs, jlogs = runs["logs"], runs["jlogs"]
    assert set(jlogs) <= set(logs), set(jlogs) ^ set(logs)
    for k, v in jlogs.items():
        np.testing.assert_allclose(float(logs[k]), float(v), rtol=1e-4,
                                   atol=1e-6, err_msg=k)


def test_every_gradient_matches_jax(runs):
    grads = runs["grads"]
    want = {n: runs["jgrads"][n] for n in grads}
    live = _assert_grads_close(grads, want)
    assert live > 0.8 * len(want)
    for part in ("fine.win_attn.in_proj_weight", "fine.cpb_mlp1.weight",
                 "fine.lepe_dwconv.weight", "coarse.self_attn.value_proj",
                 "coarse.self_attn.sampling_offsets", "layers.0.topdown_mix",
                 "layers.1.bottomup_mix"):
        hit = [n for n in grads if part in n]
        assert hit, part
        assert all(np.abs(grads[n]).max() > 0 for n in hit), part


def test_hybrid_names_take_jax_groups(runs):
    for name in trainable_names(runs["model"]):
        if name.startswith("transformer.encoder."):
            want = "points" if "sampling_offsets" in name else "base"
            assert port_trainer.param_group_label(name) == want, name
