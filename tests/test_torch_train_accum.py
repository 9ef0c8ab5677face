"""How the port's ``Trainer`` counts warmup and gradient accumulation,
against the rule of the JAX training loop (``memotr_tpu/engine/train.py``):

- ``global_iters`` advances once per micro-batch;
- the LR of an optimizer step is the epoch's group LR times
  ``warmup_scale`` of the ``global_iters`` of the micro-batch that applies
  it;
- a new epoch drops the accumulated gradient of the previous epoch's
  leftover micro-batches and restarts the micro-batch count.

The JAX loop's LR rule is restated below from ``train.py`` with the JAX
package's own ``warmup_scale`` and ``group_lrs``.  A tiny model on the CPU
(``test_torch_train_step.py``'s), ``ACCUMULATION_STEPS`` 2,
``WARMUP_ITERS`` 3, 3 batches an epoch over 2 epochs; and
``ACCUMULATION_STEPS`` 1, whose counting this does not change.
"""
import numpy as np
import pytest

from memotr_tpu.engine.trainer import group_lrs as jax_group_lrs
from memotr_tpu.engine.trainer import warmup_scale as jax_warmup_scale
from memotr_tpu_torch.engine.trainer import GROUPS, Trainer
from test_torch_submit import one_torch_thread  # noqa: F401
from test_torch_train_step import CFG, _batch, _port_model

WARMUP = 3
BATCHES_PER_EPOCH = 3
EPOCHS = 2


def jax_loop_lrs(config, accumulation):
    """[(epoch, micro-batch, LRs)] of every optimizer step of the JAX loop
    (train.py: the LRs set at epoch start and, while ``global_iters <=
    WARMUP_ITERS``, rescaled per micro-batch; applied on micro-batch i
    when (i + 1) % accumulation == 0; ``global_iters`` += 1 per
    micro-batch)."""
    steps, global_iters = [], 0
    for epoch in range(EPOCHS):
        lrs = jax_group_lrs(config, epoch)
        for i in range(BATCHES_PER_EPOCH):
            if WARMUP and global_iters <= WARMUP:
                w = jax_warmup_scale(global_iters, WARMUP)
                lrs = {k: v * (w if k != "frozen" else 0.0)
                       for k, v in jax_group_lrs(config, epoch).items()}
            if (i + 1) % accumulation == 0:
                steps.append((epoch, i, lrs))
            global_iters += 1
    return steps


@pytest.fixture(scope="module")
def batch():
    return _batch(_port_model())


def run_trainer(accumulation, batch):
    """Steps the port's Trainer through the epochs; returns the LRs of
    each optimizer step and, per micro-batch, whether any gradient was
    already accumulated when it began."""
    config = dict(CFG, ACCUMULATION_STEPS=accumulation, WARMUP_ITERS=WARMUP)
    tr = Trainer(_port_model(), config, device="cpu")
    applied, carried = [], []
    apply_step, grad_step = tr.apply_step, tr.grad_step
    train_step = tr.train_step

    def record_apply(lrs):
        applied.append((epoch, i, dict(lrs)))
        return apply_step(lrs)

    def record_grad(*args):
        carried.append(any(p.grad is not None for p in tr.model.parameters()))
        return grad_step(*args)

    def record_train(b, g, lrs):
        applied.append((epoch, i, dict(lrs)))
        return train_step(b, g, lrs)

    tr.apply_step, tr.grad_step = record_apply, record_grad
    tr.train_step = record_train
    for epoch in range(EPOCHS):
        for i in range(BATCHES_PER_EPOCH):
            tr.step(batch, epoch)
    assert tr.global_iter == EPOCHS * BATCHES_PER_EPOCH
    return applied, carried


def assert_same_steps(got, want):
    assert [(e, i) for e, i, _ in got] == [(e, i) for e, i, _ in want]
    for (e, i, g), (_, _, w) in zip(got, want):
        for k in GROUPS:
            np.testing.assert_allclose(g[k], w[k], rtol=1e-12,
                                       err_msg=f"epoch {e} batch {i} {k}")


def test_accumulated_warmup_counts_micro_batches(batch):
    config = dict(CFG, ACCUMULATION_STEPS=2, WARMUP_ITERS=WARMUP)
    applied, _ = run_trainer(2, batch)
    want = jax_loop_lrs(config, 2)
    # one step an epoch, on its second micro-batch: warmup factors 2/3, 1
    assert [round(jax_warmup_scale(e * BATCHES_PER_EPOCH + i, WARMUP), 6)
            for e, i, _ in want] == [round(2 / 3, 6), 1.0]
    assert_same_steps(applied, want)


def test_leftover_micro_batch_is_dropped_at_a_new_epoch(batch):
    """Epoch 0's third micro-batch never reaches an optimizer step: the
    first micro-batch of epoch 1 starts from no gradient."""
    _, carried = run_trainer(2, batch)
    assert carried == [False, True, False, False, True, False]


def test_no_accumulation_is_unchanged(batch):
    config = dict(CFG, ACCUMULATION_STEPS=1, WARMUP_ITERS=WARMUP)
    applied, _ = run_trainer(1, batch)
    assert_same_steps(applied, jax_loop_lrs(config, 1))
    assert len(applied) == EPOCHS * BATCHES_PER_EPOCH
