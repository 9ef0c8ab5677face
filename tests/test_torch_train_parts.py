"""The training slice's host-side pieces against the JAX package (CPU).

Clip collation, epoch order and canvas buckets (numpy: identical arrays);
parameter-group labels of every parameter of the tiny model (the port's
torch names against the JAX package's ``param_group_label`` on the same
leaves); LR schedules, warmup, the updater-only freeze and the
``NO_GRAD_FRAMES`` schedule (identical values); and the optimizer: three
steps of the port's clip + AdamW against the JAX package's optax chain on
the same gradients (float32, rtol 1e-6).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from memotr_tpu.checkpoint.torch_convert import convert_torch_state_dict
from memotr_tpu.data import loader as jloader
from memotr_tpu.engine import trainer as jtrainer
from memotr_tpu.structures.padded_frame import bucket_hw as jax_bucket_hw
from memotr_tpu_torch.data import loader
from memotr_tpu_torch.engine import trainer
from memotr_tpu_torch.models.memotr import build_model
from memotr_tpu_torch.structures.padded_frame import bucket_hw
from test_torch_port_weights import TINY_CFG

CFG = {"LR": 2e-4, "LR_BACKBONE": 2e-5, "LR_POINTS": 1e-5,
       "WEIGHT_DECAY": 5e-4, "CLIP_MAX_NORM": 0.1,
       "LR_SCHEDULER": "MultiStep", "LR_DROP_MILESTONES": [12, 16],
       "LR_DROP_RATE": 0.1, "EPOCHS": 20,
       "ONLY_TRAIN_QUERY_UPDATER_AFTER": 18}


def _clips(seed, b=2, t=3):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(b):
        imgs, infos = [], []
        for _ in range(t):
            h, w = rng.integers(40, 200, 2)
            imgs.append(rng.normal(size=(h, w, 3)).astype(np.float32))
            n = int(rng.integers(0, 9))
            infos.append({"boxes": rng.uniform(size=(n, 4)),
                          "ids": rng.integers(0, 99, n),
                          "labels": rng.integers(0, 3, n),
                          "areas": rng.uniform(size=n)})
        out.append({"imgs": imgs, "infos": infos})
    return out


@pytest.mark.parametrize("kw", [dict(max_gts=5), dict(max_gts=8),
                                dict(max_gts=5, bucket_multiple=32),
                                dict(max_gts=5, fixed_canvas=(256, 256))])
def test_collate_clips_matches_jax(kw):
    batch = _clips(0)
    got, want = loader.collate_clips(batch, **kw), \
        jloader.collate_clips(batch, **kw)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_epoch_indices_and_buckets_match_jax():
    for kw in (dict(shuffle=True, seed=3, epoch=2),
               dict(shuffle=False, seed=0, epoch=0),
               dict(shuffle=True, seed=1, epoch=5, rank=1, world_size=3),
               dict(shuffle=True, seed=1, epoch=5, rank=2, world_size=4,
                    drop_last=False)):
        np.testing.assert_array_equal(loader.epoch_indices(23, **kw),
                                      jloader.epoch_indices(23, **kw))
    for hw in ((864, 1536), (1, 1), (128, 129), (800, 1333)):
        for m in (32, 128):
            assert bucket_hw(*hw, m) == jax_bucket_hw(*hw, m)


@pytest.mark.parametrize("use_dab", [True, False])
def test_param_group_labels_match_jax(use_dab):
    """Each port parameter, filled with its index, converts to JAX leaves
    that carry the index: the two labels of each must agree.  (The box
    heads' decoder alias shares its tensors with ``bbox_embed``.)"""
    cfg = dict(TINY_CFG, USE_DAB=use_dab)
    model = build_model(cfg)
    names = dict(model.named_parameters())
    index = {n: i for i, n in enumerate(names)}
    by_tensor = {id(p): index[n] for n, p in names.items()}
    every = dict(model.named_parameters(remove_duplicate=False))
    sd = {k: (np.full(v.shape, by_tensor[id(every[k])], np.float32)
              if k in every else v.numpy())
          for k, v in model.state_dict().items()}
    params, uparams, _ = convert_torch_state_dict(sd, use_dab=use_dab)
    params.pop("_unconverted")
    jax_label = {}
    for tree, root in ((params, "model"), (uparams, "updater")):
        for path, leaf in jax.tree_util.tree_leaves_with_path(tree):
            keys = (root,) + tuple(getattr(p, "key", p) for p in path)
            for i in np.unique(np.asarray(leaf)):
                jax_label.setdefault(int(i), set()).add(
                    jtrainer.param_group_label(keys))
    labels = set()
    for name, i in index.items():
        got = trainer.param_group_label(name)
        assert jax_label[i] == {got}, (name, jax_label[i], got)
        labels.add(got)
    assert labels == {"frozen", "backbone", "points", "query_updater",
                      "base"}
    # frozen exactly where the parameter is made without a gradient
    for name, p in names.items():
        assert (trainer.param_group_label(name) == "frozen") == \
            (not p.requires_grad), name


def test_schedules_match_jax():
    for kind in ("MultiStep", "Cosine"):
        cfg = dict(CFG, LR_SCHEDULER=kind)
        for epoch in range(22):
            assert trainer.group_lrs(cfg, epoch) == \
                pytest.approx(jtrainer.group_lrs(cfg, epoch), rel=1e-12)
            assert trainer.lr_schedule_factory(cfg)(epoch) == \
                pytest.approx(jtrainer.lr_schedule_factory(cfg)(epoch))
    for it, warm in ((0, 0), (0, 4), (3, 4), (9, 10), (100, 4)):
        assert trainer.warmup_scale(it, warm) == \
            jtrainer.warmup_scale(it, warm)
    for cfg in ({"NO_GRAD_STEPS": [20, 10], "NO_GRAD_FRAMES": [3, 1]},
                {"NO_GRAD_STEPS": [8], "NO_GRAD_FRAMES": 2},
                {"NO_GRAD_FRAMES": 2}, {}):
        for epoch in (0, 5, 9, 15, 25):
            assert trainer.no_grad_frames_for_epoch(cfg, epoch) == \
                jtrainer.no_grad_frames_for_epoch(cfg, epoch)


def test_optimizer_matches_optax_chain():
    """clip_grad_norm_ + AdamW against optax's clip -> adam -> decayed
    weights -> -lr, over three steps (the first clipped, the others not)."""
    rng = np.random.default_rng(5)
    p0 = rng.normal(size=(2, 7)).astype(np.float32)
    grads = [rng.normal(size=(2, 7)).astype(np.float32) * s
             for s in (10.0, 0.01, 0.02)]
    lr = 1e-2
    p = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    opt = trainer.make_optimizer({"base": [p]}, CFG)
    trainer.set_lrs(opt, {"base": lr})
    jopt = jtrainer.make_optimizer(CFG)
    jp = {"w": jnp.asarray(p0)}
    state = jopt.init(jp)
    for g in grads:
        p.grad = torch.from_numpy(g.copy())
        torch.nn.utils.clip_grad_norm_([p], CFG["CLIP_MAX_NORM"])
        opt.step()
        upd, state = jopt.update({"w": jnp.asarray(g)}, state, jp)
        jp = {"w": jp["w"] - lr * upd["w"]}
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp["w"]),
                                   rtol=1e-6, atol=1e-7)
