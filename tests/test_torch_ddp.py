"""The port's several-process paths on the CPU: two gloo processes, one
clip each, against the JAX package's 2-device data mesh.

The two workers are fresh Python processes that import only the port.
Each joins the group through ``main --multi-host`` with torchrun's
environment set by hand (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``MASTER_ADDR``, ``MASTER_PORT``), then:

- runs ``--mode eval`` on a two-sequence val split (the tree and the run
  directory of tests/test_torch_eval.py): each rank streams one sequence,
  rank 1 late on purpose, and rank 0 scores only once both shards are in
  the tracker directory; the union of the shards equals a one-process
  submit's files byte for byte;
- syncs a ``MetricLog`` (rank 0 holds 1 and 2, rank 1 holds 3, 4 and 5,
  and a metric of its own): both read the global totals, sum 15 over 5,
  as ``tests/test_multidevice.py`` holds JAX's;
- takes one step of the port's ``Trainer`` on its clip of the batch of
  ``tests/test_multidevice.py``'s ``_setup``, from a seeded port model's
  weights (rank 1 starts from perturbed ones, which the broadcast
  replaces): ``total_loss``,
  ``grad_norm``, ``n_gts`` and the parameters after the step against JAX's
  ``make_train_step`` on a 2-device mesh over both clips, with
  ``TP_DROP_RATE`` and ``FP_INSERT_RATE`` 0 (the two sides draw from
  different generators).  The ranks' parameters are equal bit for bit.

Every worker's ``communicate`` has a 300 s timeout; a failed worker fails
the test with its stderr.
"""
import json
import os
import shutil
import socket
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

pytestmark = pytest.mark.skipif(
    jax.devices()[0].platform != "cpu" or len(jax.devices()) < 2,
    reason="needs the virtual CPU mesh (tests/conftest.py)")

from memotr_tpu_torch.checkpoint.convert import (  # noqa: E402
    state_dict_from_jax)
from memotr_tpu_torch.engine.submit import submit  # noqa: E402
from memotr_tpu_torch.main import main  # noqa: E402
from memotr_tpu_torch.models.memotr import build_model  # noqa: E402
from test_torch_eval import VIDEOS, _config, _eval_dir, _tree  # noqa: E402
from test_torch_port_weights import to_jax_trees  # noqa: E402
from test_torch_train_step import one_torch_thread  # noqa: E402,F401
from test_torch_train_step import _adam_mu  # noqa: E402
from test_torch_train_windowed_step import compiled  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SYNC_VALUES = ([1.0, 2.0], [3.0, 4.0, 5.0])

_WORKER = textwrap.dedent('''
    import json, os, sys, time
    import numpy as np
    import torch
    torch.set_num_threads(1)
    rank, tmp = int(sys.argv[1]), sys.argv[2]
    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE="2",
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=sys.argv[3])
    from memotr_tpu_torch.engine import eval as port_eval
    from memotr_tpu_torch.engine import submit as port_submit
    from memotr_tpu_torch.main import main
    out = {"streamed": []}

    # --- eval: this rank's shard, scored by rank 0 after the barrier ----
    Submitter = port_submit.Submitter
    class Recording(Submitter):
        def __init__(self, dataset_name, frames, name, *a, **k):
            out["streamed"].append(name)
            super().__init__(dataset_name, frames, name, *a, **k)
        def run(self):
            if rank == 1:
                time.sleep(3.0)     # the late shard
            return super().run()
    port_submit.Submitter = Recording
    score = port_eval.evaluate_mot_challenge
    def scoring(gt_dir, tracker_dir, **kw):
        out["tracker_files"] = sorted(os.listdir(tracker_dir))
        return score(gt_dir, tracker_dir, **kw)
    port_eval.evaluate_mot_challenge = scoring
    metrics = main(["--config-path", os.path.join(tmp, "eval.yaml"),
                    "--mode", "eval", "--multi-host", "--device", "cpu"])
    out["metrics"] = None if metrics is None else metrics["HOTA"]

    # --- MetricLog.sync --------------------------------------------------
    from memotr_tpu_torch.log.logger import MetricLog
    log = MetricLog()
    for v in json.loads(sys.argv[4])[rank]:
        log.update("loss", v)
    if rank == 1:
        log.update("only_rank1", 7.0)
    log.sync()
    out["sync"] = {n: [m.total_sum, m.total_count]
                   for n, m in log.metrics.items()}

    # --- one train step, one clip a rank ---------------------------------
    from memotr_tpu_torch.engine.trainer import BATCH_KEYS, Trainer
    from memotr_tpu_torch.models.memotr import build_model
    with open(os.path.join(tmp, "train.json")) as f:
        cfg = json.load(f)
    model = build_model(cfg)
    model.load_state_dict(torch.load(os.path.join(tmp, "init.pt")))
    if rank == 1:
        with torch.no_grad():
            for p in model.parameters():
                p.add_(0.5)
    data = np.load(os.path.join(tmp, "batch.npz"))
    batch = {k: data[k][rank:rank + 1] for k in BATCH_KEYS}
    trainer = Trainer(model, cfg, device="cpu", seed=rank)
    logs = trainer.step(batch)
    out["logs"] = {k: float(logs[k]) for k in
                   ("total_loss", "grad_norm", "n_gts")}
    torch.save(model.state_dict(), os.path.join(tmp, f"rank{rank}.pt"))
    with open(os.path.join(tmp, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
''')


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _jax_setup():
    """The 2-device mesh step of tests/test_multidevice.py's ``_setup``
    (its tiny config and batch), with ``TP_DROP_RATE`` and
    ``FP_INSERT_RATE`` 0, from the weights of a seeded port model (the
    JAX trees through ``convert_torch_state_dict``)."""
    import __graft_entry__ as ge
    from memotr_tpu.engine.trainer import (group_lrs, init_train_state,
                                           label_tree, make_optimizer,
                                           make_train_step, static_config)
    from memotr_tpu.models.criterion import build_criterion
    from memotr_tpu.models.memotr import build_model as jax_build_model
    from memotr_tpu.models.query_updater import build_query_updater

    config = ge._tiny_config(track_slots=4, max_gts=4)
    config.update({"NUM_ENC_LAYERS": 1, "NUM_DEC_LAYERS": 2,
                   "NUM_DET_QUERIES": 20, "HIDDEN_DIM": 32, "FFN_DIM": 64,
                   "TP_DROP_RATE": 0.0, "FP_INSERT_RATE": 0.0})
    torch.manual_seed(0)
    sd = build_model(config).state_dict()
    params, uparams, frozen = to_jax_trees(sd)
    model = jax_build_model(config)
    updater = build_query_updater(config)
    optimizer = make_optimizer(config)
    state = init_train_state(params, uparams, optimizer)
    cs = static_config(config, model, world_size=2)
    step = make_train_step(model, updater, build_criterion(config),
                           optimizer, cs, label_tree(state.params))
    lrs = {k: jnp.asarray(v, jnp.float32)
           for k, v in group_lrs(config, 0).items()}
    b, t, g, h, w = 2, 2, 4, 64, 64
    rng_d = jax.random.PRNGKey(1)
    batch = {
        "images": jax.random.normal(rng_d, (b, t, h, w, 3)) * 0.1,
        "mask": jnp.zeros((b, t, h, w), bool),
        "gt_boxes": jnp.clip(
            jax.random.uniform(jax.random.fold_in(rng_d, 1), (b, t, g, 4))
            * 0.4 + 0.1, 0.05, 0.9),
        "gt_ids": jnp.tile(jnp.arange(g, dtype=jnp.int32)[None, None],
                           (b, t, 1)),
        "gt_labels": jnp.zeros((b, t, g), jnp.int32),
        "gt_mask": jnp.ones((b, t, g), bool),
    }
    return config, sd, state, {"frozen": frozen}, batch, step, lrs


def _jax_mesh_step(state, frozen, batch, step, lrs):
    from memotr_tpu.parallel.mesh import make_mesh, replicate, shard_batch
    mesh = make_mesh(2)
    new_state, logs = compiled(step, replicate(mesh, state),
                               replicate(mesh, frozen),
                               shard_batch(mesh, batch),
                               jax.random.PRNGKey(2), lrs)
    grads = jax.tree_util.tree_map(lambda m: np.asarray(m) / 0.1,
                                   _adam_mu(new_state.opt_state))
    return (jax.device_get(new_state.params), grads,
            jax.device_get(logs))


@pytest.fixture(scope="module")
def ddp(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ddp")
    # the eval run: tests/test_torch_eval.py's tree and run directory, and
    # a copy of the run for the one-process submit
    _tree(str(tmp / "data"))
    eval_dir = _eval_dir(str(tmp / "run"))
    one_dir = str(tmp / "one")
    shutil.copytree(eval_dir, one_dir)
    with open(tmp / "eval.yaml", "w") as f:
        yaml.safe_dump(_config(tmp, eval_dir, EVAL_THREADS=1), f)
    # the train step: JAX's tiny config, init and batch
    config, sd, state, frozen, batch, step, lrs = _jax_setup()
    torch.save(sd, tmp / "init.pt")
    np.savez(tmp / "batch.npz", **{k: np.asarray(v) for k, v in
                                   batch.items()})
    with open(tmp / "train.json", "w") as f:
        json.dump(config, f)

    script = tmp / "worker.py"
    script.write_text(_WORKER)
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    for key in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                "MASTER_PORT"):
        env.pop(key, None)
    port = str(_free_port())
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(r), str(tmp), port,
         json.dumps(SYNC_VALUES)], cwd=REPO, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(2)]
    try:
        jparams, jgrads, jlogs = _jax_mesh_step(state, frozen, batch, step,
                                                lrs)
        submit(dict(_config(tmp, one_dir), SUBMIT_DIR=one_dir,
                    SUBMIT_MODEL="checkpoint_1.pth", SUBMIT_DATA_SPLIT="val"),
               "cpu")
        outs = [p.communicate(timeout=300) for p in procs]
    finally:
        for p in procs:
            p.kill()
    for r, (p, (_, err)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} failed:\n{err[-4000:]}"
    ranks = []
    for r in range(2):
        with open(tmp / f"rank{r}.json") as f:
            res = json.load(f)
        res["state"] = torch.load(tmp / f"rank{r}.pt")
        ranks.append(res)
    names = [n for n, _ in build_model(config).named_parameters(
        remove_duplicate=False)]
    after = _state_dict(jparams["model"], jparams["updater"],
                        frozen["frozen"])
    grads = _state_dict(jgrads["model"], jgrads["updater"], frozen["frozen"])
    return {"tmp": tmp, "eval_dir": eval_dir, "one_dir": one_dir,
            "ranks": ranks, "jlogs": jlogs, "lr": config["LR"],
            "jparams": {n: after[n].numpy() for n in names},
            "jgrads": {n: grads[n].numpy() for n in names}}


def _state_dict(params, uparams, frozen):
    """JAX trees -> the port's state dict."""
    as_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    return state_dict_from_jax(as_np(params), as_np(uparams), as_np(frozen))


def test_each_rank_streams_one_sequence(ddp):
    streamed = [r["streamed"] for r in ddp["ranks"]]
    assert streamed == [[VIDEOS[0]], [VIDEOS[1]]], streamed


def test_eval_scores_after_both_shards(ddp):
    """Rank 0 scored once rank 1's late shard was in the tracker
    directory; rank 1 returned no metrics."""
    r0, r1 = ddp["ranks"]
    assert r0["tracker_files"] == sorted(f"{v}.txt" for v in VIDEOS)
    assert "tracker_files" not in r1 and r1["metrics"] is None
    assert np.isfinite(r0["metrics"])


def test_shards_union_equals_one_process_submit(ddp):
    got_dir = os.path.join(ddp["eval_dir"], "val", "checkpoint_1_tracker")
    want_dir = os.path.join(ddp["one_dir"], "val", "tracker")
    for v in VIDEOS:
        with open(os.path.join(got_dir, f"{v}.txt"), "rb") as f:
            got = f.read()
        with open(os.path.join(want_dir, f"{v}.txt"), "rb") as f:
            assert got == f.read(), v
        assert got, v


def test_metric_log_sync_totals(ddp):
    for r in ddp["ranks"]:
        assert r["sync"] == {"loss": [15.0, 5], "only_rank1": [7.0, 1]}


def test_train_step_matches_jax_mesh(ddp):
    """Loss, gradient norm and GT count at tests/test_multidevice.py's
    tolerances, on both ranks."""
    jlogs = ddp["jlogs"]
    for r in ddp["ranks"]:
        logs = r["logs"]
        np.testing.assert_allclose(logs["total_loss"],
                                   float(jlogs["total_loss"]), rtol=1e-5)
        np.testing.assert_allclose(logs["grad_norm"],
                                   float(jlogs["grad_norm"]), rtol=1e-4)
        assert logs["n_gts"] == float(jlogs["n_gts"]) == 16.0


def test_parameters_after_the_step(ddp):
    """Equal on both ranks bit for bit, and JAX's at
    tests/test_multidevice.py's 1e-6 wherever JAX's gradient is at least
    1e-6 (there AdamW's first step, lr g / (|g| + 1e-8), is within 1% of
    its saturated size, so the gradients' agreement carries over).  Below,
    the step is the ratio of two rounding-sized numbers, as
    test_torch_train_step.py explains: there the two steps are each at
    most LR in size."""
    s0, s1 = (r["state"] for r in ddp["ranks"])
    assert s0.keys() == s1.keys()
    for k in s0:
        assert torch.equal(s0[k], s1[k]), k
    for k, want in ddp["jparams"].items():
        got = s0[k].numpy()
        big = np.abs(ddp["jgrads"][k]) >= 1e-6
        np.testing.assert_allclose(got[big], want[big], rtol=0, atol=1e-6,
                                   err_msg=k)
        np.testing.assert_allclose(got, want, rtol=0, atol=2 * ddp["lr"],
                                   err_msg=k)


def test_multi_host_without_torchrun_raises(tmp_path, monkeypatch):
    for key in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                "MASTER_PORT"):
        monkeypatch.delenv(key, raising=False)
    cfg = tmp_path / "cfg.yaml"
    cfg.write_text("DATASET: DanceTrack\n")
    with pytest.raises(RuntimeError, match="torchrun"):
        main(["--config-path", str(cfg), "--mode", "train", "--multi-host",
              "--device", "cpu"])
