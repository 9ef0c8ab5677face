"""Time the port's streaming frame and its no-grad K1 / K2 calls on an
NVIDIA GPU, against a parent commit's checkout, in turns.

The machine with the card may have no git, so unpack the parent first
into a git-ignored directory::

    mkdir -p outputs/parent
    git archive <parent> | tar -x -C outputs/parent
    python3 scripts/time_streaming.py --parent outputs/parent [--frames 24]

Each checkout runs in a process of its own (both hold a package named
``memotr_tpu_torch``), in the order parent, this checkout, this checkout,
parent; without ``--parent``, this checkout twice.  A process builds its
checkout's kernels and then, through that checkout's ``chip_smoke.py``
helpers, measures:

- K1 at the encoder and the decoder (B=1) shapes and K2 at window level
  0, bf16 at 800x1536, through the wrapper the model calls without a
  gradient (``ops.msda.ms_deform_attn``, ``ops.window_attn.
  window_attention``): the event-timed call (``chip_smoke.median_ms``, 50
  calls on an idle stream, host work included) and the host's dispatch,
  microseconds a call over 200 calls issued without a sync;
- the deformable, windowed and conv configs of ``chip_smoke.py`` (phases
  5, 7 and 20, ``random_weights_``) streamed through the Submitter's
  pipelined and sync loops (``chip_smoke.stream``) for ``--frames``
  synthetic frames: the median and mean ms a frame from frame 3 on, and
  the mean host dispatch of the frame step.

Prints the card's name and power limit, one JSON line per process, and a
last JSON line with every process's numbers in run order.
"""
import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def host_us(fn, calls: int = 200) -> float:
    """Microseconds of host time a call, ``calls`` calls without a sync."""
    import torch
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return 1e6 * dt / calls


def worker(root: str, frames: int) -> dict:
    """Every measurement of one checkout, in this process."""
    sys.path.insert(0, root)
    os.chdir(root)
    import numpy as np
    import torch

    import chip_smoke as c
    from memotr_tpu_torch.models.memotr import build_model
    from memotr_tpu_torch.ops.msda import ms_deform_attn
    from memotr_tpu_torch.ops.window_attn import window_attention

    device = torch.device("cuda", 0)
    c.phase_build()
    out = {"root": root, "ops": {}, "stream": {}}
    lq_enc = sum(h * w for h, w in c.ENC_SHAPES)
    with torch.inference_mode():
        for name, lq in (("k1_encoder", lq_enc), ("k1_decoder_b1", 364)):
            v, loc, aw = c.msda_inputs(1, 1, c.ENC_SHAPES, 8, 32, 4, lq,
                                       torch.bfloat16, device)

            def k1():
                return ms_deform_attn(v, c.ENC_SHAPES, loc, aw)
            out["ops"][name] = {"event_ms": c.median_ms(k1, 50),
                                "host_us": host_us(k1)}
        args, geo = c.k2_case("window_l0", torch.bfloat16, device, seed=1)

        def k2():
            return window_attention(*args, *geo)
        out["ops"]["k2_window_l0"] = {"event_ms": c.median_ms(k2, 50),
                                      "host_us": host_us(k2)}
    for tag, config in (("deformable", c.CONFIG),
                        ("windowed", c.WINDOWED_CONFIG),
                        ("conv", c.CONV_CONFIG)):
        model = c.random_weights_(build_model(config)).to(device).eval()
        for loop in ("pipelined", "sync"):
            sub, _, _, _ = c.stream(tag, model, config,
                                    c.synthetic_frames(frames), device, loop)
            ms = c.steady_ms(sub.frame_seconds)
            out["stream"][f"{tag}_{loop}"] = {
                "median_ms": float(np.median(ms)), "mean_ms": float(ms.mean()),
                "dispatch_ms": float(c.steady_ms(sub.dispatch).mean())}
        del model
        torch.cuda.empty_cache()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="a parent commit's checkout")
    ap.add_argument("--frames", type=int, default=24)
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    a = ap.parse_args()
    if a.worker:
        print(json.dumps(worker(a.worker, a.frames)), flush=True)
        return 0
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("time_streaming: no CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    parent = os.path.abspath(a.parent) if a.parent else ROOT
    runs = []
    for label, root in (("parent", parent), ("change", ROOT),
                        ("change", ROOT), ("parent", parent)):
        p = subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--worker", root, "--frames", str(a.frames)],
                           capture_output=True, text=True, timeout=600)
        if p.returncode:
            sys.stderr.write(p.stdout[-4000:] + p.stderr[-8000:])
            raise SystemExit(f"time_streaming: the {label} run failed "
                             f"({p.returncode})")
        res = dict(json.loads(p.stdout.strip().splitlines()[-1]),
                   label=label)
        print(json.dumps(res), flush=True)
        runs.append(res)
    print(json.dumps({"time_streaming": runs}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
