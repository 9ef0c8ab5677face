"""Time the port's two backward kernels (K1 ``csrc/msda_bwd.cu``, K2
``csrc/window_attn_bwd.cu``) on an NVIDIA GPU: against a parent commit's,
in turns, and cut by cut.  Device ms per call are the call's CUDA kernels
summed from torch.profiler over 20 calls (``chip_smoke.timed``), at the
896x1536 training canvas's shapes; the card's name and power limit are
printed first.

The parent's sources come from git, which the machine with the card may
not have, so write them into a directory first::

    mkdir -p outputs/parent
    for f in csrc/msda_bwd.cu csrc/window_attn_bwd.cu ops/msda_cuda.py \\
             ops/window_attn_cuda.py; do
      git show HEAD:memotr_tpu_torch/$f > outputs/parent/$(basename $f)
    done

    python3 scripts/time_backward_kernels.py --parent outputs/parent
    python3 scripts/time_backward_kernels.py --parent-cuts outputs/parent
    python3 scripts/time_backward_kernels.py --cuts

``--parent DIR``: builds DIR's kernels with the package's nvcc flags into
DIR/build, loads DIR's wrappers with their library loader pointed there,
and times parent, package, package, parent: K1 at the encoder shape and
the decoder's at B=1 and 2, K2's whole backward call at window and grid
level 0.  ``--parent-cuts DIR``: the atomic-scatter kernels of commit
fd9b622 cut by cut, as PERF.md reports them: K1 without its grad_value
atomics; K2 without its bias table's L2 reads, without its bias-gradient
sums, without pass A, and with only the group loads.  ``--cuts``: the
package's K2 backward at grid level 0 with one part of its tiled kernels
cut (each sweep of the rows kernel, the rows' dQ merge, the keys kernel's
loop and merge, all of them).  A cut writes a copy of a source with one
loop skipped; the copies are removed at the end.
"""
import argparse
import ctypes
import json
import os
import subprocess
import sys
import types

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import chip_smoke as c  # noqa: E402
from memotr_tpu_torch.ops import _build  # noqa: E402
from memotr_tpu_torch.ops import msda_cuda  # noqa: E402
from memotr_tpu_torch.ops import window_attn_cuda as wac  # noqa: E402

SHAPES = c.TRAIN_ENC_SHAPES
K1_CASES = (("encoder", 1, sum(h * w for h, w in SHAPES)),
            ("decoder_b1", 1, 364), ("decoder_b2", 2, 364))
K2_CASES = ("window_l0", "grid_l0")


class ParentLoader:
    """Builds and opens the kernel libraries of a directory of sources, and
    stands in for ``ops/_build`` in the parent's wrappers."""

    def __init__(self, root):
        self.root = root
        self.libs = {}

    def build(self, *names):
        os.makedirs(os.path.join(self.root, "build"), exist_ok=True)
        procs = {}
        for n in names:
            out = os.path.join(self.root, "build", f"lib{n}.so")
            if not os.path.exists(out):
                procs[n] = subprocess.Popen(
                    [_build._nvcc(), *_build.NVCC_FLAGS, "-o", out,
                     os.path.join(self.root, f"{n}.cu")],
                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for n, p in procs.items():
            log = p.communicate()[0]
            if p.returncode:
                raise RuntimeError(f"nvcc failed on {n}:\n{log}")

    def load(self, name, argtypes):
        if name not in self.libs:
            self.build(name)
            lib = ctypes.CDLL(os.path.abspath(
                os.path.join(self.root, "build", f"lib{name}.so")))
            for fn, types_ in argtypes.items():
                getattr(lib, fn).argtypes = types_
                getattr(lib, fn).restype = ctypes.c_int
            self.libs[name] = lib
        return self.libs[name]

    def module(self, name):
        """The parent's wrapper module ``name`` (``msda_cuda`` or
        ``window_attn_cuda``), loading its kernels from this directory."""
        src = open(os.path.join(self.root, f"{name}.py")).read()
        src = src.replace("from __future__ import annotations\n", "")
        src = src.replace("from ..utils.misc import",
                          "from memotr_tpu_torch.utils.misc import")
        src = src.replace("from . import _build", "")
        mod = types.ModuleType(f"parent_{name}")
        mod.__dict__["_build"] = self
        exec(compile(src, name, "exec"), mod.__dict__)
        return mod


def k1_inputs(b, lq, d):
    v, loc, aw = c.msda_inputs(1, b, SHAPES, 8, 32, 4, lq, torch.bfloat16, d)
    g = torch.randn((b, lq, 256), generator=torch.Generator(d).manual_seed(0),
                    device=d).to(torch.bfloat16)
    return v, loc, aw, g


def k2_inputs(case, d):
    args, geo = c.k2_case(case, torch.bfloat16, d, seed=3, train=True)
    gy = torch.randn(args[0].shape, generator=torch.Generator(d).manual_seed(0),
                     device=d).to(torch.bfloat16)
    with torch.no_grad():
        _, o = wac.window_attention_fwd(*args, *geo)
    return args, geo, gy, o


def device_ms(fn, family):
    """(whole call's device ms, its kernels whose name holds ``family``)."""
    _, dev, parts = c.timed(fn)
    return dev, sum(ms for k, (ms, _) in parts.items() if family in k)


def in_turns(label, fns, family):
    """Times each (name, fn) in order and reverse: ``fns`` = [parent,
    package]; returns {name: [(whole, kernels), ...]}."""
    out = {}
    for name, fn in list(fns) + list(fns)[::-1]:
        whole, kern = device_ms(fn, family)
        out.setdefault(name, []).append((round(whole, 4), round(kern, 4)))
        print(f"{label} {name}: device {whole:.4f} ms, its {family} kernels "
              f"{kern:.4f} ms", flush=True)
    return out


def parent_vs_package(root, d):
    loader = ParentLoader(root)
    loader.build("msda_bwd", "window_attn_bwd")
    old_k1, old_k2 = loader.module("msda_cuda"), loader.module("window_attn_cuda")
    res = {}
    for name, b, lq in K1_CASES:
        v, loc, aw, g = k1_inputs(b, lq, d)
        res[name] = in_turns(name, [
            ("parent", lambda: old_k1.msda_backward(v, SHAPES, loc, aw, g)),
            ("package", lambda: msda_cuda.msda_backward(v, SHAPES, loc, aw, g))],
            "msda_bwd")
    for case in K2_CASES:
        args, geo, gy, o = k2_inputs(case, d)
        res[case] = in_turns(case, [
            ("parent", lambda: old_k2.window_attention_bwd(gy, *args, o, *geo)),
            ("package", lambda: wac.window_attention_bwd(gy, *args, o, *geo))],
            "attn_bwd")
    return res


def sub(src, cuts):
    """``src`` with each marker of ``cuts`` replaced once (each must occur
    exactly once)."""
    for a, b in cuts:
        if src.count(a) != 1:
            raise ValueError(f"cut marker found {src.count(a)} times: {a[:60]}")
        src = src.replace(a, b)
    return src


def skip(marker):
    """The marker's loop started past its end, so that it runs no trip."""
    return (marker, marker.replace("kt = ks;", "kt = ks + nt;")
            .replace("qt = qs;", "qt = qs + nt;")
            .replace("qt = warp;", "qt = warp + nt;")
            .replace("kt = warp;", "kt = warp + nt;")
            .replace("e = tid;", "e = tid + (1 << 30);"))


# the kernels of commit fd9b622, cut as PERF.md reports them
PARENT_K1_CUTS = {"no_value_atomics": [(
    "        if (active) {\n#pragma unroll\n          for (int q = 0; q < 4; ++q) {",
    "        if (false) {\n#pragma unroll\n          for (int q = 0; q < 4; ++q) {")]}
_PASS_A = ("    // pass A: per query row, log-sum-exp and rowsum(P o dP)\n"
           "    for (int qt = warp; qt < nt;")
_PASS_B = "    for (int kt = warp; kt < nt; kt += TC_WARPS) {"
_PASS_C = ("    // pass C: dQ and the bias gradient, per 16-query tile over every "
           "key\n    // tile (reads only what pass A wrote)\n"
           "    for (int qt = warp; qt < nt;")
PARENT_K2_CUTS = {
    "no_bias_reads": [("round_to<bf16>(__ldg(bias_h + (long long)qi * L + kj))",
                       "0.f")],
    "no_bias_gradient": [(
        "              if (bias_acc) dB[q * L + key] += ds;\n"
        "              else atomicAdd(dbias_h + (long long)q * L + key, ds);",
        "              (void)0;")],
    "no_pass_a": [skip(_PASS_A)],
    "loads_only": [skip(_PASS_A), skip(_PASS_B), skip(_PASS_C)],
}
# the package's tiled K2 backward
_SW1 = ("      for (int kt = ks; kt < nt; kt += KS) {\n"
        "        float s[2][4] = {}, dp[2][4] = {};\n"
        "        s_dp<DH>(qa, ga, Ks, Vs, kt * 16, QP, lane, s, dp);\n"
        "        float tmax")
_SW2 = ("      for (int kt = ks; kt < nt; kt += KS) {\n"
        "        float s[2][4] = {}, dp[2][4] = {};\n"
        "        s_dp<DH>(qa, ga, Ks, Vs, kt * 16, QP, lane, s, dp);\n"
        "        uint32_t sa[4];")
_ROWS_MERGE = "    for (int e = tid; e < QT * DH / 2; e += NTHR) {"
_KEYS_LOOP = "    for (int qt = qs; qt < nt; qt += QS) {"
_KEYS_MERGE = "      for (int e = tid; e < KT * DH / 2; e += NTHR) {"
PACKAGE_K2_CUTS = {
    "no_rows_sweep1": [skip(_SW1)],
    "no_rows_sweep2": [skip(_SW2)],
    "no_rows_dq_merge": [skip(_ROWS_MERGE)],
    "no_keys_loop": [skip(_KEYS_LOOP)],
    "no_keys_merge": [skip(_KEYS_MERGE)],
    "none": [skip(_SW1), skip(_SW2), skip(_ROWS_MERGE), skip(_KEYS_LOOP),
             skip(_KEYS_MERGE)],
}


def cut_by_cut(label, module, base, src_dir, cuts, fn, family, remove):
    """Writes ``base``'s source with each set of cuts beside it, and times
    the whole kernel and each cut in turns through ``module`` (its
    ``BWD_NAME`` switched per variant)."""
    src = open(os.path.join(src_dir, f"{base}.cu")).read()
    names = [base]
    for cut, pairs in cuts.items():
        name = f"{base}_cut_{cut}"
        with open(os.path.join(src_dir, f"{name}.cu"), "w") as f:
            f.write(sub(src, pairs))
        names.append(name)
    res = {}
    try:
        for order in (names, names[::-1]):
            for name in order:
                module.BWD_NAME = name
                whole, kern = device_ms(fn, family)
                res.setdefault(name, []).append(round(kern, 4))
                print(f"{label} {name}: device {whole:.4f} ms, its {family} "
                      f"kernels {kern:.4f} ms", flush=True)
    finally:
        module.BWD_NAME = base
        if remove:
            for name in names[1:]:
                os.remove(os.path.join(src_dir, f"{name}.cu"))
    return res


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="directory of a parent's sources")
    ap.add_argument("--parent-cuts",
                    help="directory of commit fd9b622's sources")
    ap.add_argument("--cuts", action="store_true",
                    help="the package's K2 backward cut by cut")
    opt = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("time_backward_kernels: needs an NVIDIA GPU")
    d = torch.device("cuda", 0)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    _build.build("window_attn_fwd", "msda_bwd", "window_attn_bwd")
    res = {}
    if opt.parent:
        res["parent_vs_package"] = parent_vs_package(opt.parent, d)
    if opt.parent_cuts:
        loader = ParentLoader(opt.parent_cuts)
        old_k1 = loader.module("msda_cuda")
        old_k2 = loader.module("window_attn_cuda")
        v, loc, aw, g = k1_inputs(1, K1_CASES[0][2], d)
        res["parent_k1_cuts"] = cut_by_cut(
            "encoder", old_k1, "msda_bwd", opt.parent_cuts, PARENT_K1_CUTS,
            lambda: old_k1.msda_backward(v, SHAPES, loc, aw, g), "msda_bwd",
            remove=True)
        for case in K2_CASES:
            args, geo, gy, o = k2_inputs(case, d)
            res[f"parent_k2_cuts {case}"] = cut_by_cut(
                case, old_k2, "window_attn_bwd", opt.parent_cuts,
                PARENT_K2_CUTS,
                lambda: old_k2.window_attention_bwd(gy, *args, o, *geo),
                "attn_bwd", remove=True)
    if opt.cuts:
        args, geo, gy, o = k2_inputs("grid_l0", d)
        res["package_k2_cuts grid_l0"] = cut_by_cut(
            "grid_l0", wac, "window_attn_bwd", str(_build.CSRC),
            PACKAGE_K2_CUTS,
            lambda: wac.window_attention_bwd(gy, *args, o, *geo), "attn_bwd",
            remove=True)
    print(json.dumps(res), flush=True)


if __name__ == "__main__":
    main()
