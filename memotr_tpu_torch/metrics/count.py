"""Count metric — detection/identity tallies.

Parity target: TrackEval's ``Count``
(``TrackEval/trackeval/metrics/count.py:5-43``): per-sequence
detection / id counts, summed across sequences.

The port's own copy of ``memotr_tpu/metrics/count.py`` (numpy and scipy
only; the port imports nothing of the JAX package).
"""
from __future__ import annotations

from typing import Dict, Sequence

FIELDS = ("Dets", "GT_Dets", "IDs", "GT_IDs")


def count_sequence(data: Dict) -> Dict:
    return {
        "Dets": data["num_pr_dets"],
        "GT_Dets": data["num_gt_dets"],
        "IDs": data["num_pr_ids"],
        "GT_IDs": data["num_gt_ids"],
        "Frames": data["num_timesteps"],
    }


def combine_count(seq_results: Sequence[Dict]) -> Dict:
    return {f: int(sum(r[f] for r in seq_results)) for f in FIELDS}
