"""Tracking metrics (counterpart of ``memotr_tpu/metrics``): HOTA, CLEAR,
Identity, VACE, IDEucl, Count and TrackMAP, and the MOT-challenge
evaluator; numpy and scipy only, the same exports."""
from .evaluator import evaluate_sequences, evaluate_mot_challenge
from .hota import hota_sequence, combine_hota
from .clear import clear_sequence, combine_clear
from .identity import identity_sequence, combine_identity
from .vace import vace_sequence, combine_vace
from .ideucl import ideucl_sequence, combine_ideucl
from .count import count_sequence, combine_count
from .track_map import (build_track_data, combine_track_map,  # noqa: F401
                        track_map_sequence)
