"""The port's streaming submit engine against the JAX package's on the tiny
windowed MeMOTR (2 encoder layers: one window, one grid; window 4), float32
on the CPU: the sequence, checks and tolerances of ``test_torch_submit.py``
(its own JAX compile, on its own test worker).  The eval cache's bias
tables and position maps ride the pipelined loop here."""
import pytest

from test_torch_submit import (CFG, N_FRAMES, assert_same_tracks,  # noqa: F401
                               one_torch_thread, streams)

WINDOWED_CFG = dict(CFG, ENCODER_TYPE="windowed", WINDOW_SIZE=4)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return streams(WINDOWED_CFG, 22, tmp_path_factory.mktemp("windowed"))


def test_windowed_sequence_is_tracked(runs):
    lines = runs["jax"].splitlines()
    assert len({ln.split(",")[1] for ln in lines}) > 1
    assert {int(ln.split(",")[0]) for ln in lines} == \
        set(range(1, N_FRAMES + 1))


def test_windowed_pipelined_equals_sync_bytes(runs):
    assert runs["pipelined"] == runs["sync"]


def test_windowed_port_submitter_matches_jax(runs):
    assert_same_tracks(runs["pipelined"], runs["jax"])
