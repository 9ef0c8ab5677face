"""The port's GT converters against the JAX package's: the same inputs
give byte-identical output trees, through the functions and through the
port's command line (``python -m memotr_tpu_torch.data.gen_gts``)."""
import json
import os

import pytest

from memotr_tpu.data import gen_gts as jax_gen
from memotr_tpu_torch.data import gen_gts as port_gen


def _tree(root):
    """{relative path: bytes} of every file under ``root``."""
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = fh.read()
    return out


def _mot17_src(tmp_path):
    rows = {"MOT17-02-SDP": ["1,5,10.7,20.2,30,40,1,1,0.5",
                             "1,9,1,1,5,5,0,1,1.0",
                             "1,7,2,2,6,6,1,2,1.0",
                             "2,5,11,21,30,40,1,1,0.25",
                             "2,8,50,60,7,8,1,1,1.0",
                             "3,5,12,22,30,40,1,1,1.0"],
            "MOT17-04-SDP": ["1,1,3,4,5,6,1,1,1.0", "2,1,4,4,5,6,1,1,0.75"]}
    for seq, lines in rows.items():
        d = tmp_path / "src" / seq / "gt"
        d.mkdir(parents=True)
        (d / "gt.txt").write_text("\n".join(lines) + "\n")
    (tmp_path / "src" / "no-gt").mkdir()
    return ["mot17", "--seq-root", str(tmp_path / "src")]


def _crowdhuman_src(tmp_path):
    recs = [{"ID": "img_a", "gtboxes": [
                {"tag": "person", "fbox": [1.9, 2.9, 10, 20], "extra": {}},
                {"tag": "mask", "fbox": [0, 0, 5, 5], "extra": {}},
                {"tag": "person", "fbox": [3, 4, 5, 6],
                 "extra": {"ignore": 1}}]},
            {"ID": "img_b", "gtboxes": [
                {"tag": "person", "fbox": [7, 8, 9, 10], "extra": {}}]}]
    ann = tmp_path / "ann.odgt"
    ann.write_text("\n".join(json.dumps(r) for r in recs) + "\n")
    for name in ("img_a", "img_b"):
        (tmp_path / f"{name}.jpg").write_bytes(b"\xff")
    return ["crowdhuman", "--data-root", str(tmp_path), "--ann", str(ann)]


def _bdd100k_src(tmp_path):
    box = {"x1": 1.0, "y1": 2.0, "x2": 11.0, "y2": 22.5}
    frames = [{"name": "vid-0000001.jpg", "labels": [
                  {"category": "pedestrian", "id": 3, "box2d": box,
                   "attributes": {}},
                  {"category": "car", "id": 4, "box2d": box,
                   "attributes": {"crowd": True}},
                  {"category": "bus", "id": 9, "box2d": box,
                   "attributes": {}},
                  {"category": "other person", "id": 6, "box2d": box,
                   "attributes": {}}]},
              {"name": "vid-0000002.jpg", "labels": []},
              {"name": "vid-0000003.jpg", "labels": [
                  {"category": "trailer", "id": 7, "box2d": box,
                   "attributes": {}}]}]
    d = tmp_path / "labels"
    d.mkdir()
    (d / "vid.json").write_text(json.dumps(frames))
    (d / "notes.txt").write_text("not a label file")
    return ["bdd100k", "--ann-dir", str(d)]


@pytest.mark.parametrize("source", [_mot17_src, _crowdhuman_src,
                                    _bdd100k_src])
def test_port_gts_equal_jax_gts(tmp_path, source):
    args = source(tmp_path)
    kind, named = args[0], dict(zip(args[1::2], args[2::2]))
    call = {"mot17": lambda m, out: m.gen_mot17(named["--seq-root"], out),
            "crowdhuman": lambda m, out: m.gen_crowdhuman(
                named["--data-root"], named["--ann"], out),
            "bdd100k": lambda m, out: m.gen_bdd100k(named["--ann-dir"], out)}
    call[kind](jax_gen, str(tmp_path / "jax"))
    call[kind](port_gen, str(tmp_path / "port"))
    port_gen.main(args + ["--out", str(tmp_path / "cli")])
    want = _tree(tmp_path / "jax")
    assert want
    assert _tree(tmp_path / "port") == want
    assert _tree(tmp_path / "cli") == want


def test_crowdhuman_missing_image_raises(tmp_path):
    args = _crowdhuman_src(tmp_path)
    os.remove(tmp_path / "img_b.jpg")
    with pytest.raises(FileNotFoundError):
        port_gen.main(args + ["--out", str(tmp_path / "out")])
