"""The port's binding of the native data plane (``native/dataplane.cpp``)
against the JAX package's, and against the Python decode path.

The port builds the library itself, with ``g++``, into
``memotr_tpu_torch/_build/``: the library the JAX package builds in
``native/`` plays no part.  Decodes are compared bit for bit: the same
source with the same flags, on the same file.
"""

import numpy as np
import PIL.Image
import pytest

from memotr_tpu.data import native as jax_native
from memotr_tpu.data.seq_dataset import SeqDataset as JaxSeqDataset
from memotr_tpu_torch.data import native
from memotr_tpu_torch.data.seq_dataset import SeqDataset


@pytest.fixture(scope="module")
def seq(tmp_path_factory):
    """A 3-frame sequence of 120x200 JPEGs."""
    rng = np.random.default_rng(0)
    d = tmp_path_factory.mktemp("seq")
    (d / "img1").mkdir()
    for t in range(1, 4):
        PIL.Image.fromarray(rng.integers(0, 255, (120, 200, 3), np.uint8)) \
            .save(d / "img1" / f"{t:08d}.jpg", quality=95)
    return d


@pytest.fixture(scope="module")
def built():
    if not native.available():
        pytest.skip(f"native data plane unavailable: "
                    f"{native.unavailable_reason()}")
    return native.build()


def test_library_is_built_into_the_port_build_dir(built):
    assert built.parent.parent == native.BUILD_DIR
    assert (built.parent / "build.log").read_text().startswith("g++ ")
    assert native.build() == built         # built once per source and flags


def test_decode_equals_jax_native_bit_for_bit(built, seq):
    if not jax_native.available():
        pytest.skip("the JAX package's native data plane is unavailable")
    path = str(seq / "img1" / "00000001.jpg")
    for fn in ("decode_sync", "decode_sync_u8"):
        got = getattr(native, fn)(path, 64, 128, (64, 128))
        want = getattr(jax_native, fn)(path, 64, 128, (64, 128))
        for a, b in zip(got, want):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                          err_msg=fn)
    with native.AsyncDecoder(2) as dec:
        jobs = [dec.submit(path, 64, 128, (64, 128)) for _ in range(4)]
        outs = [dec.wait(j) for j in jobs]
    want = jax_native.decode_sync(path, 64, 128, (64, 128))
    for out in outs:
        np.testing.assert_array_equal(out[0], want[0])
    assert native.decode_sync(str(seq / "missing.jpg"), 64, 128,
                              (64, 128)) is None


def test_seq_dataset_native_equals_python_and_jax(built, seq):
    """The port's SeqDataset frames through the native plane, through cv2,
    and JAX's uint8 frames: the same bytes."""
    fast = SeqDataset(str(seq), 64, 128)
    slow = SeqDataset(str(seq), 64, 128, use_native=False)
    jax_ds = JaxSeqDataset(str(seq), image_height=64, image_width=128,
                           uint8=True, use_native=False)
    assert (fast.decode_path, slow.decode_path) == ("native", "python")
    assert fast.padded_canvas() == slow.padded_canvas() == (64, 128)
    for i in range(len(fast)):
        a, b, c = fast[i], slow[i], jax_ds[i]
        for k in ("image", "mask"):
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
            np.testing.assert_array_equal(a[k], c[k], err_msg=k)
        assert a["ori_hw"] == b["ori_hw"] == tuple(c["ori_hw"]) == (120, 200)


def test_unavailable_compiler_is_reported(monkeypatch, tmp_path):
    """Where g++ or OpenCV's headers are missing, the data plane is
    unavailable with the reason, and SeqDataset decodes in Python."""
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setenv("PATH", str(tmp_path))      # neither g++ nor pkg-config
    assert not native.available()
    assert "pkg-config" in native.unavailable_reason() \
        or "No such file" in native.unavailable_reason()
