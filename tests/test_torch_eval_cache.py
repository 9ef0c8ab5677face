"""``models/eval_cache.same_mask``: the eval cache's per-step mask compare,
eight bytes at a time, against ``np.array_equal`` on the bools."""
import numpy as np
import pytest

from memotr_tpu_torch.models.eval_cache import same_mask


def _mask(shape, seed=0):
    return np.random.default_rng(seed).random(shape) < 0.3


@pytest.mark.parametrize("shape", [(24, 100, 192), (3, 7, 11), (1, 8, 8)])
@pytest.mark.parametrize("flip", [None, 0, "middle", -1])
def test_same_mask_matches_array_equal(shape, flip):
    """Equal masks, and masks one element apart at the start, the middle
    or the end, at sizes a multiple of 8 bytes and not."""
    a = _mask(shape)
    b = a.copy()
    if flip is not None:
        i = b.size // 2 if flip == "middle" else flip
        b.reshape(-1)[i] ^= True
    assert same_mask(a, b) == np.array_equal(a, b) == (flip is None)


def test_same_mask_takes_strided_masks():
    """A mask that is not C-contiguous is compared value by value."""
    a = _mask((4, 16, 24))
    b = np.ascontiguousarray(a.transpose(0, 2, 1)).transpose(0, 2, 1)
    assert not b.flags.c_contiguous
    assert same_mask(a, b)
    b[1, 2, 3] ^= True
    assert not same_mask(a, b)
