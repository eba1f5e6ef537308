"""galah_tpu_torch packed intersection counts against the JAX package.

The port's plain torch version (the one CPU tensors take) must give the
same integers as the Pallas kernel in interpret mode and as a numpy
oracle; the wrapper validates its operands. The CUDA kernel itself runs
only on a card: its tests are in test_torch_cuda.py."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from galah_tpu.ops.packed_matmul import packed_intersect_matmul
from galah_tpu.ops.popcount_screen import pack_indicator as jax_pack_indicator
from galah_tpu_torch.ops.packed_matmul import (
    packed_intersect_counts,
    packed_intersect_counts_reference,
)
from galah_tpu_torch.utils.convert import (
    pack_indicator,
    u32_to_i32,
    words_to_torch,
)


def _pack(bits: np.ndarray) -> np.ndarray:
    return np.packbits(bits, axis=1, bitorder="little").view(np.uint32)


def _both(a_bits: np.ndarray, b_bits: np.ndarray, tm, tn, kw):
    a, b = _pack(a_bits), _pack(b_bits)
    want = np.asarray(
        packed_intersect_matmul(
            jnp.asarray(a), jnp.asarray(b), tm=tm, tn=tn, kw=kw, interpret=True
        )
    )
    got = packed_intersect_counts(words_to_torch(a), words_to_torch(b))
    return want, got


@pytest.mark.parametrize(
    "m,n,bits,tm,tn,kw",
    [
        (128, 128, 4096, 128, 128, 64),
        (256, 128, 8192, 128, 128, 128),
        (128, 256, 4096, 128, 128, 32),
    ],
)
def test_counts_match_pallas_kernel(m, n, bits, tm, tn, kw):
    rng = np.random.default_rng(m + n + bits)
    a = rng.random((m, bits)) < 0.15
    b = rng.random((n, bits)) < 0.15
    want, got = _both(a, b, tm, tn, kw)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_counts_match_pallas_kernel_dense_and_empty_rows():
    rng = np.random.default_rng(7)
    a = rng.random((128, 4096)) < 0.9
    a[3] = False  # empty row
    a[4] = True   # full row: every word is 0xFFFFFFFF, negative as int32
    b = rng.random((128, 4096)) < 0.9
    b[0] = True
    want, got = _both(a, b, 128, 128, 64)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize(
    "m,n,w",
    [(1, 1, 1), (7, 3, 5), (100, 77, 33), (65, 130, 600), (3, 0, 4), (0, 5, 4)],
)
def test_counts_match_numpy_oracle_at_ragged_shapes(m, n, w):
    rng = np.random.default_rng(m * 1000 + n * 10 + w)
    a = rng.integers(0, 1 << 32, size=(m, w), dtype=np.uint64).astype(np.uint32)
    b = rng.integers(0, 1 << 32, size=(n, w), dtype=np.uint64).astype(np.uint32)
    a_bits = np.unpackbits(a.view(np.uint8), axis=1).astype(np.int64)
    b_bits = np.unpackbits(b.view(np.uint8), axis=1).astype(np.int64)
    want = a_bits @ b_bits.T
    got = packed_intersect_counts(words_to_torch(a), words_to_torch(b))
    assert tuple(got.shape) == (m, n)
    np.testing.assert_array_equal(got.numpy(), want)


def test_cpu_tensors_take_the_plain_version_without_launching():
    rng = np.random.default_rng(3)
    a = words_to_torch(_pack(rng.random((9, 256)) < 0.3))
    before = packed_intersect_counts.launches
    got = packed_intersect_counts(a, a)
    assert packed_intersect_counts.launches == before
    assert torch.equal(got, packed_intersect_counts_reference(a, a))


@pytest.mark.parametrize(
    "a,b,err,match",
    [
        (torch.zeros((4, 8), dtype=torch.int32),
         torch.zeros((4, 9), dtype=torch.int32), ValueError, "width mismatch"),
        (torch.zeros((4, 8), dtype=torch.int64),
         torch.zeros((4, 8), dtype=torch.int32), TypeError, "int32"),
        (torch.zeros((4, 8), dtype=torch.int32),
         torch.zeros((4, 8), dtype=torch.int32, device="meta"),
         ValueError, "different devices"),
        (torch.zeros(8, dtype=torch.int32),
         torch.zeros((4, 8), dtype=torch.int32), ValueError, "2-D"),
        (torch.zeros((8, 4), dtype=torch.int32).T,
         torch.zeros((4, 8), dtype=torch.int32), ValueError, "contiguous"),
    ],
)
def test_wrapper_rejects_bad_operands(a, b, err, match):
    with pytest.raises(err, match=match):
        packed_intersect_counts(a, b)


def test_word_conversions_are_bit_identical():
    rng = np.random.default_rng(5)
    words = rng.integers(0, 1 << 32, size=(6, 11), dtype=np.uint64).astype(np.uint32)
    words[0, 0] = 0xFFFFFFFF
    words[0, 1] = 0x80000000
    t = words_to_torch(words)
    assert t.dtype == torch.int32
    np.testing.assert_array_equal(t.numpy().view(np.uint32), words)
    as64 = torch.from_numpy(words.astype(np.int64))
    assert torch.equal(u32_to_i32(as64), t)
    # arithmetic shift still gives exact bit tests
    for s in (0, 5, 31):
        np.testing.assert_array_equal(
            ((t >> s) & 1).numpy(), (words >> np.uint32(s)) & 1
        )


def test_pack_indicator_matches_jax_package():
    rng = np.random.default_rng(9)
    buckets = np.unique(rng.integers(0, 4096, size=700)).astype(np.int32)
    np.testing.assert_array_equal(
        pack_indicator(buckets, 4096), jax_pack_indicator(buckets, 4096)
    )
