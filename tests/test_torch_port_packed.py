"""The port's ``ops/packed.py`` against the JAX package's, function by function.

Inputs come from a numpy seed and go through both packages on the CPU.
Tables are indexed copies of the grid, so they must be bit-equal; weights and
interpolated values are float32 sums and products in the same order, held to
1e-6 (relative to the largest value, plus 1e-6 absolute). A bfloat16 table is
promoted to float32 before the weighted sum in both packages, so its results
meet the same tolerance, far inside half a bfloat16 step. torch indexing
raises on a bad index where ``jnp.take(mode="clip")`` clips, so every base
index is also shown to lie inside its table.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from unboundednerfpytorch_tpu.ops import packed as jpacked
from unboundednerfpytorch_tpu_torch.ops import interp
from unboundednerfpytorch_tpu_torch.ops import packed

SHAPES = [(5, 4, 3, 2), (12, 13, 11, 1), (7, 7, 7, 12), (17, 3, 6, 4)]


def _grid(shape, seed=0, dtype="float32"):
    g = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    jg = jnp.asarray(g, jnp.bfloat16 if dtype == "bfloat16" else jnp.float32)
    tg = torch.from_numpy(g).to(torch.bfloat16 if dtype == "bfloat16" else torch.float32)
    return jg, tg


def _queries(n=200, seed=1):
    """Points in and slightly outside [0, 1]^3, and the exact corners."""
    rng = np.random.default_rng(seed)
    q = rng.uniform(-0.15, 1.15, (n, 3)).astype(np.float32)
    q[:8] = np.array([(x, y, z) for x in (0, 1) for y in (0, 1) for z in (0, 1)], np.float32)
    return q


def _np(x):
    """numpy float32 view of a jax or torch array (bfloat16 included)."""
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x.astype(jnp.float32))


def _close(got, want, tol=1e-6):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * max(1.0, np.abs(want).max()))


def test_corner_order_matches():
    assert packed.CORNERS == jpacked.CORNERS


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES)
def test_pack_corners_bit_equal(shape, dtype):
    jg, tg = _grid(shape, dtype=dtype)
    got = packed.pack_corners(tg)
    assert got.dtype == tg.dtype
    np.testing.assert_array_equal(_np(got), _np(jpacked.pack_corners(jg)))


def test_packed_table_bytes_is_logical():
    """The JAX function returns the size on a TPU (rows padded to 128
    lanes); the port's the logical size. They agree where a row fills its
    lanes (16 channels) and differ by the padding elsewhere."""
    dims = (9, 10, 11)
    assert packed.packed_table_bytes(dims, 16, 2) == jpacked.packed_table_bytes(dims, 16, 2)
    assert packed.packed_table_bytes(dims, 1, 4) * 16 == jpacked.packed_table_bytes(dims, 1, 4)
    assert packed.packed_table_bytes(dims, 13, 2) == 10 * 11 * 12 * 8 * 13 * 2


@pytest.mark.parametrize("dims", [(5, 4, 3), (12, 13, 11), (2, 2, 2)])
def test_corner_base_and_weights(dims):
    q = _queries()
    jb, jw = jpacked.corner_base_and_weights(jnp.asarray(q), dims)
    tb, tw = packed.corner_base_and_weights(torch.from_numpy(q), dims)
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    _close(tw, jw)
    n_rows = (dims[0] + 1) * (dims[1] + 1) * (dims[2] + 1)
    assert int(tb.min()) >= 0 and int(tb.max()) < n_rows  # no index leaves the table
    assert float(tw.min()) >= 0 and bool((tw.sum(-1) <= 1 + 1e-6).all())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES)
def test_packed_trilerp(shape, dtype):
    jg, tg = _grid(shape, seed=2, dtype=dtype)
    q = _queries(seed=3).reshape(20, 10, 3)
    dims, C = shape[:3], shape[3]
    jb, jw = jpacked.corner_base_and_weights(jnp.asarray(q), dims)
    tb, tw = packed.corner_base_and_weights(torch.from_numpy(q), dims)
    want = jpacked.packed_trilerp(jpacked.pack_corners(jg), jb, jw, C)
    got = packed.packed_trilerp(packed.pack_corners(tg), tb, tw, C)
    assert got.dtype == torch.float32 and got.shape == (20, 10, C)
    _close(got, want)


def test_packed_trilerp_clips_like_jnp_take():
    jg, tg = _grid((4, 4, 4, 2), seed=4)
    base = np.array([-3, 0, 124, 125, 1000], np.int64)  # the table has 125 rows
    w = np.random.default_rng(5).random((5, 8)).astype(np.float32)
    want = jpacked.packed_trilerp(jpacked.pack_corners(jg), jnp.asarray(base), jnp.asarray(w), 2)
    got = packed.packed_trilerp(packed.pack_corners(tg), torch.from_numpy(base),
                                torch.from_numpy(w), 2)
    _close(got, want)


@pytest.mark.parametrize("fold", [1, 4, 16])
@pytest.mark.parametrize("shape", [(5, 4, 3, 1), (12, 13, 11, 1), (7, 7, 7, 2)])
def test_pack_corners_folded_bit_equal(shape, fold):
    jg, tg = _grid(shape, seed=6)
    want = jpacked.pack_corners_folded(jg, fold)
    got = packed.pack_corners_folded(tg, fold)
    np.testing.assert_array_equal(_np(got), _np(want))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(5, 4, 3, 1), (20, 6, 5, 1), (33, 3, 3, 2), (15, 4, 4, 1)])
def test_pack_corners_folded_chunked_bit_equal(shape, dtype):
    """X + 1 below, at and above multiples of the 16-plane chunk."""
    jg, tg = _grid(shape, seed=7, dtype=dtype)
    want = jpacked.pack_corners_folded_chunked(jg, 16)
    got = packed.pack_corners_folded_chunked(tg, 16)
    np.testing.assert_array_equal(_np(got), _np(want))
    np.testing.assert_array_equal(_np(got), _np(packed.pack_corners_folded(tg, 16)))


def test_pack_corners_folded_chunked_refuses_a_bad_fold():
    with pytest.raises(ValueError, match="multiple"):
        packed.pack_corners_folded_chunked(torch.zeros(4, 4, 4, 1), 7, plane_chunk=3)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,fold", [((12, 13, 11, 1), 16), ((5, 4, 3, 2), 8),
                                        ((7, 7, 7, 1), 4)])
def test_packed_trilerp_folded(shape, fold, dtype):
    jg, tg = _grid(shape, seed=8, dtype=dtype)
    q = _queries(seed=9)
    dims, C = shape[:3], shape[3]
    jb, jw = jpacked.corner_base_and_weights(jnp.asarray(q), dims)
    tb, tw = packed.corner_base_and_weights(torch.from_numpy(q), dims)
    want = jpacked.packed_trilerp_folded(jpacked.pack_corners_folded(jg, fold), jb, jw, C, fold)
    got = packed.packed_trilerp_folded(packed.pack_corners_folded(tg, fold), tb, tw, C, fold)
    _close(got, want)
    # the folded read is the unfolded read
    _close(got, packed.packed_trilerp(packed.pack_corners(tg), tb, tw, C), tol=0)
    with pytest.raises(ValueError, match="folded table"):
        packed.packed_trilerp_folded(packed.pack_corners(tg), tb, tw, C, fold + 1)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES)
def test_grid_sample_3d_packed(shape, dtype):
    jg, tg = _grid(shape, seed=10, dtype=dtype)
    q = _queries(seed=11)
    want = jpacked.grid_sample_3d_packed(jg, jnp.asarray(q))
    got = packed.grid_sample_3d_packed(tg, torch.from_numpy(q))
    _close(got, want)
    # and the packed engine returns what the 8-corner gather returns
    _close(got, interp.grid_sample_3d(tg, torch.from_numpy(q)), tol=1e-6)
