"""The halo-exchange sample and the halo TV of grids cut along x, on gloo
ranks of the CPU, against the JAX package and the port's whole grids.

One spawn of four gloo ranks (``parallel/spawn.py``, a file store under the
test's temporary directory) runs every distributed check of this file and
hands the results back:

* the sample of a banked grid [3, 8, 5, 6, 2] cut over W = 2 (two groups of
  the data 2 x grid 2 layout) and W = 4 ranks, its values and the gradient
  of a weighted sum, at random points, at points on every shard boundary
  (x exactly on a plane k * xs and on the plane before it), on the last
  plane and out of range. Against the port's unsharded sample (values
  1e-6 of the largest, f32 sums in another order; the slab gradients,
  joined, 1e-5) and against JAX's ``parallel/halo.sharded_grid_sample`` on
  a mesh of W CPU devices, a bank at a time (the same tolerances);
* TV through the exchanged boundary planes: each rank's slab result,
  joined, equals the whole grid's to the bit, dense and sparse.

Without ranks: the plain TV of the slabs with their halo planes, joined,
equals the whole grid's to the bit and JAX's ``total_variation_grad`` within
1e-6 (another order of the three axes' terms).
"""

import numpy as np
import pytest
import torch

from unboundednerfpytorch_tpu_torch.ops import interp
from unboundednerfpytorch_tpu_torch.ops.cuda import tv as tv_cuda
from unboundednerfpytorch_tpu_torch.parallel import halo, spawn
from unboundednerfpytorch_tpu_torch.parallel import mesh as mesh_mod

SHAPE = (3, 8, 5, 6, 2)  # [B, X, Y, Z, C]: X divides over 2 and 4 ranks
TV_W = (0.3, 0.2, 0.1)


def _inputs():
    rng = np.random.default_rng(5)
    grid = rng.standard_normal(SHAPE).astype(np.float32)
    B, X = SHAPE[0], SHAPE[1]
    pts = [rng.random((40, B, 3))]
    # x exactly on each plane k and at the plane before a boundary, y and z random
    for plane in range(X):
        q = rng.random((2, B, 3))
        q[..., 0] = plane / (X - 1)
        pts.append(q)
    edge = rng.random((6, B, 3))
    edge[0, :, 0], edge[1, :, 0] = 1.0, 1.0 - 1e-7  # the last plane and just under it
    edge[2, :, 0], edge[3, :, 0] = -0.05, 1.07  # out of range in x
    edge[4, :, 1], edge[5, :, 2] = 1.3, -0.2  # out of range in y and z
    pts.append(edge)
    c01 = np.concatenate(pts).astype(np.float32)
    cot = rng.standard_normal((c01.shape[0], SHAPE[-1])).astype(np.float32)
    tv_grad = rng.standard_normal(SHAPE).astype(np.float32)
    tv_grad[np.abs(tv_grad) < 0.6] = 0.0  # the sparse mode's untouched voxels
    return grid, c01, cot, tv_grad


def _sample_on(mesh, shard_count, grid, c01, cot):
    """(values, this shard's slab gradient) of the sharded sample."""
    xs = SHAPE[1] // shard_count
    k = mesh.grid_index
    slab = torch.tensor(grid[:, k * xs:(k + 1) * xs]).requires_grad_(True)
    out = halo.sharded_grid_sample(slab, torch.tensor(c01), mesh.shard(SHAPE[1]))
    (out * torch.tensor(cot)).sum().backward()
    return out.detach().numpy(), slab.grad.numpy()


def _tv_on(shard, grid, g, dense):
    xs = SHAPE[1] // shard.count
    slab = torch.tensor(grid[:, shard.index * xs:(shard.index + 1) * xs]).contiguous()
    gs = torch.tensor(g[:, shard.index * xs:(shard.index + 1) * xs]).contiguous()
    lo, hi = halo.exchange_boundary_planes(slab, shard)
    return tv_cuda.tv_add_grad(slab, gs, *TV_W, 1.0, dense, lo=lo, hi=hi).numpy()


def _ranks(rank, world, grid, c01, cot, tv_grad):
    out = {}
    m2 = mesh_mod.make_mesh(grid_parallel=2)  # ranks {0, 1} and {2, 3}
    out[2] = _sample_on(m2, 2, grid, c01, cot)
    m4 = mesh_mod.make_mesh(grid_parallel=4)
    out[4] = _sample_on(m4, 4, grid, c01, cot)
    out["tv"] = {dense: _tv_on(m4.shard(SHAPE[1]), grid, tv_grad, dense)
                 for dense in (True, False)}
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    grid, c01, cot, tv_grad = _inputs()
    res = spawn.run(_ranks, 4, str(tmp_path_factory.mktemp("halo")), grid, c01, cot, tv_grad)
    return (grid, c01, cot, tv_grad), res


def _unsharded(grid, c01, cot):
    g = torch.tensor(grid).requires_grad_(True)
    out = interp.grid_sample_banks(g, torch.tensor(c01))
    (out * torch.tensor(cot)).sum().backward()
    return out.detach().numpy(), g.grad.numpy()


def _jax_sample(W, grid, c01, cot):
    """JAX's halo sample, a bank at a time, summed; and the gradient."""
    import jax
    import jax.numpy as jnp

    from unboundednerfpytorch_tpu.parallel import halo as jhalo
    from unboundednerfpytorch_tpu.parallel import mesh as jmesh

    mesh = jmesh.make_mesh(W, grid_parallel=W)

    def f(g):
        out = None
        for b in range(g.shape[0]):
            v = jhalo.sharded_grid_sample(mesh, g[b], jnp.asarray(c01[:, b]))
            out = v if out is None else out + v
        return out

    @jax.jit
    def value_and_vjp(g, c):
        val, vjp = jax.vjp(f, g)
        return val, vjp(c)[0]

    val, grad = value_and_vjp(jnp.asarray(grid), jnp.asarray(cot))
    return np.asarray(val), np.asarray(grad)


@pytest.mark.parametrize("W", [2, 4])
def test_halo_sample_values_and_grads(ranks, W):
    (grid, c01, cot, _), res = ranks
    want, want_g = _unsharded(grid, c01, cot)
    assert np.abs(want).max() > 0 and np.abs(want_g).max() > 0
    tol = 1e-6 * np.abs(want).max()
    for r in range(4):  # every rank of every grid group holds the whole answer
        np.testing.assert_allclose(res[r][W][0], want, rtol=0, atol=tol)
    group = range(W) if W == 4 else (0, 1)
    joined = np.concatenate([res[r][W][1] for r in group], axis=1)
    np.testing.assert_allclose(joined, want_g, rtol=0, atol=1e-5 * np.abs(want_g).max())
    jval, jgrad = _jax_sample(W, grid, c01, cot)
    np.testing.assert_allclose(res[0][W][0], jval, rtol=0, atol=tol)
    np.testing.assert_allclose(joined, jgrad, rtol=0, atol=1e-5 * np.abs(want_g).max())


@pytest.mark.parametrize("dense", [True, False], ids=["dense", "sparse"])
def test_halo_tv_joins_to_the_whole_grid(ranks, dense):
    (grid, _, _, tv_grad), res = ranks
    whole = tv_cuda.tv_add_grad(torch.tensor(grid), torch.tensor(tv_grad), *TV_W, 1.0, dense)
    joined = np.concatenate([res[r]["tv"][dense] for r in range(4)], axis=1)
    np.testing.assert_array_equal(joined, whole.numpy())


@pytest.mark.parametrize("W", [2, 4])
@pytest.mark.parametrize("dense", [True, False], ids=["dense", "sparse"])
def test_plain_tv_with_halo_planes(W, dense):
    import jax.numpy as jnp

    from unboundednerfpytorch_tpu.ops import tv as jtv

    grid, _, _, g = _inputs()
    p, gt = torch.tensor(grid), torch.tensor(g)
    whole = tv_cuda.tv_add_grad_plain(p, gt, *TV_W, 1.0, dense)
    xs = SHAPE[1] // W
    parts = []
    for k in range(W):
        sl = slice(k * xs, (k + 1) * xs)
        lo = p[:, k * xs - 1].contiguous() if k > 0 else None
        hi = p[:, (k + 1) * xs].contiguous() if k < W - 1 else None
        parts.append(tv_cuda.tv_add_grad_plain(p[:, sl].contiguous(), gt[:, sl].contiguous(),
                                               *TV_W, 1.0, dense, lo=lo, hi=hi))
    np.testing.assert_array_equal(torch.cat(parts, dim=1).numpy(), whole.numpy())
    want = np.stack([np.asarray(jtv.total_variation_grad(
        jnp.asarray(grid[b]), *TV_W, dense_mode=dense, existing_grad=jnp.asarray(g[b])))
        for b in range(SHAPE[0])]) + g
    np.testing.assert_allclose(whole.numpy(), want, rtol=0, atol=1e-6)
