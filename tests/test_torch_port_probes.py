"""The gather-probe functions of the port.

The TPU probes of the JAX package (``tools/probe_*.py``) build their inputs
inside functions that print and return nothing, so they cannot be called for
outputs; their kernels' bodies state the functions, and those statements are
written out here as numpy index expressions (the spot check of
``probe_vreg_gather.py`` is copied as it stands). The plain versions are also
held against JAX on the same seeded arrays, in the expressions of the tools'
own XLA baselines (``jnp.take``, sums of ``jax.lax.dynamic_slice``), and the
row loops against the bodies of the tools' row-loop kernels themselves
(``kernel2`` and ``p1_rowloop``, copied as they stand), run by
``pl.pallas_call(..., interpret=True)``. On the CPU a wrapper runs
its plain PyTorch version, which is what the CUDA kernel is held against on
the card. Indexed copies must be bit-equal; ``box_sum`` is a float32 sum in
another order, held to 1e-3 relative as on the card. Tests marked ``cuda``
launch the kernels and skip without a GPU.
"""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from unboundednerfpytorch_tpu_torch.ops.cuda import build
from unboundednerfpytorch_tpu_torch.ops.cuda import gather_probe as gp
from unboundednerfpytorch_tpu_torch.probes import gather, timing, variants


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")


def _bf16(a):
    return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)


def _rows_case(T, C, N, seed, dtype, idx_dtype=np.int32):
    rng = np.random.default_rng(seed)
    table = rng.standard_normal((T, C)).astype(np.float32)
    idx = rng.integers(0, T, N).astype(idx_dtype)
    tt = _bf16(table) if dtype == "bfloat16" else torch.from_numpy(table)
    return tt, torch.from_numpy(idx), idx


def _tile_case(A, C, n_blocks, seed):
    rng = np.random.default_rng(seed)
    table = _bf16(rng.standard_normal((n_blocks * A, C)))
    idx = rng.integers(0, A, n_blocks * A).astype(np.int32)
    return table, torch.from_numpy(idx), idx


def _box8_case(n_boxes, R, seed):
    rng = np.random.default_rng(seed)
    box = rng.standard_normal((n_boxes * 32, 8, 128)).astype(np.float32)
    dxyz = rng.integers(0, 16, (n_boxes * R, 3)).astype(np.int32)
    code = dxyz[:, 0] * 256 + dxyz[:, 1] * 16 + dxyz[:, 2]
    return box, dxyz, torch.from_numpy(box), torch.from_numpy(code)


def _box_sum_case(shape, box, n, seed):
    rng = np.random.default_rng(seed)
    table = _bf16(rng.standard_normal(shape))
    org = np.stack([rng.integers(0, s - b + 1, n) for s, b in zip(shape[:3], box)], -1)
    return table, torch.from_numpy(org.astype(np.int32)), org


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("idx_dtype", [np.int32, np.int64])
@pytest.mark.parametrize("T,C,N", [(64, 128, 300), (17, 12, 40), (5, 3, 9)])
def test_gather_rows_plain(T, C, N, dtype, idx_dtype):
    table, idx_t, idx = _rows_case(T, C, N, 0, dtype, idx_dtype)
    got = gp.gather_rows(table, idx_t)
    assert got.dtype == table.dtype
    np.testing.assert_array_equal(got.float().numpy(), table.float().numpy()[idx])


@pytest.mark.parametrize("A,C,n_blocks", [(8, 128, 5), (16, 256, 3), (4, 6, 7)])
def test_gather_tile_rows_plain(A, C, n_blocks):
    """out[b*A + i, :] = table[b*A + idx[b*A + i], :]"""
    table, idx_t, idx = _tile_case(A, C, n_blocks, 1)
    got = gp.gather_tile_rows(table, idx_t, A).float().numpy()
    src = table.float().numpy().reshape(n_blocks, A, C)
    want = np.stack([src[b][idx[b * A:(b + 1) * A]] for b in range(n_blocks)]).reshape(-1, C)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n_boxes,R", [(1, 8), (3, 64), (2, 4096)])
def test_box_gather8_plain(n_boxes, R):
    """The spot check of tools/probe_vreg_gather.py, for every request:
    ref = box[dx*2 + dy//8, dy%8, dz*8 : dz*8 + 8] within the request's box."""
    box, dxyz, box_t, code_t = _box8_case(n_boxes, R, 2)
    got = gp.box_gather8(box_t, code_t, R).numpy()
    assert got.shape == (n_boxes * R, 8)
    for r in range(0, n_boxes * R, max(1, n_boxes * R // 97)):
        dx, dy, dz = dxyz[r]
        b0 = box[(r // R) * 32:(r // R + 1) * 32]
        np.testing.assert_array_equal(got[r], b0[dx * 2 + dy // 8, dy % 8, dz * 8:dz * 8 + 8])
    # and all of them at once, through the cell view of a box
    cells = box.reshape(n_boxes, 16, 16, 16, 8)
    b = np.arange(n_boxes * R) // R
    np.testing.assert_array_equal(got, cells[b, dxyz[:, 0], dxyz[:, 1], dxyz[:, 2]])


@pytest.mark.parametrize("shape,box", [((9, 10, 11, 16), (4, 4, 8)), ((20, 18, 17, 8), (16, 16, 16)),
                                       ((6, 6, 6, 24), (6, 6, 6))])
def test_box_sum_plain(shape, box):
    """out[b, :] = sum of table[ox:ox+BX, oy:oy+BY, oz:oz+BZ, :] in float32."""
    table, org_t, org = _box_sum_case(shape, box, 7, 3)
    got = gp.box_sum(table, org_t, box).numpy()
    t = table.float().numpy().astype(np.float64)
    want = np.stack([t[x:x + box[0], y:y + box[1], z:z + box[2]].sum((0, 1, 2))
                     for x, y, z in org])
    assert got.dtype == np.float32 and got.shape == (7, shape[3])
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3 * np.abs(want).max())


def _np32(a):
    return np.asarray(jnp.asarray(a, jnp.float32))


ROWS = {"vector": gp.gather_rows, "loop": gp.gather_rows_loop}
TILE_ROWS = {"vector": gp.gather_tile_rows, "loop": gp.gather_tile_rows_loop}


@pytest.mark.parametrize("wrapper", ["vector", "loop"])
@pytest.mark.parametrize("T,C,N", [(64, 128, 300), (17, 12, 40)])
def test_gather_rows_plain_matches_jnp_take(T, C, N, wrapper):
    """``xla_take`` of tools/probe_pallas_gather.py: jnp.take(table, idx, axis=0)."""
    table, idx_t, idx = _rows_case(T, C, N, 10, "bfloat16")
    jt = jnp.asarray(table.float().numpy(), jnp.bfloat16)
    want = jnp.take(jt, jnp.asarray(idx), axis=0)
    np.testing.assert_array_equal(ROWS[wrapper](table, idx_t).float().numpy(), _np32(want))


@pytest.mark.parametrize("wrapper", ["vector", "loop"])
@pytest.mark.parametrize("A,C,n_blocks", [(8, 128, 5), (16, 256, 3)])
def test_gather_tile_rows_plain_matches_jnp_take(A, C, n_blocks, wrapper):
    """The body of tools/probe_dynamic_gather.py's kernel, block by block:
    jnp.take(tile, idx_of_tile, axis=0)."""
    table, idx_t, idx = _tile_case(A, C, n_blocks, 11)
    jt = jnp.asarray(table.float().numpy(), jnp.bfloat16).reshape(n_blocks, A, C)
    want = jax.vmap(lambda t, i: jnp.take(t, i, axis=0))(jt, jnp.asarray(idx).reshape(n_blocks, A))
    np.testing.assert_array_equal(TILE_ROWS[wrapper](table, idx_t, A).float().numpy(),
                                  _np32(want).reshape(-1, C))


@functools.lru_cache(maxsize=None)
def _kernel2_out(T, C, N, BLK):
    """``kernel2`` of tools/probe_pallas_gather.py (``vmem_rowloop``) and its
    ``pallas_call`` as they stand, in interpret mode, on the inputs of
    ``_rows_case``."""
    table_t, _, idx = _rows_case(T, C, N, 14, "bfloat16")
    table = jnp.asarray(table_t.float().numpy(), jnp.bfloat16)

    def kernel2(idx_ref, table_ref, out_ref):
        def body(i, _):
            out_ref[i, :] = table_ref[idx_ref[i], :]
            return 0
        jax.lax.fori_loop(0, BLK, body, 0)

    gathered2 = pl.pallas_call(
        kernel2,
        grid=(N // BLK,),
        in_specs=[
            pl.BlockSpec((BLK,), lambda i: (i,), memory_space=pltpu.VMEM),
            pl.BlockSpec((T, C), lambda i: (0, 0), memory_space=pltpu.VMEM),
        ],
        out_specs=pl.BlockSpec((BLK, C), lambda i: (i, 0),
                               memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((N, C), table.dtype),
        interpret=True,
    )
    return _np32(gathered2(jnp.asarray(idx), table))


@functools.lru_cache(maxsize=None)
def _p1_rowloop_out(A, C, n_blocks):
    """The kernel of tools/probe_kernel_gather.py's ``p1_rowloop`` and its
    ``pallas_call`` as they stand, in interpret mode, on the inputs of
    ``_tile_case``."""
    table_t, _, idx = _tile_case(A, C, n_blocks, 15)
    N = n_blocks * A
    dtype = jnp.bfloat16
    table = jnp.asarray(table_t.float().numpy(), dtype)

    def kernel(idx_ref, tile_ref, out_ref):
        def body(i, _):
            out_ref[i, :] = tile_ref[idx_ref[i], :]
            return 0

        jax.lax.fori_loop(0, A, body, 0, unroll=8)

    call = pl.pallas_call(
        kernel,
        grid=(n_blocks,),
        in_specs=[
            pl.BlockSpec((A,), lambda i: (i,), memory_space=pltpu.SMEM),
            pl.BlockSpec((A, C), lambda i: (i, 0), memory_space=pltpu.VMEM),
        ],
        out_specs=pl.BlockSpec((A, C), lambda i: (i, 0),
                               memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((N, C), dtype),
        interpret=True,
    )
    return _np32(call(jnp.asarray(idx), table))


@pytest.mark.parametrize("wrapper", ["loop", "vector"])
@pytest.mark.parametrize("T,C,N,BLK", [(16, 128, 32, 8), (40, 64, 48, 16)])
def test_gather_rows_matches_kernel2_in_interpret_mode(T, C, N, BLK, wrapper):
    """``gather_rows_loop`` (and the vector wrapper) bit-equal to the TPU
    row loop ``kernel2`` itself."""
    table, idx_t, _ = _rows_case(T, C, N, 14, "bfloat16")
    got = ROWS[wrapper](table, idx_t)
    assert got.dtype == torch.bfloat16 and got.shape == (N, C)
    np.testing.assert_array_equal(got.float().numpy(), _kernel2_out(T, C, N, BLK))


@pytest.mark.parametrize("wrapper", ["loop", "vector"])
@pytest.mark.parametrize("A,C,n_blocks", [(8, 128, 3), (16, 64, 2)])
def test_gather_tile_rows_matches_p1_rowloop_in_interpret_mode(A, C, n_blocks, wrapper):
    """``gather_tile_rows_loop`` (and the vector wrapper) bit-equal to the
    TPU row loop of ``p1_rowloop`` itself."""
    table, idx_t, _ = _tile_case(A, C, n_blocks, 15)
    got = TILE_ROWS[wrapper](table, idx_t, A)
    assert got.dtype == torch.bfloat16 and got.shape == (n_blocks * A, C)
    np.testing.assert_array_equal(got.float().numpy(), _p1_rowloop_out(A, C, n_blocks))


def test_box_gather8_plain_matches_dynamic_slice():
    """Each request as a jax.lax.dynamic_slice of its box in the stored
    [32, 8, 128] layout, at (dx*2 + dy//8, dy%8, dz*8), 8 lanes long."""
    n_boxes, R = 3, 64
    box, dxyz, box_t, code_t = _box8_case(n_boxes, R, 12)
    jb = jnp.asarray(box).reshape(n_boxes, 32, 8, 128)
    b = jnp.arange(n_boxes * R) // R
    d = jnp.asarray(dxyz)
    want = jax.vmap(lambda bi, x, y, z: jax.lax.dynamic_slice(
        jb[bi], (x * 2 + y // 8, y % 8, z * 8), (1, 1, 8)).reshape(8))(
            b, d[:, 0], d[:, 1], d[:, 2])
    np.testing.assert_array_equal(gp.box_gather8(box_t, code_t, R).numpy(), np.asarray(want))


@pytest.mark.parametrize("shape,box", [((9, 10, 11, 16), (4, 4, 8)),
                                       ((20, 18, 17, 8), (16, 16, 16))])
def test_box_sum_plain_matches_dynamic_slice_sum(shape, box):
    """``p2_boxdma`` of tools/probe_kernel_gather.py as XLA states it: the
    float32 sum of a jax.lax.dynamic_slice of the bfloat16 table."""
    table, org_t, org = _box_sum_case(shape, box, 7, 13)
    jt = jnp.asarray(table.float().numpy(), jnp.bfloat16)
    want = jax.vmap(lambda o: jax.lax.dynamic_slice(
        jt, (o[0], o[1], o[2], 0), (*box, shape[3])).astype(jnp.float32).sum((0, 1, 2)))(
            jnp.asarray(org, jnp.int32))
    want = np.asarray(want)
    np.testing.assert_allclose(gp.box_sum(table, org_t, box).numpy(), want, rtol=0,
                               atol=1e-3 * np.abs(want).max())


@pytest.mark.parametrize("row_bytes,lanes", [(256, 16), (512, 32), (1024, 32), (24, 4), (192, 16),
                                             (6, 4), (16, 1)])
def test_default_lanes(row_bytes, lanes):
    assert gp.default_lanes(row_bytes) == lanes


def test_indices_are_clamped_alike():
    """A bad index reads a wrong row, never memory outside the tensors; the
    plain versions clamp as the kernels do."""
    table = torch.arange(12.0).reshape(6, 2)
    np.testing.assert_array_equal(
        gp.gather_rows_plain(table, torch.tensor([-4, 99])).numpy(), table[[0, 5]].numpy())
    np.testing.assert_array_equal(
        gp.gather_tile_rows_plain(table, torch.tensor([5, -1, 0, 0, 0, 9]), 3).numpy(),
        table[[2, 0, 0, 3, 3, 5]].numpy())
    box, _, box_t, _ = _box8_case(1, 4, 4)
    got = gp.box_gather8_plain(box_t, torch.tensor([4096 + 273, -1], dtype=torch.int32), 4)
    cells = box.reshape(16, 16, 16, 8)
    np.testing.assert_array_equal(got.numpy(), np.stack([cells[1, 1, 1], cells[15, 15, 15]]))
    t, _, _ = _box_sum_case((5, 5, 5, 8), (2, 2, 2), 1, 5)
    far = gp.box_sum_plain(t, torch.tensor([[-3, 9, 4]], dtype=torch.int32), (2, 2, 2))
    np.testing.assert_array_equal(
        far.numpy(), gp.box_sum_plain(t, torch.tensor([[0, 3, 3]], dtype=torch.int32),
                                      (2, 2, 2)).numpy())


def test_wrappers_refuse_what_the_kernels_do_not_take():
    """Only a CPU tensor takes the plain path: a tensor on any other device
    goes to the launcher, which refuses what is not on the GPU, and nothing
    is built or launched."""
    build.reset_launch_counts()
    m = lambda *s, dtype=torch.float32: torch.zeros(s, dtype=dtype, device="meta")
    with pytest.raises(ValueError, match="GPU"):
        gp.gather_rows(m(4, 8), m(3, dtype=torch.int32))
    with pytest.raises(ValueError, match="GPU"):
        gp.gather_tile_rows(m(4, 8), m(4, dtype=torch.int32), 2)
    with pytest.raises(ValueError, match="GPU"):
        gp.box_gather8(m(32, 8, 128), m(4, dtype=torch.int32), 4)
    with pytest.raises(ValueError, match="GPU"):
        gp.box_sum(m(4, 4, 4, 8, dtype=torch.bfloat16), m(1, 3, dtype=torch.int32), (2, 2, 2))
    with pytest.raises(ValueError, match="GPU"):
        gp.gather_rows_loop(m(4, 8), m(3, dtype=torch.int32))
    with pytest.raises(ValueError, match="GPU"):
        gp.gather_tile_rows_loop(m(4, 8), m(4, dtype=torch.int32), 2)
    assert not build.LAUNCHES
    assert set(gp.__dict__) >= {"gather_rows_plain", "gather_tile_rows_plain",
                                "box_gather8_plain", "box_sum_plain"}
    assert set(build.KERNELS) >= {"gather_rows", "gather_tile_rows", "gather_rows_loop",
                                  "gather_tile_rows_loop", "box_gather8", "box_sum"}
    assert build.SOURCES["gather_probe"].is_file()


def test_row_loop_wrappers_clamp_as_the_plain_versions_on_the_cpu():
    """On the CPU the row-loop wrappers are the plain versions: out-of-range
    indices clamp alike, and a view that starts off a 16-byte boundary is
    taken (only the kernel needs the boundary)."""
    buf = torch.arange(40.0)
    table = buf[2:38].view(6, 6)  # 8 bytes past the storage's start
    idx = torch.tensor([-4, 99, 2], dtype=torch.int64)
    np.testing.assert_array_equal(gp.gather_rows_loop(table, idx).numpy(),
                                  table[[0, 5, 2]].numpy())
    tidx = torch.tensor([5, -1, 0, 0, 0, 9], dtype=torch.int32)
    np.testing.assert_array_equal(gp.gather_tile_rows_loop(table, tidx, 3).numpy(),
                                  gp.gather_tile_rows_plain(table, tidx, 3).numpy())
    assert not build.LAUNCHES


def test_probe_entry_point_on_cpu():
    """``run_all`` at tiny shapes on the CPU: every probe of the four tools,
    each checked against its plain version, the times labelled as the CPU's."""
    lines = []
    records = gather.run_all("cpu", log_fn=lines.append)
    assert [json.loads(line) for line in lines] == json.loads(json.dumps(records))
    probes = [r["probe"] for r in records]
    assert probes.count("dynamic_gather") == 4 and probes.count("p1_rowloop") == 2
    assert probes.count("vmem_take") == 1 and probes.count("vmem_rowloop") == 1
    assert probes.count("p2_boxdma") == 2 and probes.count("torch_index_select_slices") == 4
    assert probes.count("k0_layout") == 2 and "vreg_gather_f32" in probes
    kernels = {r["kernel"] for r in records}
    assert kernels == {"gather_rows", "gather_tile_rows", "gather_rows_loop",
                       "gather_tile_rows_loop", "box_gather8", "box_sum", None}
    for r in records:
        assert r["ok"] and r["ms"] > 0 and "cpu" in r["timed_on"]
        if "bound_ms" in r:
            assert r["bound_by"] == "bytes" and r["bound_ms"] > 0 and r["max_abs_err"] <= 1e-3
        if r["probe"] in gather.ROW_LOOPS:
            assert r["kernel"] in ("gather_rows_loop", "gather_tile_rows_loop")
            assert "lanes_per_row" not in r["shape"]
        elif r["kernel"] in ("gather_rows", "gather_tile_rows") and "shape" in r:
            assert r["shape"]["lanes_per_row"] == gp.default_lanes(r["shape"]["C"] * 2)
    assert {r["kernel"] for r in records if r["probe"] == "p1_rowloop"} == {
        "gather_tile_rows_loop"}
    assert {r["kernel"] for r in records if r["probe"] == "vmem_rowloop"} == {"gather_rows_loop"}
    assert not build.LAUNCHES


def test_probe_shapes_are_the_tools():
    """The shapes of tools/probe_*.py::main, so that the card's numbers answer
    the question the TPU probes asked."""
    assert [(a, c, n) for p, a, c, n in gather.TILE_SHAPES if p == "dynamic_gather"] == [
        (A, 128, (4 * 1024 * 1024) // A) for A in (1024, 2048, 4096)] + [(2048, 256, 2048)]
    assert [(a, c, n) for p, a, c, n in gather.TILE_SHAPES if p == "p1_rowloop"] == [
        (2048, 128, 512), (4096, 128, 256)]
    assert gather.ROWS_SHAPE == (32 * 1024, 128, 512 * 1024)
    assert gather.BOX8_SHAPE == (256, 4096)
    assert gather.BOX_SUM_TABLE == (161, 161, 161, 128)
    assert gather.BOX_SUM_SHAPES == (((16, 16, 8), 2048), ((16, 16, 16), 1024))
    assert gather.SLICE_SHAPE == (1 << 22, 128, 1 << 19)


def test_probe_entry_point_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        gather.main()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        gather.run_all()


def test_gather_bytes_counts_the_rows_touched():
    """A row gather's bound reads each source row its indices touch once:
    a table row drawn twice is read once, a row never drawn not at all."""
    table = torch.zeros((10, 128), dtype=torch.bfloat16)
    flat = torch.tensor([3, 3, 3, 7], dtype=torch.int64)
    assert gather.gather_bytes(table, flat) == 2 * 256 + 4 * 256 + 4 * 4
    recs = {r["probe"]: r for r in gather.run_all("cpu") if "bound_ms" in r}
    A, C, n_blocks = (recs["p1_rowloop"]["shape"][k] for k in ("A", "C", "n_blocks"))
    whole = timing.bound_ms(2 * A * n_blocks * C * 2 + A * n_blocks * 4, 0)[0]
    assert recs["p1_rowloop"]["bound_ms"] < whole


def test_probe_records_keep_call_and_launch_time_apart():
    """On the CPU both are the host clock; the keys are what chip_smoke reads."""
    recs = [r for r in gather.run_all("cpu") if "bound_ms" in r]
    assert recs and all(r["ms"] > 0 and r["call_ms"] > 0 for r in recs)


@pytest.mark.parametrize("make,n", [(variants.tv_variants, 5), (variants.march_variants, 8),
                                    (variants.march_backward_variants, 13),
                                    (variants.cumdist_variants, 11),
                                    (variants.gather_loop_variants, 9)])
def test_kernel_variants_still_find_their_text(make, n):
    """A variant is the committed source with one constant replaced: every
    substitution finds its text, and one variant is the source as committed."""
    made = make()
    assert len(made) == n and len(set(made.values())) == n
    committed = {build.SOURCES[k].read_text() for k in ("tv", "march", "ub360", "gather_probe")}
    assert sum(text in committed for text in made.values()) == 1


def test_variants_entry_point_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        variants.main()


def test_bound_ms():
    assert timing.bound_ms(3.35e12, 0) == (1000.0, "bytes")
    assert timing.bound_ms(1.0, 67e12) == (1000.0, "operations")


@pytest.mark.cuda
@pytest.mark.parametrize("lanes", [None, 1, 32])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("T,C,N", [(64, 128, 3000), (1700, 12, 4001), (50, 3, 90)])
def test_gather_rows_kernel_matches_plain(cuda, T, C, N, dtype, lanes):
    table, idx, _ = _rows_case(T, C, N, 6, dtype)
    got = gp.gather_rows(table.cuda(), idx.cuda(), lanes)
    assert torch.equal(got.cpu(), gp.gather_rows_plain(table, idx))


@pytest.mark.cuda
@pytest.mark.parametrize("lanes", [None, 1])
def test_gather_tile_rows_kernel_matches_plain(cuda, lanes):
    table, idx, _ = _tile_case(64, 128, 9, 7)
    got = gp.gather_tile_rows(table.cuda(), idx.cuda(), 64, lanes)
    assert torch.equal(got.cpu(), gp.gather_tile_rows_plain(table, idx, 64))
    with pytest.raises(ValueError, match="lanes"):
        gp.gather_tile_rows(table.cuda(), idx.cuda(), 64, 3)


@pytest.mark.cuda
def test_box_kernels_match_plain(cuda):
    _, _, box, code = _box8_case(3, 500, 8)
    got = gp.box_gather8(box.cuda(), code.cuda(), 500)
    assert torch.equal(got.cpu(), gp.box_gather8_plain(box, code, 500))
    table, org, _ = _box_sum_case((20, 18, 17, 128), (16, 16, 8), 11, 9)
    got = gp.box_sum(table.cuda(), org.cuda(), (16, 16, 8)).cpu()
    want = gp.box_sum_plain(table, org, (16, 16, 8))
    torch.testing.assert_close(got, want, rtol=0, atol=1e-3 * float(want.abs().max()))


# rows of 16, 48, 256 and 512 bytes
LOOP_ROWS = [("float32", 4), ("bfloat16", 24), ("bfloat16", 128), ("float32", 128)]


@pytest.mark.cuda
@pytest.mark.parametrize("idx_dtype", [np.int32, np.int64])
@pytest.mark.parametrize("dtype,C", LOOP_ROWS)
@pytest.mark.parametrize("T,N", [(64, 3000), (1700, 4001), (5, 1), (300, 17)])
def test_gather_rows_loop_kernel_matches_plain(cuda, T, N, dtype, C, idx_dtype):
    """Ragged N (no multiple of a stage's rows), out-of-range indices."""
    table, idx, _ = _rows_case(T, C, N, 16, dtype, idx_dtype)
    idx[::7] = torch.tensor([-5, T, 2 * T + 3])[torch.arange(len(idx[::7])) % 3].to(idx.dtype)
    build.reset_launch_counts()
    got = gp.gather_rows_loop(table.cuda(), idx.cuda())
    assert build.LAUNCHES["gather_rows_loop"] == 1
    assert torch.equal(got.cpu(), gp.gather_rows_plain(table, idx))


@pytest.mark.cuda
@pytest.mark.parametrize("idx_dtype", [np.int32, np.int64])
@pytest.mark.parametrize("dtype,C", LOOP_ROWS)
@pytest.mark.parametrize("A,n", [(64, 64 * 9), (100, 1037), (7, 7)])
def test_gather_tile_rows_loop_kernel_matches_plain(cuda, A, n, dtype, C, idx_dtype):
    """Ragged tiles and N, out-of-range indices."""
    rng = np.random.default_rng(17)
    table = torch.from_numpy(rng.standard_normal((n, C)).astype(np.float32)).to(
        getattr(torch, dtype))
    idx = torch.from_numpy(rng.integers(-3, A + 3, n).astype(idx_dtype))
    build.reset_launch_counts()
    got = gp.gather_tile_rows_loop(table.cuda(), idx.cuda(), A)
    assert build.LAUNCHES["gather_tile_rows_loop"] == 1
    assert torch.equal(got.cpu(), gp.gather_tile_rows_plain(table, idx, A))


@pytest.mark.cuda
def test_row_loop_kernels_refuse_what_a_bulk_copy_cannot_move(cuda):
    """A 24-byte row and a view off a 16-byte boundary raise, with no
    fallback to another kernel or to the plain version."""
    build.reset_launch_counts()
    idx = torch.zeros(4, dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError, match="multiple of 16"):
        gp.gather_rows_loop(torch.zeros((8, 12), dtype=torch.bfloat16, device="cuda"), idx)
    with pytest.raises(ValueError, match="multiple of 16"):
        gp.gather_tile_rows_loop(torch.zeros((4, 6), device="cuda"), idx, 2)
    buf = torch.zeros(8 * 8 + 2, device="cuda")
    view = buf[2:].view(8, 8)  # 32-byte rows starting 8 bytes in
    with pytest.raises(ValueError, match="16-byte boundary"):
        gp.gather_rows_loop(view, idx)
    with pytest.raises(ValueError, match="16-byte boundary"):
        gp.gather_tile_rows_loop(view, torch.zeros(8, dtype=torch.int32, device="cuda"), 4)
    assert not build.LAUNCHES
    # an aligned view is taken
    got = gp.gather_rows_loop(buf[:64].view(8, 8), idx)
    assert torch.equal(got, buf[:64].view(8, 8)[idx.long()])
