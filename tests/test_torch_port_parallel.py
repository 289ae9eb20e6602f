"""Data parallelism, the (data, grid) layout, the cooperative render and
checkpoints of a sharded run, on gloo ranks of the CPU.

One spawn of four gloo ranks (``parallel/spawn.py``, a file store under the
test's temporary directory) runs every distributed part of this file and
hands the results back:

* two FourierGrid train steps (three banks, X = 16, the near-clip, rgbper,
  distortion and entropy terms on, TV of both grids dense at the first step
  and sparse at the second, masked Adam with the skip) data-parallel at
  W = 2 (ranks {0, 1} and {2, 3}, two groups made with ``new_group``) and
  W = 4, each rank on its slice of the global batch; the same steps on the
  data 2 x grid 2 layout (``make_mesh(2)``: both grids cut along x, TV
  through the halo planes);
* the render of a view cooperatively over the four ranks;
* ``run_train`` with ``grid_parallel=2`` over the four ranks on
  ``nerf_unbounded/bicycle_single.py`` cut to 25^3 voxels in f32, across a
  ``pg_scale`` boundary: the first grids, 19 planes in x, stay whole (the
  JAX rule), the resized 24^3 ones are cut; its checkpoint, and two resumes
  to one more step: of that checkpoint, and of a checkpoint that one
  device wrote;
* the same at 21^3 voxels, whose lattice of 16 planes the boundary takes to
  20: both divide over 2, so the grids stay cut from the first step to the
  end, under spies on the one join (``mesh._gather_x``) and on every
  density and k0 tensor a rank makes or updates (the resize's source and
  result, the halo sample's extended slab, each Adam step's parameters and
  moments);
* each family's ``pg_scale`` boundary (FourierGrid, DCVGO, DVGO, DMPIGO)
  on grids cut over the grid axis: the slab resize and the occupancy
  refresh.

Held against, in this process: the single-device steps on the global batch
(parameters 1e-5 relative / 1e-6 absolute: the sums run in another order,
and Adam's first steps move a voxel by lr * g / |g|, so a last-bit change of
a gradient moves it by a last bit of lr), the replicas of every group equal
to the bit; JAX's data-parallel step on a mesh of W CPU devices (the
tolerance of ``test_torch_port_train.py``: 1e-4 / 2e-5); the single-device
render (1e-6: the MLP's matrix products at other batch sizes); the
single-device ``run_train`` (1e-5 / 1e-6 on every parameter, loaded on one
device from the checkpoints the ranks wrote); each family's one-device
boundary (the joined grids to the bit; the mask equal, but for FourierGrid,
whose refresh sums the banks' partial samples over the grid group in another
order: a flipped voxel must have a pooled alpha within 1e-6 of
``fast_color_thres``, and the flips are counted).
"""

import dataclasses
import pathlib
import shutil
from unittest import mock

import numpy as np
import pytest
import torch
import torch.distributed as dist

from unboundednerfpytorch_tpu_torch import convert
from unboundednerfpytorch_tpu_torch.configs import loader
from unboundednerfpytorch_tpu_torch.configs.schema import TrainStageConfig
from unboundednerfpytorch_tpu_torch.data import synthetic
from unboundednerfpytorch_tpu_torch.fields import grids as grids_mod
from unboundednerfpytorch_tpu_torch.models import fourier_grid as fg
from unboundednerfpytorch_tpu_torch.optim.masked_adam import MaskedAdam
from unboundednerfpytorch_tpu_torch.parallel import halo, spawn
from unboundednerfpytorch_tpu_torch.parallel import mesh as mesh_mod
from unboundednerfpytorch_tpu_torch.render.renderer import render_image
from unboundednerfpytorch_tpu_torch.train import loop
from unboundednerfpytorch_tpu_torch.train import step as tstep
from unboundednerfpytorch_tpu_torch.utils import checkpoint as ckpt

ROOT = pathlib.Path(__file__).resolve().parents[1]
TRAIN_KW = dict(
    N_rand=48, lrate_density=0.1, lrate_k0=0.1, lrate_rgbnet=1e-3, lrate_decay=20,
    weight_main=1.0, weight_entropy_last=0.01, weight_nearclip=1.0, weight_distortion=0.01,
    weight_rgbper=0.1, tv_before=1000, tv_dense_before=2, weight_tv_density=1e-2,
    weight_tv_k0=1e-3, skip_zero_grad_fields=("density", "k0"), pg_scale=())
NEAR_THRES = 0.3
STEP_TOL = dict(rtol=1e-5, atol=1e-6)
JAX_TOL = dict(rtol=1e-4, atol=2e-5)
VIEW = dict(H=8, W=10, chunk=30)
CUT_VOX = 21**3  # a lattice of 16^3 before the boundary, 20^3 after it
# each family's boundary on grids cut over 2 or 4 ranks: (start, new) voxel
# counts whose lattices' X the ranks divide (FourierGrid's start is the
# fixture's 16^3), and the density's mean, which leaves the refreshed mask
# neither full nor empty
REFRESH_CASES = {"FourierGrid/2": (17**3, 21**3, None), "FourierGrid/4": (17**3, 21**3, None),
                 "dcvgo/2": (17**3, 21**3, -8.0), "dvgo/2": (16**3, 18**3, -8.0),
                 "dmpigo/2": (17**3, 20**3, -12.0)}
FLIP_BAND = 1e-6  # a FourierGrid mask flip's pooled alpha, from fast_color_thres


def _batches():
    from test_torch_port_model import make_rays

    rng = np.random.default_rng(11)
    out = []
    for s in range(2):
        o, d, vd = make_rays(n=TRAIN_KW["N_rand"], seed=20 + s)
        out.append(dict(rays_o=o, rays_d=d, viewdirs=vd,
                        rgb=rng.random((o.shape[0], 3)).astype(np.float32)))
    return out


def _as_numpy(params) -> dict:
    out = {"density": params.density.grid.detach().float().numpy().copy(),
           "k0": params.k0.grid.detach().float().numpy().copy()}
    for i, lin in enumerate(params.rgbnet.layers):
        out[f"w{i}"] = lin.weight.detach().numpy().copy()
        out[f"b{i}"] = lin.bias.detach().numpy().copy()
    return out


def _steps(np_params, tcfg, batches, mesh=None):
    """Two port steps from ``np_params`` on ``batches``; with ``mesh`` each
    rank takes its slice and the grids are cut where its grid axis says.
    Returns (the parameters as numpy, whole; the metrics of each step)."""
    params = convert.fourier_grid_params_from_numpy(np_params, "cpu")
    train = TrainStageConfig(**TRAIN_KW)
    step = tstep.make_train_step(
        lambda p, ro, rd, vd, bg: fg.forward(p, tcfg, ro, rd, vd, bg_color=bg), train,
        world_size_max=float(max(tcfg.world_size)), near_thres=NEAR_THRES, lr_anchor=1,
        mesh=mesh)
    state = tstep.create_train_state(params, train)
    if mesh is not None and mesh.grid > 1:
        assert mesh_mod.shard_params(mesh, params, state.optimizer) == ["density", "k0"]
    part = slice(None) if mesh is None else mesh.batch_slice(TRAIN_KW["N_rand"])
    metrics = []
    for b in batches:
        m = step(state, {k: torch.from_numpy(v[part]) for k, v in b.items()})
        metrics.append({k: float(v) for k, v in m.items()})
    mesh_mod.unshard_params(params, state.optimizer)
    return _as_numpy(params), metrics


def _fwd(tcfg):
    return lambda p: (lambda ro, rd, vd: fg.forward(p, tcfg, ro, rd, vd))


def _view():
    K = np.array([[9.0, 0, 5], [0, 9.0, 4], [0, 0, 1]], np.float32)
    pose = synthetic.look_at_pose(np.array([2.4, 1.9, 0.6]), np.array([0.0, 0.5, 0.0]))
    return K, pose[:3, :4]


def _train_cfg(n_iters, vox=25**3):
    """bicycle_single cut to ``vox`` voxels (25^3: a lattice of 19^3 before
    the boundary, 24^3 after it)."""
    cfg = loader.load_config(str(ROOT / "configs" / "nerf_unbounded" / "bicycle_single.py"))
    # f32 grids: a bf16 grid's gradient is rounded once a rank before the sum
    # and once after it, so the runs would part by a bf16 rounding a step
    fm = dataclasses.replace(cfg.fine_model_and_render, num_voxels_density=vox,
                             num_voxels_rgb=vox, num_voxels_base_density=vox,
                             num_voxels_base_rgb=vox, sample_budget=16, grid_dtype="float32")
    ft = dataclasses.replace(cfg.fine_train, pg_scale=(2,), N_iters=n_iters, N_rand=256)
    return dataclasses.replace(cfg, fine_model_and_render=fm, fine_train=ft)


def _run_train(cfg, data, exp_dir):
    return loop.run_train(cfg, data, seed=0, device="cpu", log_fn=lambda *_: None,
                          exp_dir=exp_dir)


def _spy(fn, take):
    """``fn`` that hands its arguments and result to ``take``."""
    def wrapped(*args, **kw):
        out = fn(*args, **kw)
        take(args, out)
        return out
    return wrapped


def _cut_run(data, work):
    """run_train over (data 2, grid 2) at ``CUT_VOX``, 3 steps across the
    boundary, then the resumes of its checkpoint and of one device's to a 4th
    step, under the spies: the joins of a grid or a moment, and the x-widths
    of every density and k0 tensor a rank makes or updates."""
    joins, widths, boundary, logs = [], [], {}, []

    def adam_widths(args, _):
        opt = args[0]
        for g in opt.groups:
            if g.name in mesh_mod.SHARDED_FIELDS:
                widths.extend(t.shape[1] for p in g.params
                              for t in (p, opt.exp_avg[p], opt.exp_avg_sq[p]))

    spies = (
        mock.patch.object(mesh_mod, "_gather_x", _spy(
            mesh_mod._gather_x, lambda a, _: joins.append(tuple(a[0].shape)))),
        mock.patch.object(grids_mod, "resize_banks", _spy(
            grids_mod.resize_banks, lambda a, out: widths.extend((a[0].shape[1],
                                                                  out.shape[1])))),
        mock.patch.object(halo, "partial_sample", _spy(
            halo.partial_sample, lambda a, _: widths.append(a[0].shape[1]))),
        mock.patch.object(MaskedAdam, "step", _spy(MaskedAdam.step, adam_widths)),
    )
    for s in spies:
        s.start()
    try:
        _, _, params, _ = loop.run_train(
            _train_cfg(3, CUT_VOX), data, seed=0, device="cpu", log_fn=logs.append,
            exp_dir=f"{work}/cut", grid_parallel=2,
            callback=lambda s, m: boundary.update(m.get("pg_scale", {})))
        ends = [params.density.grid.shape[1], params.k0.grid.shape[1]]
        mesh_mod.barrier()
        if mesh_mod.rank() == 0:
            shutil.copytree(f"{work}/cut/fine_last", f"{work}/cut3")
        mesh_mod.barrier()
        for name in ("cut", "single_cut"):
            _, _, params, _ = loop.run_train(_train_cfg(4, CUT_VOX), data, seed=0, device="cpu",
                                             log_fn=lambda *_: None, exp_dir=f"{work}/{name}",
                                             grid_parallel=2)
            ends += [params.density.grid.shape[1], params.k0.grid.shape[1]]
    finally:
        for s in spies:
            s.stop()
    return dict(joins=joins, widths=widths, ends=ends, boundary=boundary, logs=logs)


def _refresh(fam):
    """Each family's boundary (``loop.scale_model``) on its grids cut over
    the grid axis of (data 2, grid 2) or (data 1, grid 4): the resized grids
    joined, and the mask."""
    meshes = {2: mesh_mod.make_mesh(grid_parallel=2), 4: mesh_mod.make_mesh(grid_parallel=4)}
    out = {}
    for case, (tree, cfg, nv) in fam.items():
        family, ways = case.split("/")
        mesh = meshes[int(ways)]
        params = convert.params_from_numpy(family, tree, "cpu").requires_grad_(False)
        assert mesh_mod.shard_params(mesh, params) == ["density", "k0"]
        loop.scale_model(family, params, cfg, nv, nv, report={})
        out[case] = {n: mesh_mod._gather_x(getattr(params, n).grid,
                                           getattr(params, n).shard).numpy()
                     for n in mesh_mod.sharded_names(params)}
        out[case]["mask"] = params.mask_cache.mask.numpy()
    return out


def _ranks(rank, world, np_params, tcfg, batches, data, work, fam):
    out = {}
    # data-parallel at W = 2: ranks {0, 1} and {2, 3}, each pair a data group
    pairs = [dist.new_group([0, 1]), dist.new_group([2, 3])]
    m2 = mesh_mod.Mesh(data=2, grid=1, rank=rank % 2, data_group=pairs[rank // 2],
                       grid_group=None, grid_ranks=(rank,))
    out["dp2"] = _steps(np_params, tcfg, batches, m2)
    out["dp4"] = _steps(np_params, tcfg, batches, mesh_mod.make_mesh())
    out["grid"] = _steps(np_params, tcfg, batches, mesh_mod.make_mesh(grid_parallel=2))
    params = convert.fourier_grid_params_from_numpy(np_params, "cpu").requires_grad_(False)
    K, c2w = _view()
    out["render"] = render_image(_fwd(tcfg)(params), VIEW["H"], VIEW["W"], K, c2w,
                                 chunk=VIEW["chunk"], device="cpu", mesh=mesh_mod.make_mesh())
    # run_train over (data 2, grid 2): 3 steps across the boundary, then the
    # resumes of its checkpoint and of one device's to a 4th step
    resumed, boundary, logs = [], {}, []

    def spy(step, metrics):
        if "pg_scale" in metrics:
            boundary.update(metrics["pg_scale"])

    cfg3, cfg4 = _train_cfg(3), _train_cfg(4)
    loop.run_train(cfg3, data, seed=0, device="cpu", log_fn=logs.append,
                   exp_dir=f"{work}/grid", grid_parallel=2, callback=spy)
    out["boundary"], out["logs"] = boundary, logs
    mesh_mod.barrier()
    if rank == 0:
        shutil.copytree(f"{work}/grid/fine_last", f"{work}/grid3")
    mesh_mod.barrier()
    for name in ("grid", "single"):
        loop.run_train(cfg4, data, seed=0, device="cpu", log_fn=lambda *_: None,
                       exp_dir=f"{work}/{name}", grid_parallel=2,
                       callback=lambda s, m: resumed.append(s))
    out["resumed_steps"] = resumed
    # an N_rand the four ranks do not divide: every rank trains alone
    odd = dataclasses.replace(cfg3, fine_train=dataclasses.replace(
        cfg3.fine_train, N_rand=255, N_iters=1, pg_scale=()))
    odd_logs = []
    _, _, params, _ = loop.run_train(odd, data, seed=0, device="cpu", log_fn=odd_logs.append)
    out["odd"] = (odd_logs, _as_numpy(params))
    out["cut"] = _cut_run(data, work)
    out["refresh"] = _refresh(fam)
    return out


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    from test_torch_port_model import jax_params_to_numpy, make_pair

    vox = 17**3  # a lattice of 16^3: X divides over 2 and 4 ranks
    jcfg, jp, tcfg, _ = make_pair(seed=7, num_voxels_density=vox, num_voxels_rgb=vox,
                                  num_voxels_base_density=vox, num_voxels_base_rgb=vox)
    np_params = jax_params_to_numpy(jp)
    batches = _batches()
    data = synthetic.orbit_scene(4, 16, 24, seed=0)
    work = tmp_path_factory.mktemp("parallel")
    # one device's runs: their 3-step checkpoints are the ones 4-rank resumes take
    for name, vox in (("single", 25**3), ("single_cut", CUT_VOX)):
        _run_train(_train_cfg(3, vox), data, str(work / name))
        shutil.copytree(work / name / "fine_last", work / f"{name}3")
    fam = _refresh_inputs(tcfg, np_params)
    res = spawn.run(_ranks, 4, str(work / "store"), np_params, tcfg, batches, data, str(work),
                    fam)
    return dict(jcfg=jcfg, jp=jp, tcfg=tcfg, np_params=np_params, batches=batches, data=data,
                work=work, res=res, fam=fam)


def _refresh_inputs(tcfg, np_params) -> dict:
    """{case: (its params as numpy, its config, the boundary's voxel
    count)} of ``REFRESH_CASES``: the fixture's FourierGrid model, and DCVGO,
    DVGO and DMPIGO models with N(mean, 4^2) densities (the pairs of their
    parity tests)."""
    from test_torch_port_dvgo import make_pair as dvgo_pair
    from test_torch_port_families import make_pair as family_pair

    fam = {}
    for case, (start, nv, mean) in REFRESH_CASES.items():
        family = case.split("/")[0]
        kw = dict(num_voxels_density=start, num_voxels_rgb=start, offset=mean)
        if family == "FourierGrid":
            fam[case] = (np_params, tcfg, nv)
            continue
        _, _, cfg, params = dvgo_pair(**kw) if family == "dvgo" else family_pair(family, **kw)
        fam[case] = (convert.params_to_numpy(params), cfg, nv)
    return fam


def _assert_params(got: dict, want: dict, **tol):
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **tol)


@pytest.mark.parametrize("layout", ["dp2", "dp4", "grid"])
def test_parallel_step_matches_one_device(run, layout):
    want, want_m = _steps(run["np_params"], run["tcfg"], run["batches"])
    res = run["res"]
    got, got_m = res[0][layout]
    _assert_params(got, want, **STEP_TOL)
    for gm, wm in zip(got_m, want_m):
        for k in wm:
            assert gm[k] == pytest.approx(wm[k], rel=1e-5, abs=1e-7), k
    assert want_m[0]["loss_rgbper"] > 0 and want_m[0]["loss_distortion"] > 0
    for r in range(1, 4):  # every replica equal to the bit
        for k, v in res[r][layout][0].items():
            np.testing.assert_array_equal(v, got[k], err_msg=f"rank {r} {k}")


@pytest.mark.parametrize("W", [2, 4])
def test_dp_step_matches_jax_dp_step(run, W):
    """The pattern of tests/test_parallel.py: the JAX step on a batch
    sharded over a data mesh of W CPU devices."""
    import jax
    import jax.numpy as jnp

    from unboundednerfpytorch_tpu.configs.schema import TrainStageConfig as JTrainStageConfig
    from unboundednerfpytorch_tpu.models import fourier_grid as jfg
    from unboundednerfpytorch_tpu.parallel import mesh as jmesh
    from unboundednerfpytorch_tpu.train import step as jstep

    jcfg, jp = run["jcfg"], run["jp"]
    jtrain = JTrainStageConfig(**TRAIN_KW)
    step = jstep.make_train_step(
        lambda p, ro, rd, vd, key, img_index=None: jfg.forward(p, jcfg, ro, rd, vd), jtrain,
        world_size_max=float(max(jcfg.world_size)), near_thres=NEAR_THRES, lr_anchor=1)
    mesh = jmesh.make_mesh(W)
    state = jstep.create_train_state(jp, jtrain)
    state = state.replace(params=jmesh.shard_params(mesh, state.params))
    jstep_fn = jax.jit(step)
    with mesh:
        for s, b in enumerate(run["batches"]):
            batch = jmesh.shard_batch(mesh, {k: jnp.asarray(v) for k, v in b.items()})
            state, _ = jstep_fn(state, batch, jax.random.PRNGKey(s))
    got = run["res"][0][f"dp{W}"][0]
    want = {"density": np.asarray(state.params.density.grid, np.float32),
            "k0": np.asarray(state.params.k0.grid, np.float32)}
    for i, (w, b) in enumerate(zip(state.params.rgbnet.weights, state.params.rgbnet.biases)):
        want[f"w{i}"], want[f"b{i}"] = np.asarray(w).T, np.asarray(b)
    _assert_params(got, want, **JAX_TOL)


def test_cooperative_render_matches_one_device(run):
    params = convert.fourier_grid_params_from_numpy(run["np_params"], "cpu")
    params.requires_grad_(False)
    K, c2w = _view()
    want = render_image(_fwd(run["tcfg"])(params), VIEW["H"], VIEW["W"], K, c2w,
                        chunk=VIEW["chunk"], device="cpu")
    assert want[0].std() > 0
    for r in range(4):
        for got, w in zip(run["res"][r]["render"], want):
            np.testing.assert_allclose(got, w, rtol=0, atol=1e-6)


def _load(path):
    _, _, params, step, opt = ckpt.load_model(str(path), device="cpu")
    params.requires_grad_(False)
    flat = {"density": params.density.grid.float().numpy(), "k0": params.k0.grid.float().numpy(),
            "mask": params.mask_cache.mask.numpy()}
    for i, lin in enumerate(params.rgbnet.layers):
        flat[f"w{i}"] = lin.weight.detach().numpy()
    for group, moments in opt["exp_avg"].items():
        for i, m in enumerate(moments):
            flat[f"m/{group}/{i}"] = np.asarray(m, np.float32)
    return flat, step


def test_grid_parallel_run_train_and_its_checkpoints(run):
    """run_train(grid_parallel=2) on (data 2, grid 2): the 19-plane grids
    before the boundary stay whole, the 24-plane ones are cut; its
    checkpoints, whole grids and moments in the one-device format, load on
    one device and equal the one-device run's, at step 3 and after the
    resumes to step 4 (of its own checkpoint and of one device's)."""
    work, res = run["work"], run["res"]
    assert any("grids cut over 2 ranks: none" in line for line in res[0]["logs"])
    assert not res[1]["logs"]  # rank 0 alone logs
    assert tuple(res[0]["boundary"]["world_size_density"]) == (24, 24, 24)
    assert res[0]["boundary"]["sharded"] == ["density", "k0"]
    assert res[0]["boundary"]["layout"] == {"density": "cut", "k0": "cut"}
    assert res[0]["resumed_steps"] == [4, 4]
    single4 = work / "single4"
    shutil.copytree(work / "single3", single4 / "fine_last")
    _run_train(_train_cfg(4), run["data"], str(single4))
    for got_path, want_path, step in ((work / "grid3", work / "single3", 3),
                                      (work / "grid" / "fine_last", single4 / "fine_last", 4),
                                      (work / "single" / "fine_last", single4 / "fine_last", 4)):
        got, got_step = _load(got_path)
        want, want_step = _load(want_path)
        assert got_step == want_step == step
        assert got["density"].shape[1:4] == (24, 24, 24)
        np.testing.assert_array_equal(got.pop("mask"), want.pop("mask"))
        _assert_params(got, want, **STEP_TOL)


def test_grid_parallel_keeps_cut_grids_cut(run):
    """run_train(grid_parallel=2) at 21^3 voxels: its lattice of 16 planes
    and the boundary's 20 both divide over 2, so the grids stay cut from the
    first step to the end and through both resumes: no rank joins a grid or
    a moment (the spy on ``mesh._gather_x``) or holds a density or k0 tensor
    wider than its slab and two planes; the stage hands on its slabs. Its
    checkpoints load on one device and equal one device's run at step 3 and
    after the resumes to step 4 (of its own checkpoint and of one
    device's)."""
    work = run["work"]
    for r in range(4):
        cut = run["res"][r]["cut"]
        assert cut["joins"] == [], f"rank {r}"
        assert cut["widths"] and max(cut["widths"]) <= 20 // 2 + 2, f"rank {r}"
        assert cut["ends"] == [10] * 6, f"rank {r}"
    cut = run["res"][0]["cut"]
    assert any("grids cut over 2 ranks: ['density', 'k0']" in line for line in cut["logs"])
    assert tuple(cut["boundary"]["world_size_density"]) == (20, 20, 20)
    assert cut["boundary"]["sharded"] == ["density", "k0"]
    assert cut["boundary"]["layout"] == {"density": "kept cut", "k0": "kept cut"}
    single4 = work / "single_cut4"
    shutil.copytree(work / "single_cut3", single4 / "fine_last")
    _run_train(_train_cfg(4, CUT_VOX), run["data"], str(single4))
    for got_path, want_path, step in ((work / "cut3", work / "single_cut3", 3),
                                      (work / "cut" / "fine_last", single4 / "fine_last", 4),
                                      (work / "single_cut" / "fine_last", single4 / "fine_last",
                                       4)):
        got, got_step = _load(got_path)
        want, want_step = _load(want_path)
        assert got_step == want_step == step
        assert got["density"].shape[1:4] == (20, 20, 20)
        np.testing.assert_array_equal(got.pop("mask"), want.pop("mask"))
        _assert_params(got, want, **STEP_TOL)


@pytest.mark.parametrize("case", list(REFRESH_CASES))
def test_sharded_boundary_matches_one_device(run, case):
    """A family's boundary on grids cut over 2 (or 4) ranks: the slabs
    resized with their neighbours' planes, joined, equal one device's resize
    to the bit; the refreshed mask, whole on every rank, equals one device's
    (FourierGrid: up to flips within ``FLIP_BAND`` of the threshold,
    counted)."""
    family = case.split("/")[0]
    tree, cfg, nv = run["fam"][case]
    params = convert.params_from_numpy(family, tree, "cpu").requires_grad_(False)
    report = {}
    _, new_cfg = loop.scale_model(family, params, cfg, nv, nv, report=report)
    assert params.density.grid.shape[1] % 2 == 0
    want_mask = params.mask_cache.mask.numpy()
    assert 0 < want_mask.mean() < 1
    for r in range(4):
        got = run["res"][r]["refresh"][case]
        for name in ("density", "k0"):
            np.testing.assert_array_equal(
                got[name], getattr(params, name).grid.numpy(), err_msg=f"{case} {name} rank {r}")
        flips = got["mask"] != want_mask
        if family != "FourierGrid":
            assert not flips.any(), f"{case} rank {r}: {int(flips.sum())} flips"
            continue
        pooled = report["pooled_alpha"].numpy()
        off = np.abs(pooled[flips] - new_cfg.fast_color_thres)
        assert (off <= FLIP_BAND).all(), f"rank {r}: {int(flips.sum())} flips, {off.max()} off"
        np.testing.assert_array_equal(got["mask"], run["res"][0]["refresh"][case]["mask"])


def test_n_rand_that_does_not_divide_trains_single_device(run):
    """As the JAX loop: the log line, then every rank trains the whole batch
    alone (no collective), equal to one device's run."""
    res = run["res"]
    logs, got = res[0]["odd"]
    assert "fine: N_rand=255 not divisible by 4 devices — training single-device" in logs
    cfg = _train_cfg(1)
    cfg = dataclasses.replace(cfg, fine_train=dataclasses.replace(
        cfg.fine_train, N_rand=255, pg_scale=()))
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # as each rank has
    try:
        want = _as_numpy(loop.run_train(cfg, run["data"], seed=0, device="cpu",
                                        log_fn=lambda *_: None)[2])
    finally:
        torch.set_num_threads(threads)
    for r in range(4):
        for k, v in want.items():
            np.testing.assert_array_equal(res[r]["odd"][1][k], v, err_msg=f"rank {r} {k}")


def test_host_store_slices_the_global_batch():
    """A rank's host-store batch is its slice of the one-device batch: the
    same draws (indices and backgrounds), only its rows gathered."""
    rng = np.random.default_rng(0)
    store = {k: rng.random((500, 3)).astype(np.float32)
             for k in ("rgb", "rays_o", "rays_d", "viewdirs")}
    store["img_index"] = rng.integers(0, 5, 500).astype(np.int32)

    def sampler(part):
        return tstep.HostRayStoreSampler(store, 48, 3, "cpu", mode="random", part=part,
                                         bg_generator=torch.Generator().manual_seed(1))

    whole, parts = sampler(None), [sampler(slice(0, 24)), sampler(slice(24, 48))]
    for _ in range(3):
        wb, wbg = whole.next_batch()
        got = [s.next_batch() for s in parts]
        for k in wb:
            torch.testing.assert_close(torch.cat([g[0][k] for g in got]), wb[k], rtol=0, atol=0)
        torch.testing.assert_close(torch.cat([g[1] for g in got]), wbg, rtol=0, atol=0)
