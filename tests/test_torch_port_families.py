"""The port's DCVGO and DMPIGO families, with NDC rays, against the JAX
package on the CPU.

Tiny configs: DCVGO at 24^3 voxels (a 23^3 lattice, 78 samples a ray), DMPIGO at
``mpi_depth`` 16; random grids, rgbnet width 16, ``fast_color_thres`` on.
JAX parameters are drawn, carried into the port by ``convert`` and the same
rays (and the same random background) go through both packages. The mask
cache stays all-true in the forwards (a sample on a voxel's half-way point
could round to another voxel with the last ulp of a coordinate).

Tolerances: forwards as the FourierGrid family's (1e-4 relative, 1e-6
absolute; 2e-5 absolute for the raw density, which spans +-15); three train steps as ``test_three_train_steps_match_jax``
(2e-5 absolute, 1e-4 relative); NDC rays, the NDC bbox, NDC sampling and the
plain ``cumdist_thres`` bit-exact; a boundary's grids 1e-6 (the same f32
lerp), its mask exact.
"""

import dataclasses
import pathlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from unboundednerfpytorch_tpu.configs.schema import ModelRenderConfig as JModelRenderConfig
from unboundednerfpytorch_tpu.configs.schema import TrainStageConfig as JTrainStageConfig
from unboundednerfpytorch_tpu.models import dcvgo as jdcvgo
from unboundednerfpytorch_tpu.models import dmpigo as jdmpigo
from unboundednerfpytorch_tpu.ops import rays as jrays
from unboundednerfpytorch_tpu.ops import sampling as jsampling
from unboundednerfpytorch_tpu.train import bbox as jbbox
from unboundednerfpytorch_tpu.train import step as jstep
from unboundednerfpytorch_tpu_torch import convert
from unboundednerfpytorch_tpu_torch.configs import loader
from unboundednerfpytorch_tpu_torch.configs.schema import ModelRenderConfig, TrainStageConfig
from unboundednerfpytorch_tpu_torch.models import dcvgo, dmpigo
from unboundednerfpytorch_tpu_torch.ops import rays, sampling
from unboundednerfpytorch_tpu_torch.ops.cuda import build
from unboundednerfpytorch_tpu_torch.ops.cuda.ub360 import cumdist_thres
from unboundednerfpytorch_tpu_torch.train import bbox, loop
from unboundednerfpytorch_tpu_torch.train import step as tstep
from unboundednerfpytorch_tpu_torch.utils import checkpoint as ckpt

ROOT = pathlib.Path(__file__).resolve().parents[1]
XYZ_MIN, XYZ_MAX = (-2.0, -1.5, -1.0), (2.0, 2.5, 1.0)
MODEL_KW = dict(
    num_voxels_density=24**3, num_voxels_rgb=24**3, num_voxels_base_density=24**3,
    num_voxels_base_rgb=24**3, rgbnet_dim=4, rgbnet_width=16, alpha_init=1e-2,
    fast_color_thres=1e-4, bg_len=0.2, stepsize=0.5, mpi_depth=16,
    maskout_near_cam_vox=False)
TRAIN_KW = dict(
    N_rand=48, lrate_density=0.1, lrate_k0=0.1, lrate_rgbnet=1e-3, lrate_decay=20,
    weight_main=1.0, weight_entropy_last=0.01, weight_nearclip=1.0, weight_distortion=0.01,
    weight_rgbper=0.1, tv_before=1000, tv_dense_before=1000, weight_tv_density=1e-2,
    weight_tv_k0=1e-3, skip_zero_grad_fields=("density", "k0"), pg_scale=())
FAMILY = {"dcvgo": (jdcvgo, dcvgo), "dmpigo": (jdmpigo, dmpigo)}
# a forward-facing camera (looking down -z) of a 24x32 view, for NDC rays
NDC_HW, NDC_FOCAL = (24, 32), 30.0


def ndc_view(c2w):
    H, W = NDC_HW
    K = np.array([[NDC_FOCAL, 0, W / 2], [0, NDC_FOCAL, H / 2], [0, 0, 1]], np.float32)
    return H, W, K, np.asarray(c2w, np.float32)[:3, :4]


def ndc_poses(n=3, seed=0):
    rng = np.random.default_rng(seed)
    poses = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    poses[:, :2, 3] = rng.uniform(-0.3, 0.3, (n, 2))
    poses[:, 2, 3] = rng.uniform(-0.1, 0.1, n)
    return poses


def ndc_bbox():
    poses = ndc_poses()
    H, W, K, _ = ndc_view(poses[0])
    return jbbox.bbox_bounded(np.array([[H, W]] * len(poses)), np.stack([K] * len(poses)),
                              poses, 0.0, 1.0, ndc=True)


def make_pair(family, seed=0, offset=None, **overrides):
    """(JAX config, JAX params, port config, port params) with random grids:
    density N(offset, 4^2) (offset -4 for DCVGO, 0 for DMPIGO by default),
    k0 N(0, 0.5^2)."""
    jmod, tmod = FAMILY[family]
    kw = {**MODEL_KW, **overrides}
    lo, hi = (XYZ_MIN, XYZ_MAX) if family == "dcvgo" else ndc_bbox()
    jcfg = jmod.config_from(JModelRenderConfig(**kw), lo, hi, kw["num_voxels_rgb"])
    tcfg = tmod.config_from(ModelRenderConfig(**kw), lo, hi, kw["num_voxels_rgb"])
    rng = np.random.default_rng(seed)
    jp = jmod.create(jcfg, jax.random.PRNGKey(seed))
    if offset is None:
        offset = -4.0 if family == "dcvgo" else 0.0
    dgrid = rng.standard_normal(jp.density.grid.shape) * 4.0 + offset
    kgrid = rng.standard_normal(jp.k0.grid.shape) * 0.5
    jp = jp.replace(density=jp.density.replace(grid=jnp.asarray(dgrid, jp.density.grid.dtype)),
                    k0=jp.k0.replace(grid=jnp.asarray(kgrid, jp.k0.grid.dtype)))
    tp = convert.params_from_numpy(family, convert.tree_from_params_object(jp), "cpu")
    return jcfg, jp, tcfg, tp


def make_rays(family, n=48, seed=1):
    """DCVGO: rays from around the scene box, looking roughly inwards;
    DMPIGO: NDC rays of seeded pixels of forward-facing views."""
    rng = np.random.default_rng(seed)
    if family == "dcvgo":
        center = (np.asarray(XYZ_MIN) + np.asarray(XYZ_MAX)) / 2
        o = center + rng.standard_normal((n, 3)) * 1.5
        d = center + rng.standard_normal((n, 3)) * 0.5 - o
        vd = d / np.linalg.norm(d, axis=-1, keepdims=True)
        return [a.astype(np.float32) for a in (o, d, vd)]
    H, W, K, c2w = ndc_view(ndc_poses(1, seed)[0])
    ro, rd, vd = jrays.get_rays_of_a_view(H, W, jnp.asarray(K), jnp.asarray(c2w), ndc=True)
    pick = rng.choice(H * W, n, replace=False)
    return [np.asarray(a).reshape(-1, 3)[pick] for a in (ro, rd, vd)]


def forward_pair(family, jcfg, tcfg):
    jmod, tmod = FAMILY[family]
    kw = dict(near=0.0) if family == "dcvgo" else {}

    def jfwd(params, ro, rd, vd, key, img_index=None):
        return jmod.forward(params, jcfg, ro, rd, vd, stepsize=0.5, rand_bkgd_key=key, **kw)

    def tfwd(p, ro, rd, vd, bg):
        return tmod.forward(p, tcfg, ro, rd, vd, stepsize=0.5, bg_color=bg, **kw)

    return jfwd, tfwd


def test_configs_match_jax():
    for family in FAMILY:
        jcfg, _, tcfg, _ = make_pair(family)
        names = ["world_size", "voxel_size_ratio", "rgbnet_in_dim", "k0_dim"]
        names += (["n_inner", "act_shift", "scene_center", "scene_radius"]
                  if family == "dcvgo" else ["xyz_min", "xyz_max"])
        for name in names:
            assert getattr(tcfg, name) == getattr(jcfg, name), (family, name)
    assert 2 * make_pair("dcvgo")[2].n_inner == 78  # a 23^3 lattice


@pytest.mark.parametrize("family", ["dcvgo", "dmpigo"])
def test_forward_matches_jax(family):
    jcfg, jp, tcfg, tp = make_pair(family)
    jfwd, tfwd = forward_pair(family, jcfg, tcfg)
    o, d, vd = make_rays(family)
    key = jax.random.PRNGKey(3)
    want = jfwd(jp, jnp.asarray(o), jnp.asarray(d), jnp.asarray(vd), key)
    bg = torch.from_numpy(np.array(jax.random.uniform(key, (o.shape[0], 3))))
    got = tfwd(tp, torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(vd), bg)
    assert got.n_max == want.n_max
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(want.mask))
    assert 0 < int(got.mask.sum()) < got.mask.numel()  # the masks bite
    fields = ["rgb_marched", "alphainv_last", "weights", "raw_alpha", "raw_rgb", "raw_density",
              "t", "s", "depth"] + (["wsum_mid"] if family == "dcvgo" else [])
    for field in fields:
        # the raw density spans about +-15 and is a sum of eight products:
        # a few ulps of its terms are 1e-5
        atol = 2e-5 if field == "raw_density" else 1e-6
        np.testing.assert_allclose(getattr(got, field).detach().numpy(),
                                   np.asarray(getattr(want, field)), rtol=1e-4, atol=atol,
                                   err_msg=field)


@pytest.mark.parametrize("family", ["dcvgo", "dmpigo"])
def test_cached_forward_equals_the_grids(family):
    """The render cache (one packed density+k0 table) gives the forward of
    the grids themselves."""
    _, _, tcfg, tp = make_pair(family, seed=5)
    _, tmod = FAMILY[family]
    o, d, vd = (torch.from_numpy(a) for a in make_rays(family, seed=6))
    cache = tmod.build_render_cache(tp, tcfg)
    assert cache is not None
    with torch.no_grad():
        a = tmod.forward(tp, tcfg, o, d, vd, cache=cache)
        b = tmod.forward(tp, tcfg, o, d, vd)
    for field in ("rgb_marched", "weights", "depth"):
        torch.testing.assert_close(getattr(a, field), getattr(b, field), rtol=1e-5, atol=1e-6)


def test_ndc_rays_bbox_and_sampling_are_bit_exact():
    poses = ndc_poses(3, seed=2)
    for c2w in poses:
        H, W, K, c2w = ndc_view(c2w)
        want = jrays.get_rays_of_a_view(H, W, jnp.asarray(K), jnp.asarray(c2w), ndc=True)
        got = rays.get_rays_of_a_view(H, W, torch.from_numpy(K), torch.from_numpy(c2w), ndc=True)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    HW = np.array([[H, W]] * len(poses))
    Ks = np.stack([K] * len(poses))
    for g, w in zip(bbox.bbox_bounded(HW, Ks, poses, 0.0, 1.0, ndc=True),
                    jbbox.bbox_bounded(HW, Ks, poses, 0.0, 1.0, ndc=True)):
        np.testing.assert_array_equal(g, w)
    lo, hi = ndc_bbox()
    lo, hi = lo + 0.1 * (hi - lo), hi - 0.1 * (hi - lo)  # a box that some samples leave
    o, d, _ = make_rays("dmpigo", n=64, seed=3)
    want = jsampling.sample_ndc_pts_on_rays(jnp.asarray(o), jnp.asarray(d), jnp.asarray(lo),
                                            jnp.asarray(hi), 31)
    got = sampling.sample_ndc_pts_on_rays(torch.from_numpy(o), torch.from_numpy(d),
                                          tuple(lo), tuple(hi), 31)
    for g, w in zip(got, (want.pts, want.mask, want.t)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert 0 < int(got[1].sum()) < got[1].numel()


def test_cumdist_thres_plain_is_the_jax_scan_bit_for_bit():
    rng = np.random.default_rng(0)
    dist = (rng.random((37, 130)) * 0.1).astype(np.float32)
    dist[::5, 40:60] = 0.0
    for thres in (0.03, 0.21):
        want = np.asarray(jsampling.cumdist_thres(jnp.asarray(dist), thres))
        got = sampling.cumdist_thres_plain(torch.from_numpy(dist), thres)
        np.testing.assert_array_equal(got.numpy(), want)
        assert 0 < want.sum() < want.size
    build.reset_launch_counts()
    np.testing.assert_array_equal(cumdist_thres(torch.from_numpy(dist), 0.03).numpy(),
                                  np.asarray(jsampling.cumdist_thres(jnp.asarray(dist), 0.03)))
    assert not build.LAUNCHES  # a CPU tensor takes the plain version


def test_cumdist_thres_refuses_what_the_kernel_does_not_take():
    with pytest.raises(ValueError, match="GPU"):
        cumdist_thres(torch.zeros((4, 5), device="meta"), 0.1)
    assert not build.LAUNCHES


@pytest.mark.parametrize("family", ["dcvgo", "dmpigo"])
def test_three_train_steps_match_jax(family):
    jcfg, jp, tcfg, tp = make_pair(family, seed=7)
    near_thres = 0.3 if family == "dcvgo" else 0.0
    ws_max = float(max(jcfg.world_size))
    axis_scale = loop.tv_axis_scale(family, tcfg)
    assert (axis_scale is None) == (family == "dcvgo")
    if axis_scale is not None:
        assert axis_scale[2] != axis_scale[0]  # DMPIGO: z weighed otherwise than xy
    jtrain, ttrain = JTrainStageConfig(**TRAIN_KW), TrainStageConfig(**TRAIN_KW)
    jfwd, tfwd = forward_pair(family, jcfg, tcfg)
    j_step = jax.jit(jstep.make_train_step(jfwd, jtrain, world_size_max=ws_max,
                                           near_thres=near_thres, tv_axis_scale=axis_scale,
                                           lr_anchor=1))
    j_state = jstep.create_train_state(jp, jtrain)
    t_step = tstep.make_train_step(tfwd, ttrain, world_size_max=ws_max, near_thres=near_thres,
                                   tv_axis_scale=axis_scale, lr_anchor=1)
    t_state = tstep.create_train_state(tp, ttrain)
    rng = np.random.default_rng(11)
    for s in range(3):
        o, d, vd = make_rays(family, n=TRAIN_KW["N_rand"], seed=20 + s)
        batch = dict(rays_o=o, rays_d=d, viewdirs=vd,
                     rgb=rng.random((o.shape[0], 3)).astype(np.float32))
        key = jax.random.PRNGKey(100 + s)
        j_state, j_m = j_step(j_state, {k: jnp.asarray(v) for k, v in batch.items()}, key)
        bg = torch.from_numpy(np.array(jax.random.uniform(key, (o.shape[0], 3))))
        t_m = t_step(t_state, {k: torch.from_numpy(v) for k, v in batch.items()}, bg)
        for name in set(j_m) & {"loss", "mse", "psnr", "loss_entropy", "loss_nearclip",
                                "loss_distortion", "loss_rgbper", "lr_scale"}:
            assert float(t_m[name]) == pytest.approx(float(j_m[name]), rel=1e-4, abs=1e-6), name
    jparams = j_state.params
    pairs = [(t_state.params.density.grid[0], jparams.density.grid),
             (t_state.params.k0.grid[0], jparams.k0.grid)]
    pairs += [(lin.weight.T, w) for lin, w in zip(t_state.params.rgbnet.layers,
                                                   jparams.rgbnet.weights)]
    pairs += [(lin.bias, b) for lin, b in zip(t_state.params.rgbnet.layers, jparams.rgbnet.biases)]
    for got, want in pairs:
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-4, atol=2e-5)
    assert not np.any(np.asarray(jparams.k0.grid) == np.asarray(jp.k0.grid))  # dense TV
    assert t_state.step == 3 == int(j_state.step)


@pytest.mark.parametrize("family", ["dcvgo", "dmpigo"])
def test_scale_volume_grid_matches_jax(family):
    """A pg_scale boundary (24^3 -> 2 x 24^3 voxels) with the refresh, and the
    loop's boundary on top: act_shift lowered, the optimizer rebuilt."""
    # DMPIGO's per-plane bias lifts every plane's alpha: a lower density lets
    # the refreshed mask drop voxels
    offset = None if family == "dcvgo" else -12.0
    jcfg, jp, tcfg, tp = make_pair(family, seed=3, offset=offset)
    jmod, tmod = FAMILY[family]
    n = 2 * MODEL_KW["num_voxels_rgb"]
    jp2, jcfg2 = jmod.scale_volume_grid(jp, jcfg, n)
    report = {}
    tp2, tcfg2 = tmod.scale_volume_grid(tp, tcfg, n, report=report)
    assert tcfg2.world_size == jcfg2.world_size != jcfg.world_size
    for name in ("density", "k0"):
        np.testing.assert_allclose(getattr(tp2, name).grid[0].detach().numpy(),
                                   np.asarray(getattr(jp2, name).grid), rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(tp2.mask_cache.mask.numpy(), np.asarray(jp2.mask_cache.mask))
    assert 0 < float(tp2.mask_cache.mask.float().mean()) < 1 == report["carried"]
    # the loop's boundary
    tp = make_pair(family, seed=3, offset=offset)[3]
    ttrain = TrainStageConfig(**{**TRAIN_KW, "pg_scale": (5,)})
    state = tstep.create_train_state(tp, ttrain, start_step=4)
    shift = np.array(tp.act_shift, np.float32)
    fm = ModelRenderConfig(**{**MODEL_KW, "num_voxels_rgb": n, "num_voxels_density": n})
    state, cfg3, rec = loop.pg_scale_boundary(state, tcfg, fm, ttrain, 5)
    assert cfg3 == tcfg2 and rec["world_size_rgb"] == tcfg2.world_size
    np.testing.assert_allclose(np.array(tp.act_shift, np.float32),
                               shift - ttrain.decay_after_scale, rtol=0, atol=1e-6)
    assert state.optimizer.step_count == 0 and state.step == 4


def test_update_occupancy_cache_matches_jax():
    for family in FAMILY:
        jcfg, jp, tcfg, tp = make_pair(family, seed=8)
        jmod, tmod = FAMILY[family]
        want = np.asarray(jmod.update_occupancy_cache(jp, jcfg).mask_cache.mask)
        got = tmod.update_occupancy_cache(tp, tcfg).mask_cache.mask.numpy()
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("family", ["dcvgo", "dmpigo"])
def test_checkpoint_and_convert_round_trips_from_jax(tmp_path, family):
    """JAX params -> port -> the port's checkpoint -> port -> JAX layout:
    equal to the bit; and the JAX optimizer's state the same way."""
    jcfg, jp, tcfg, tp = make_pair(family, seed=4)
    tree = convert.tree_from_params_object(jp)
    jtrain, ttrain = JTrainStageConfig(**TRAIN_KW), TrainStageConfig(**TRAIN_KW)
    j_state = jstep.create_train_state(jp, jtrain)
    j_opt = convert.opt_state_tree_from_object(j_state.opt_state._replace(
        step=jnp.asarray(3, jnp.int32),
        exp_avg=jax.tree.map(lambda x: x + 0.25, j_state.opt_state.exp_avg)))
    t_state = tstep.create_train_state(tp, ttrain, start_step=3,
                                       opt_state=convert.opt_state_from_numpy(j_opt, family))
    path = str(tmp_path / "fine_last")
    ckpt.save_model(path, family, tcfg, tp, global_step=3,
                    opt_state=t_state.optimizer.state_dict())
    fam, cfg2, tp2, step, opt = ckpt.load_model(path)
    assert (fam, cfg2, step) == (family, tcfg, 3)
    back = convert.params_to_numpy(tp2)
    for name in ("density", "k0"):
        assert back[name]["grid"].shape == tree[name]["grid"].shape
        np.testing.assert_array_equal(back[name]["grid"], tree[name]["grid"])
    np.testing.assert_array_equal(back["act_shift"], tree["act_shift"])
    for a, b in zip(back["rgbnet"]["weights"], tree["rgbnet"]["weights"]):
        np.testing.assert_array_equal(a, b)
    opt_back = convert.opt_state_to_numpy(
        {k: v if k == "step" else {n: [torch.from_numpy(a) for a in ms] for n, ms in v.items()}
         for k, v in opt.items()}, family)
    flat_g, flat_w = ckpt._flatten(opt_back), ckpt._flatten(j_opt)
    assert sorted(flat_g) == sorted(flat_w)
    for k in flat_w:
        np.testing.assert_array_equal(flat_g[k], flat_w[k], err_msg=k)


# the configs this slice unblocks, one of each kind: (config, family, grid
# banks of the full config, host store)
SEVEN = [("nerf_unbounded/bicycle.py", "dcvgo", 1, False),
         ("nerf_unbounded/counter.py", "dcvgo", 1, False),
         ("llff/fern.py", "dmpigo", 1, False),
         ("llff/fern_lg.py", "dmpigo", 1, False),
         ("tankstemple_unbounded/Truck.py", "FourierGrid", 7, True),
         ("tankstemple_unbounded/Train.py", "FourierGrid", 7, True),
         ("lf/africa.py", "FourierGrid", 7, False)]


@pytest.mark.parametrize("name,family,banks,host", SEVEN, ids=[s[0] for s in SEVEN])
def test_the_configs_of_this_slice_build_their_models(name, family, banks, host):
    """Each loads through the port's ``configs.loader`` and builds its model
    at a reduced width (16^3 voxels, pg_scale kept) without refusal."""
    cfg = loader.load_config(str(ROOT / "configs" / name))
    assert loop.model_family_name(cfg) == family
    assert cfg.data.load2gpu_on_the_fly == host
    fm = dataclasses.replace(cfg.fine_model_and_render, num_voxels_rgb=16**3,
                             num_voxels_density=16**3)
    lo, hi = ((-1.0, -1.0, -1.0), (1.0, 1.0, 1.0))
    fam, mcfg, params = loop.build_model(cfg, fm, cfg.fine_train, lo, hi,
                                         torch.Generator().manual_seed(0), "cpu")
    assert fam == family and loop.family_of(mcfg) == family
    assert params.density.grid.shape[0] == banks
    if family == "dmpigo":
        assert mcfg.world_size[2] == fm.mpi_depth
        assert params.act_shift.shape == (fm.mpi_depth,)
