"""The port's pose tuner (``--program tune_pose``, ``train/pose_tune.py``)
against the JAX package on the CPU.

``so3_exp``, ``apply_pose_delta`` and ``pixel_rays`` on the same numbers;
the photometric loss and its gradient with respect to the [N, 6] deltas for
the same pixel picks through the DVGO forward and the DCVGO one (random
grids of about 20^3, carried from JAX by ``convert``), where the gradient
reaches the deltas through the sample points, their interpolation weights
and the view directions; and a recovery of perturbed poses on a scene the
port trained, as ``tests/test_pose_tune.py`` does for the JAX package. The
program resolves its checkpoint as the JAX one does (``--ft_path``, a
reference ``.tar`` included; a merged block checkpoint is refused).

Tolerances: rotations to 1e-6 (scipy's to 1e-5), poses and rays to 1e-6;
the loss to 1e-5 relative; the delta gradient to 1e-3 of its largest
element plus 1e-2 relative (the forward's values agree to 1e-5, and the
gradient sums tens of thousands of such terms); the recovery must halve the
rotation and the translation errors.
"""

from __future__ import annotations

import dataclasses
import os
import shutil

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from unboundednerfpytorch_tpu.configs.schema import ExpConfig as JExpConfig
from unboundednerfpytorch_tpu.configs.schema import ModelRenderConfig as JModelRenderConfig
from unboundednerfpytorch_tpu.configs.schema import TrainStageConfig as JTrainStageConfig
from unboundednerfpytorch_tpu.data import synthetic as jsynthetic
from unboundednerfpytorch_tpu.models import dcvgo as jdcvgo
from unboundednerfpytorch_tpu.models import dvgo as jdvgo
from unboundednerfpytorch_tpu.train import loop as jloop
from unboundednerfpytorch_tpu.train import pose_tune as jpt
from unboundednerfpytorch_tpu_torch import convert
from unboundednerfpytorch_tpu_torch.configs.schema import (
    DataConfig, ExpConfig, ModelRenderConfig, TrainStageConfig,
)
from unboundednerfpytorch_tpu_torch.data import synthetic
from unboundednerfpytorch_tpu_torch.ops import rays
from unboundednerfpytorch_tpu_torch.train import loop
from unboundednerfpytorch_tpu_torch.train import pose_tune as pt
from torch_threads import torch_threads  # noqa: F401: the workers' share of the cores

XYZ_MIN, XYZ_MAX = (-1.0, -1.1, -0.9), (1.0, 1.0, 1.1)
NEAR, STEPSIZE = 0.2, 0.5
MODEL_KW = dict(num_voxels_density=20**3, num_voxels_rgb=20**3, num_voxels_base_density=20**3,
                num_voxels_base_rgb=20**3, rgbnet_dim=6, rgbnet_width=16, rgbnet_depth=2,
                alpha_init=1e-2, fast_color_thres=1e-4, maskout_near_cam_vox=False,
                stepsize=STEPSIZE, bg_len=0.2)


def t_(a):
    return torch.from_numpy(np.asarray(a))


def rotations(n, seed):
    from scipy.spatial.transform import Rotation

    return Rotation.random(n, random_state=seed).as_matrix().astype(np.float32)


def test_so3_exp_matches_jax_and_scipy():
    from scipy.spatial.transform import Rotation

    omega = (np.random.default_rng(0).standard_normal((8, 3)) * 0.7).astype(np.float32)
    omega[0] = 0.0
    omega[1] = 1e-7
    got = pt.so3_exp(t_(omega)).numpy()
    np.testing.assert_allclose(got, np.asarray(jpt.so3_exp(jnp.asarray(omega))), atol=1e-6)
    np.testing.assert_allclose(got, Rotation.from_rotvec(omega).as_matrix(), atol=1e-5)
    w = torch.zeros(3, requires_grad=True)
    pt.so3_exp(w).sum().backward()
    assert torch.isfinite(w.grad).all()


def test_apply_pose_delta_matches_jax():
    rng = np.random.default_rng(1)
    c2w = np.concatenate([rotations(5, 2), rng.standard_normal((5, 3, 1))], -1).astype(np.float32)
    delta = (rng.standard_normal((5, 6)) * 0.1).astype(np.float32)
    got = pt.apply_pose_delta(t_(c2w), t_(delta)).numpy()
    want = np.asarray(jpt.apply_pose_delta(jnp.asarray(c2w), jnp.asarray(delta)))
    np.testing.assert_allclose(got, want, atol=1e-6)
    np.testing.assert_allclose(pt.apply_pose_delta(t_(c2w), torch.zeros(5, 6)).numpy(), c2w,
                               atol=1e-6)


@pytest.mark.parametrize("inverse_y,flip_x,flip_y", [
    (False, False, False), (True, False, False), (True, True, True)])
def test_pixel_rays_match_jax_and_get_rays(inverse_y, flip_x, flip_y):
    H, W = 7, 9
    rng = np.random.default_rng(3)
    K = np.array([[11.0, 0, 4.3], [0, 12.0, 3.1], [0, 0, 1]], np.float32)
    c2w = np.concatenate([rotations(1, 4)[0], rng.standard_normal((3, 1))], -1).astype(np.float32)
    px, py = rng.integers(0, W, 20), rng.integers(0, H, 20)
    flags = dict(inverse_y=inverse_y, flip_x=flip_x, flip_y=flip_y)
    Kn, cn = np.repeat(K[None], 20, 0), np.repeat(c2w[None], 20, 0)
    got = pt.pixel_rays(t_(Kn), t_(cn), t_(px), t_(py), W, H, **flags)
    want = jpt.pixel_rays(jnp.asarray(Kn), jnp.asarray(cn), jnp.asarray(px), jnp.asarray(py),
                          W, H, **flags)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-6)
    ro, rd = rays.get_rays(H, W, t_(K), t_(c2w), **flags)
    np.testing.assert_allclose(got[1].numpy(), rd[py, px].numpy(), rtol=1e-6, atol=1e-6)


def make_pair(family, seed=0):
    """(JAX forward, port forward) of random grids of ``family``: the JAX
    params from its ``build_model``, carried into the port by ``convert``."""
    kw = dict(MODEL_KW)
    jexp = JExpConfig()
    texp = ExpConfig()
    if family == "dcvgo":
        jexp = dataclasses.replace(jexp, data=dataclasses.replace(jexp.data,
                                                                  unbounded_inward=True))
        texp = dataclasses.replace(texp, data=dataclasses.replace(texp.data,
                                                                  unbounded_inward=True))
    fam, jcfg, jp = jloop.build_model(jexp, JModelRenderConfig(**kw),
                                      JTrainStageConfig(pg_scale=()), np.array(XYZ_MIN),
                                      np.array(XYZ_MAX), jax.random.PRNGKey(seed))
    assert fam == family
    rng = np.random.default_rng(seed)
    dgrid = rng.standard_normal(jp.density.grid.shape) * 3.0 - 2.0
    kgrid = rng.standard_normal(jp.k0.grid.shape) * 0.5
    jp = jp.replace(density=jp.density.replace(grid=jnp.asarray(dgrid, jnp.float32)),
                    k0=jp.k0.replace(grid=jnp.asarray(kgrid, jnp.float32)))
    _, tcfg, _ = loop.build_model(texp, ModelRenderConfig(**kw), TrainStageConfig(pg_scale=()),
                                  XYZ_MIN, XYZ_MAX, torch.Generator().manual_seed(0), "cpu")
    tp = convert.params_from_numpy(family, convert.tree_from_params_object(jp), "cpu")
    tp.requires_grad_(False)
    tfwd_core = loop.make_forward(tcfg, {"near": NEAR, "bg": 1.0, "stepsize": STEPSIZE})
    if family == "dvgo":
        jfwd = lambda ro, rd, vd: jdvgo.forward(jp, jcfg, ro, rd, vd, near=NEAR,
                                                stepsize=STEPSIZE, bg=1.0)
    else:
        jfwd = lambda ro, rd, vd: jdcvgo.forward(jp, jcfg, ro, rd, vd, stepsize=STEPSIZE,
                                                 bg=1.0)
    return jfwd, lambda ro, rd, vd: tfwd_core(tp, ro, rd, vd, None)


def views(n=3, H=16, W=16, seed=5):
    """Cameras on a ring at 2.5 looking at the origin, seeded images, and
    the pixel picks of one step."""
    rng = np.random.default_rng(seed)
    poses = np.stack([synthetic.look_at_pose(2.5 * np.array([np.cos(a), np.sin(a), 0.4]),
                                             np.zeros(3))[:3] for a in np.linspace(0, 5, n)])
    K = np.array([[14.0, 0, W / 2], [0, 14.0, H / 2], [0, 0, 1]], np.float32)
    images = rng.random((n, H, W, 3)).astype(np.float32)
    picks = (rng.integers(0, n, 256), rng.integers(0, H, 256), rng.integers(0, W, 256))
    return images, poses.astype(np.float32), np.repeat(K[None], n, 0), picks


@pytest.mark.parametrize("family", ["dvgo", "dcvgo"])
def test_the_delta_gradient_matches_jax(family):
    jfwd, tfwd = make_pair(family, seed=6)
    images, poses, Ks, picks = views()
    delta = (np.random.default_rng(7).standard_normal((3, 6)) * 0.01).astype(np.float32)

    def j_loss(d):  # the JAX loss_fn's body, at given picks
        img, py, px = (jnp.asarray(a) for a in picks)
        c2w = jpt.apply_pose_delta(jnp.asarray(poses)[img], d[img])
        ro, rd, vd = jpt.pixel_rays(jnp.asarray(Ks)[img], c2w, px, py, 16, 16)
        gt = jnp.asarray(images)[img, py, px]
        return jnp.mean(jnp.square(jfwd(ro, rd, vd).rgb_marched - gt))

    want_loss, want = jax.value_and_grad(j_loss)(jnp.asarray(delta))
    d = t_(delta).requires_grad_(True)
    loss = pt.tune_loss(tfwd, d, t_(images), t_(poses), t_(Ks),
                        tuple(t_(a) for a in picks))
    loss.backward()
    assert float(loss.detach()) == pytest.approx(float(want_loss), rel=1e-5)
    got, want = d.grad.numpy(), np.asarray(want)
    assert np.abs(want).max() > 0 and np.abs(got[:, :3]).max() > 0
    err = np.abs(got - want)
    assert (err <= 1e-3 * np.abs(want).max() + 1e-2 * np.abs(want)).all(), float(err.max())


def test_training_rays_keep_the_sampling_out_of_autograd():
    """The forwards sample under no_grad unless the rays require a gradient:
    training rays never do, so the step's graph is what it was."""
    _, tfwd = make_pair("dvgo", seed=8)
    images, poses, Ks, picks = views()
    ro, rd, vd = pt.pixel_rays(t_(Ks[:1]).expand(4, 3, 3), t_(poses[:1]).expand(4, 3, 4),
                               torch.arange(4), torch.arange(4), 16, 16)
    assert not tfwd(ro, rd, vd).t.requires_grad
    assert tfwd(ro.requires_grad_(True), rd, vd).t.requires_grad


def _pose_errors(a, b):
    ang = [np.degrees(np.arccos(np.clip((np.trace(x[:3, :3].T @ y[:3, :3]) - 1) / 2, -1, 1)))
           for x, y in zip(a, b)]
    return float(np.mean(ang)), float(np.mean(np.linalg.norm(a[:, :3, 3] - b[:, :3, 3], axis=-1)))


def test_tune_recovers_perturbed_poses():
    """The JAX test's scene (its ``make_data_dict``: a sphere coloured by
    position on white, 6 views of 24x24) trained by the port on its true
    poses; the poses perturbed by the JAX test's 0.02 rad and 0.05 (about
    1.3 degrees and 0.09 on average); the tuner at the JAX test's lr halves
    both errors."""
    data = jsynthetic.make_data_dict(n_views=6, H=24, W=24)
    small = dict(num_voxels_rgb=24**3, num_voxels_density=24**3, num_voxels_base_rgb=24**3,
                 num_voxels_base_density=24**3, rgbnet_dim=6, rgbnet_width=24,
                 rgbnet_depth=2, alpha_init=1e-2, fast_color_thres=1e-4,
                 maskout_near_cam_vox=False)
    cfg = ExpConfig(data=DataConfig(white_bkgd=True),
                    coarse_train=dataclasses.replace(TrainStageConfig(), N_iters=0),
                    fine_train=TrainStageConfig(N_iters=250, N_rand=1024, pervoxel_lr=False,
                                                ray_sampler="flatten", pg_scale=(),
                                                skip_zero_grad_fields=("density", "k0")),
                    fine_model_and_render=ModelRenderConfig(**small))
    fam, mcfg, params, psnr = loop.run_train(cfg, data, device="cpu", log_fn=lambda _: None,
                                             log_every=250)
    assert fam == "dvgo" and psnr > 25
    params.requires_grad_(False)
    fwd = loop.make_forward(mcfg, {"near": float(data["near"]), "bg": 1.0, "stepsize": 0.5})
    i_train = data["i_train"]
    true = data["poses"][i_train][:, :3, :4].astype(np.float32)
    rng = np.random.RandomState(7)  # the JAX test's perturbation
    perturb = np.concatenate([rng.randn(6, 3) * 0.02, rng.randn(6, 3) * 0.05],
                             axis=1).astype(np.float32)
    start = pt.apply_pose_delta(t_(true), t_(perturb)).numpy()
    ang0, dist0 = _pose_errors(start, true)
    assert ang0 > 0.5 and dist0 > 0.02
    tuned, deltas, hist = pt.tune_poses(lambda ro, rd, vd: fwd(params, ro, rd, vd, None),
                                        data["images"][i_train], start, data["Ks"][i_train],
                                        steps=300, lr=3e-3, n_rand=1024, log_fn=lambda _: None,
                                        device="cpu")
    ang1, dist1 = _pose_errors(tuned, true)
    assert deltas.shape == (6, 6)
    assert ang1 < ang0 / 2 and dist1 < dist0 / 2, (ang0, ang1, dist0, dist1)
    assert hist["mse"][-1][1] < hist["mse"][0][1] / 2


def test_tune_poses_runs_on_the_card_unless_told_otherwise(monkeypatch):
    """``tune_poses`` with no device goes to ``cuda``, as the port's other
    entry points do: without a GPU it raises before it moves anything."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    images = np.zeros((1, 4, 4, 3), np.float32)
    poses = np.eye(4, dtype=np.float32)[None, :3]
    Ks = np.eye(3, dtype=np.float32)[None]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pt.tune_poses(lambda ro, rd, vd: None, images, poses, Ks, steps=1, log_fn=lambda _: None)


def test_cluster_scene_shows_its_spheres_on_white():
    """``synthetic.cluster_scene``: a pixel is white exactly where its ray
    passes every sphere by (the distance from each centre to the ray, found
    here apart from the scene's own intersection), every sphere shows in
    some view, and the poses look at the origin from the orbit."""
    from unboundednerfpytorch_tpu_torch.data import synthetic

    data = synthetic.cluster_scene(6, 24, 24, seed=3)
    assert data["images"].shape == (6, 24, 24, 3) and data["poses"].shape == (6, 4, 4)
    views = [rays.get_rays_of_a_view(24, 24, t_(data["Ks"][k]), t_(data["poses"][k, :3, :4]))
             for k in range(6)]
    ro = np.stack([v[0].numpy().reshape(-1, 3) for v in views]).astype(np.float64)
    rd = np.stack([v[1].numpy().reshape(-1, 3) for v in views]).astype(np.float64)
    rd = rd / np.linalg.norm(rd, axis=-1, keepdims=True)
    seen = np.zeros(len(synthetic.CLUSTER_SPHERES), bool)
    hit_any = np.zeros(rd.shape[:2], bool)
    for n, (centre, radius) in enumerate(synthetic.CLUSTER_SPHERES):
        oc = np.asarray(centre) - ro
        along = (oc * rd).sum(-1)
        gap = np.linalg.norm(oc - along[..., None] * rd, axis=-1)
        hit = (gap < radius) & (along > 0)
        seen[n] = hit.any()
        hit_any |= hit
    white = (data["images"].reshape(6, -1, 3) == 1.0).all(-1)
    assert seen.all()
    np.testing.assert_array_equal(white, ~hit_any)
    centres = data["poses"][:, :3, 3]
    np.testing.assert_allclose(np.linalg.norm(centres, axis=-1), 3.0, rtol=1e-6)
    np.testing.assert_allclose(-data["poses"][:, :3, 2], -centres / 3.0, atol=1e-6)


def test_the_recovery_perturbation_stays_in_its_ranges():
    """``probes.pose_recovery.perturb``: each view rotated by 1-3 degrees and
    its centre moved by 1-3 % of its distance, as drawn; ``pose_errors``
    reads them back."""
    from unboundednerfpytorch_tpu_torch.data import synthetic
    from unboundednerfpytorch_tpu_torch.probes import pose_recovery as pr

    true = synthetic.cluster_scene(8, 8, 8)["poses"][:, :3, :4].astype(np.float64)
    start = pr.perturb(true, np.random.default_rng(12))
    for k in range(len(true)):
        ang, dist = pr.pose_errors(start[k:k + 1], true[k:k + 1])
        assert 1.0 - 1e-6 <= ang <= 3.0 + 1e-6 and 0.03 - 1e-9 <= dist <= 0.09 + 1e-9
        np.testing.assert_allclose(start[k, :, :3].T @ start[k, :, :3], np.eye(3), atol=1e-6)
    assert pr.pose_errors(true, true) == (0.0, 0.0)


def test_tune_pose_resolves_its_checkpoint_as_the_jax_program(tmp_path, monkeypatch):
    """Fault C1, repaired: ``--ft_path`` wins; without it the merged block
    checkpoint is taken before ``fine_last``, as the JAX program does; a
    reference ``.tar`` tunes, the scene config's render knobs laid over it."""
    import types

    from unboundednerfpytorch_tpu_torch.utils import checkpoint as ckpt
    from unboundednerfpytorch_tpu_torch.utils import reference_import as ri

    _, mcfg, _ = loop.build_model(ExpConfig(), ModelRenderConfig(**MODEL_KW),
                                  TrainStageConfig(pg_scale=()), XYZ_MIN, XYZ_MAX,
                                  torch.Generator().manual_seed(0), "cpu")
    params = loop.FAMILIES["dvgo"].create(mcfg, torch.Generator().manual_seed(1))
    with torch.no_grad():
        params.density.grid.normal_(-1.0, 3.0, generator=torch.Generator().manual_seed(2))
    ckpt.save_model(str(tmp_path / "fine_last"), "dvgo", mcfg, params, global_step=4)
    ckpt.save_model(str(tmp_path / "fine_last_merged"), "dvgo", mcfg, params, global_step=4)
    loads = []
    real_load = ckpt.load_model
    monkeypatch.setattr(ckpt, "load_model", lambda path, **kw: loads.append(
        os.path.basename(path)) or real_load(path, **kw))
    images, poses, Ks, _ = views(n=2)
    data = {"i_train": np.arange(2), "images": images, "poses": poses, "Ks": Ks, "near": NEAR,
            "far": 6.0}
    cfg = ExpConfig(fine_model_and_render=ModelRenderConfig(stepsize=STEPSIZE),
                    fine_train=TrainStageConfig(N_rand=64))
    args = types.SimpleNamespace(tune_steps=1, tune_lr=1e-3)
    pt.run_tune_pose(args, cfg, data, str(tmp_path), device="cpu", log_fn=lambda _: None)
    shutil.rmtree(tmp_path / "fine_last_merged")
    pt.run_tune_pose(args, cfg, data, str(tmp_path), device="cpu", log_fn=lambda _: None)
    assert loads == ["fine_last_merged", "fine_last"]
    ri.export_checkpoint(str(tmp_path / "fine_last"), str(tmp_path / "run.tar"))
    for ft_path in (str(tmp_path / "run.tar"), str(tmp_path / "fine_last")):
        args.ft_path = ft_path
        out = pt.run_tune_pose(args, cfg, data, str(tmp_path), device="cpu",
                               log_fn=lambda _: None)
        tuned = np.load(out)
        assert tuned.shape == (2, 3, 4) and np.isfinite(tuned).all()
        assert 0 < np.abs(tuned - poses).max() < 0.01  # one step of lr 1e-3
    args.ft_path = str(tmp_path / "missing.tar")
    with pytest.raises(FileNotFoundError, match="missing.tar"):
        pt.run_tune_pose(args, cfg, data, str(tmp_path), device="cpu", log_fn=lambda _: None)
