"""The plain reference against the port, output by output, at tiny sizes on
the CPU: the occupancy cache, each family's training forward and its render
forward through the render cache, the losses, and a train step's gradients
and update."""

from __future__ import annotations

import pytest
import torch
from bench_tiny import ROOT, SEED, TINY

from benchmark.core import program, spec
from benchmark.inputs import capture as capture_mod
from benchmark.reference import model
from benchmark.reference.recipe import recipe
from benchmark.reference.train import Trainer, losses

CPU = torch.device("cpu")


def _both(cell: str):
    c = spec.load(ROOT, cell)
    cfgd = spec.merged(c.config, TINY["config"])
    step = program.start_step(cfgd, c.traffic)
    cap = program.capture(cfgd, SEED, CPU, images=False)
    _, family, mcfg, params, rk, data = program.build(cfgd, SEED, step, cap, CPU, c.family)
    R = recipe(cfgd, step, c.family)
    g = c.family.reference_model(R, cfgd, SEED, cap, CPU)
    return cfgd, cap, family, mcfg, params, rk, R, g


def _rays(cap, n=96):
    poses = capture_mod.orbit_view_poses(SEED, 2, CPU)
    pix = torch.randperm(cap.H * cap.W, generator=torch.Generator().manual_seed(0))[:n]
    return (t[pix] for t in capture_mod.view_rays(cap.H, cap.W, poses[0]))


@pytest.mark.parametrize("cell", ["bicycle_single.train", "bicycle_dcvgo.train"])
def test_the_inputs_the_box_and_the_occupancy_cache_agree(cell):
    _, _, _, mcfg, params, _, R, g = _both(cell)
    assert torch.equal(params.density.grid.detach(), g["density"])
    assert torch.equal(params.k0.grid.detach(), g["k0"])
    assert torch.equal(params.mask_cache.mask, g["mask"])
    assert 0 < float(g["mask"].float().mean()) < 1
    # the box from the same float operations as the port's: equal to the bit
    assert torch.equal(torch.tensor(mcfg.scene_center, dtype=torch.float32), g["center"])
    assert torch.equal(torch.tensor(mcfg.scene_radius, dtype=torch.float32), g["radius"])
    assert abs(params.act_shift - R.act_shift) < 1e-12
    assert mcfg.fast_color_thres == R.thres
    assert tuple(mcfg.world_size) == R.world_size


@pytest.mark.parametrize("cell", ["bicycle_single.train", "bicycle_dcvgo.train"])
def test_the_training_forward_and_losses_agree(cell):
    from unboundednerfpytorch_tpu_torch.train import loop

    _, cap, _, mcfg, params, rk, R, g = _both(cell)
    ro, rd, vd = _rays(cap)
    bg = torch.rand((ro.shape[0], 3), generator=torch.Generator().manual_seed(1))
    res = loop.make_forward(mcfg, rk)(params, ro, rd, vd, bg)
    out = model.forward(R, g, ro, rd, vd, bg)
    assert res.mask.any() and int(res.mask.sum()) == int(out["mask"].sum())
    for a, b in ((res.rgb_marched, out["rgb"]), (res.alphainv_last, out["alphainv_last"]),
                 (res.weights, out["weights"]), (res.depth, out["depth"])):
        assert torch.allclose(a, b, atol=2e-6, rtol=1e-5)
    assert res.n_max == out["n_max"]
    near = capture_mod.NEAR_CLIP / float(g["radius"][0])
    from unboundednerfpytorch_tpu_torch.ops import losses as L

    target = torch.rand_like(out["rgb"])
    ft = R.train
    port = (ft["weight_main"] * L.mse(res.rgb_marched, target)
            + ft["weight_entropy_last"] * L.entropy_last(res.alphainv_last)
            + ft["weight_distortion"] * L.distortion(res.weights, res.s, res.n_max, res.mask)
            + ft["weight_rgbper"] * L.rgbper(res.raw_rgb, target, res.weights, 96, res.mask))
    assert torch.allclose(port, losses(R, out, target, near), rtol=1e-5)


@pytest.mark.parametrize("cell", ["bicycle_single.render", "bicycle_dcvgo.render"])
def test_the_cached_render_forward_agrees(cell):
    from unboundednerfpytorch_tpu_torch.train import loop

    _, cap, family, mcfg, params, rk, R, g = _both(cell)
    params.requires_grad_(False)
    cache = loop.FAMILIES[family].build_render_cache(params, mcfg)
    assert cache is not None
    if R.bake_world_size is not None:
        assert tuple(cache.density_dims) == R.bake_world_size
    R.family.prepare_render(R, g)
    ro, rd, vd = _rays(cap)
    rk = {k: v for k, v in rk.items() if k != "rand_bkgd"}
    with torch.no_grad():
        res = loop.make_forward(mcfg, rk)(params, ro, rd, vd, None, cache=cache)
        out = model.forward(R, g, ro, rd, vd, R.render_bg(), render=True)
    for a, b in ((res.rgb_marched, out["rgb"]), (res.alphainv_last, out["alphainv_last"]),
                 (res.depth, out["depth"])):
        assert torch.allclose(a, b, atol=2e-6, rtol=1e-5)


def test_a_train_step_agrees_gradient_by_gradient():
    from unboundednerfpytorch_tpu_torch.train import loop
    from unboundednerfpytorch_tpu_torch.train.step import create_train_state, make_train_step

    cfgd, cap, family, mcfg, params, rk, R, g = _both("bicycle_single.train")
    from unboundednerfpytorch_tpu_torch.configs.schema import exp_config_from_dict

    ft = exp_config_from_dict(cfgd).fine_train
    state = create_train_state(params, ft, start_step=R.start_step - 1)
    near = capture_mod.NEAR_CLIP / float(mcfg.scene_radius[0])
    step = make_train_step(loop.make_forward(mcfg, rk), ft, world_size_max=float(max(mcfg.world_size)),
                           near_thres=near, lr_anchor=R.lr_anchor)
    ro, rd, vd = _rays(cap, 64)
    rgb = torch.rand((64, 3), generator=torch.Generator().manual_seed(2))
    bg = torch.rand((64, 3), generator=torch.Generator().manual_seed(3))
    m = step(state, {"rays_o": ro, "rays_d": rd, "viewdirs": vd, "rgb": rgb}, bg)
    params_ref = {"density": g["density"], "k0": g["k0"]}
    for i, (w, b) in enumerate(g["mlp"]):
        params_ref[f"mlp.{i}.weight"], params_ref[f"mlp.{i}.bias"] = w, b
    tr = Trainer(R, params_ref, g["mask"], g["center"], g["radius"],
                 capture_mod.NEAR_CLIP / float(g["radius"][0]))
    loss, grads = tr.step((ro, rd, vd), rgb, bg)
    assert torch.allclose(m["loss"], loss, rtol=1e-5)
    leaves = R.family.program_leaves(state.params)
    for k, p in leaves.items():
        m1 = state.optimizer.exp_avg[p] / (1 - state.optimizer.beta1)
        g = grads[k].float()
        # f32 sums over the samples in other orders; a grid's gradient is
        # stored in bfloat16, where the two sums may round to neighbours
        close = (m1 - g).abs() <= 1e-4 * g.abs() + 1e-5 * float(g.abs().max())
        assert close.float().mean() > 0.999, k
        assert abs(float(m1.norm()) - float(g.norm())) <= 1e-3 * float(g.norm()), k
        if p.dtype == torch.bfloat16:
            # the same update, equal to the bit but where a gradient's last
            # bits move a rounding to the grid's bfloat16
            assert (p.detach() == params_ref[k]).float().mean() > 0.999, k
        else:
            assert torch.allclose(p.detach(), params_ref[k], rtol=1e-5, atol=1e-7), k
