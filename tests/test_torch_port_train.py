"""The port's train step and trainer against the JAX package, and the
port's rules: no JAX import, no silent fall back to the CPU.

Three full train steps (forward, all five losses, backward, dense TV
injection, masked Adam with ``skip_zero_grad``, lr decay, ``rand_bkgd``)
run from identical parameters on identical batches in both packages; the
JAX side is ``make_train_step`` with its XLA TV expression, the port's is
the plain TV version (the CPU wrapper of the CUDA kernel). The random
backgrounds are the JAX draws, handed to the port.

Tolerance after three steps: 1e-4 relative / 2e-5 absolute on every
parameter. Adam divides by sqrt(v), so a gradient that differs in its last
bits moves a voxel by a few ulps of lr, not of the gradient.

Resume: on the CPU the port is deterministic, so a run cut after k steps,
saved with its optimizer state and resumed, must equal the uninterrupted run
to the bit, across a ``pg_scale`` boundary and across the deferred-budget
switch, ``rand_bkgd`` on. A JAX optimizer state carried into the port and
back is equal, and one step from it matches the JAX step within the
tolerance above.
"""

import ast
import dataclasses
import json
import math
import pathlib
import shutil

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from unboundednerfpytorch_tpu.configs.schema import TrainStageConfig as JTrainStageConfig
from unboundednerfpytorch_tpu.models import fourier_grid as jfg
from unboundednerfpytorch_tpu.train import step as jstep
from unboundednerfpytorch_tpu.utils import checkpoint as jckpt
from unboundednerfpytorch_tpu_torch import convert, resolve_device
from unboundednerfpytorch_tpu_torch.configs import loader
from unboundednerfpytorch_tpu_torch.configs.schema import TrainStageConfig
from unboundednerfpytorch_tpu_torch.data import synthetic
from unboundednerfpytorch_tpu_torch.models import fourier_grid as fg
from unboundednerfpytorch_tpu_torch.ops.cuda import build
from unboundednerfpytorch_tpu_torch.train import loop
from unboundednerfpytorch_tpu_torch.train import step as tstep
from unboundednerfpytorch_tpu_torch.utils import checkpoint as ckpt
from test_torch_port_model import jax_params_to_numpy, make_pair, make_rays
from torch_threads import torch_threads  # noqa: F401: the workers' share of the cores

ROOT = pathlib.Path(__file__).resolve().parents[1]
TRAIN_KW = dict(
    N_rand=48, lrate_density=0.1, lrate_k0=0.1, lrate_rgbnet=1e-3, lrate_decay=20,
    weight_main=1.0, weight_entropy_last=0.01, weight_nearclip=1.0, weight_distortion=0.01,
    weight_rgbper=0.1, tv_before=1000, tv_dense_before=1000, weight_tv_density=1e-2,
    weight_tv_k0=1e-3, skip_zero_grad_fields=("density", "k0"), pg_scale=())


def test_three_train_steps_match_jax():
    jcfg, jp, tcfg, tp = make_pair(seed=7)
    near_thres = 0.3
    ws_max = float(max(jcfg.world_size))
    jtrain = JTrainStageConfig(**TRAIN_KW)
    ttrain = TrainStageConfig(**TRAIN_KW)

    def jfwd(params, ro, rd, vd, key, img_index=None):
        return jfg.forward(params, jcfg, ro, rd, vd, rand_bkgd_key=key)

    j_step = jax.jit(jstep.make_train_step(jfwd, jtrain, world_size_max=ws_max,
                                           near_thres=near_thres, lr_anchor=1))
    j_state = jstep.create_train_state(jp, jtrain)
    t_step = tstep.make_train_step(
        lambda p, ro, rd, vd, bg: fg.forward(p, tcfg, ro, rd, vd, bg_color=bg), ttrain,
        world_size_max=float(max(tcfg.world_size)), near_thres=near_thres, lr_anchor=1)
    t_state = tstep.create_train_state(tp, ttrain)

    rng = np.random.default_rng(11)
    for s in range(3):
        o, d, vd = make_rays(n=TRAIN_KW["N_rand"], seed=20 + s)
        rgb = rng.random((o.shape[0], 3)).astype(np.float32)
        key = jax.random.PRNGKey(100 + s)
        batch = dict(rays_o=o, rays_d=d, viewdirs=vd, rgb=rgb)
        j_state, j_m = j_step(j_state, {k: jnp.asarray(v) for k, v in batch.items()}, key)
        bg = torch.from_numpy(np.array(jax.random.uniform(key, (o.shape[0], 3))))
        t_m = t_step(t_state, {k: torch.from_numpy(v) for k, v in batch.items()}, bg)
        for name in ("loss", "mse", "psnr", "loss_entropy", "loss_nearclip", "loss_distortion",
                     "loss_rgbper", "lr_scale"):
            assert float(t_m[name]) == pytest.approx(float(j_m[name]), rel=1e-4, abs=1e-6), name
    assert float(j_m["loss_rgbper"]) > 0 and float(j_m["loss_distortion"]) > 0

    jparams = j_state.params
    pairs = [(t_state.params.density.grid, jparams.density.grid),
             (t_state.params.k0.grid, jparams.k0.grid)]
    pairs += [(lin.weight.T, w) for lin, w in zip(t_state.params.rgbnet.layers,
                                                   jparams.rgbnet.weights)]
    pairs += [(lin.bias, b) for lin, b in zip(t_state.params.rgbnet.layers, jparams.rgbnet.biases)]
    for got, want in pairs:
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-4, atol=2e-5)
    # dense TV moved every voxel of both grids, hit or not
    assert not np.any(np.asarray(jparams.k0.grid) == np.asarray(jp.k0.grid))
    assert t_state.step == 3 == int(j_state.step)


def _tiny_bicycle(n_iters=6):
    """configs/nerf_unbounded/bicycle_single.py, cut to 24^3 voxels and a
    16-sample budget, its fine stage run from the final grid (pg_scale=())."""
    cfg = loader.load_config(str(ROOT / "configs" / "nerf_unbounded" / "bicycle_single.py"))
    vox = 24**3
    fm = dataclasses.replace(cfg.fine_model_and_render, num_voxels_density=vox,
                             num_voxels_rgb=vox, num_voxels_base_density=vox,
                             num_voxels_base_rgb=vox, sample_budget=16)
    ft = dataclasses.replace(cfg.fine_train, pg_scale=(), N_iters=n_iters, N_rand=256)
    return dataclasses.replace(cfg, fine_model_and_render=fm, fine_train=ft)


def test_run_train_on_cpu():
    cfg = _tiny_bicycle()
    data = synthetic.orbit_scene(4, 16, 24, seed=0)
    xyz_min, xyz_max = loop.bbox_mod.compute_bbox_by_cam_frustrm(cfg, data, "FourierGrid",
                                                                 device="cpu")
    seed_fn = synthetic.occupancy_seed((xyz_min + xyz_max) / 2, (xyz_max - xyz_min) / 2)
    build.reset_launch_counts()
    seen = []
    family, mcfg, params, psnr = loop.run_train(
        cfg, data, seed=0, device="cpu", log_fn=lambda _: None,
        callback=lambda step, m: seen.append((step, float(m["loss"]))), coarse_mask_fn=seed_fn)
    assert family == "FourierGrid"
    assert [s for s, _ in seen] == list(range(1, 7))
    assert all(math.isfinite(v) for _, v in seen) and math.isfinite(psnr)
    assert params.k0.grid.dtype == torch.bfloat16 and params.k0.grid.shape[0] == 7
    assert mcfg.sample_budget == 16 and 2 * mcfg.n_inner > 16
    assert 0 < float(params.mask_cache.mask.float().mean()) < 1
    assert not build.LAUNCHES  # the CPU path runs the plain versions only


def test_entry_points_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        loop.run_train(_tiny_bicycle(1), synthetic.orbit_scene(2, 8, 8))


def test_wrappers_never_send_a_device_tensor_to_the_plain_version():
    """Only a CPU tensor takes the plain path; any other device goes to the
    kernel's launcher, which refuses what is not on the GPU."""
    from unboundednerfpytorch_tpu_torch.ops.cuda import march, tv

    p = torch.zeros((1, 3, 3, 3, 1), device="meta")
    with pytest.raises(ValueError, match="GPU"):
        tv.tv_add_grad(p, p, 0.1, 0.1, 0.1, 1.0, True)
    d = torch.zeros((4, 5), device="meta")
    with pytest.raises(ValueError, match="GPU"):
        march.fused_alpha2weights(d, d.bool(), 0.0, 0.5)
    assert not build.LAUNCHES


def _imported_modules(path: pathlib.Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_nothing_of_jax():
    files = sorted((ROOT / "unboundednerfpytorch_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    names = {str(f.relative_to(ROOT)) for f in files}
    assert {f"unboundednerfpytorch_tpu_torch/{m}.py" for m in (
        "__main__", "cli/main", "data/common", "data/llff", "data/loaders", "data/png",
        "utils/checkpoint", "models/dcvgo", "models/dmpigo", "ops/cuda/ub360",
        "probes/adam_memory", "data/colmap", "data/cameras", "utils/reference_import",
        "utils/observability", "render/arf", "tools/serve")} <= names
    bad = []
    for f in files:
        for mod in _imported_modules(f):
            top = mod.split(".")[0]
            if top in ("jax", "jaxlib", "flax", "optax", "unboundednerfpytorch_tpu"):
                bad.append(f"{f.relative_to(ROOT)}: {mod}")
    assert not bad, bad


# ---------------------------------------------------------------------------
# resume, periodic saves and the optimizer's state


def _tiny_resume_config(n_iters=7):
    """bicycle_single cut to 24^3 voxels, a 16-sample budget and boundaries
    at steps 3 and 5; ``rand_bkgd`` on, as the config has it."""
    cfg = loader.load_config(str(ROOT / "configs" / "nerf_unbounded" / "bicycle_single.py"))
    vox = 24**3
    fm = dataclasses.replace(cfg.fine_model_and_render, num_voxels_density=vox,
                             num_voxels_rgb=vox, num_voxels_base_density=vox,
                             num_voxels_base_rgb=vox, sample_budget=16, color_budget=6)
    ft = dataclasses.replace(cfg.fine_train, pg_scale=(3, 5), N_iters=n_iters, N_rand=256)
    assert cfg.data.rand_bkgd
    return dataclasses.replace(cfg, fine_model_and_render=fm, fine_train=ft)


RESUME_DATA = synthetic.orbit_scene(4, 12, 16, seed=0)


def _step_record(step, metrics):
    """(step, loss, the boundary's record but its seconds, or None)."""
    rec = metrics.get("pg_scale")
    return step, float(metrics["loss"]), rec and {k: v for k, v in rec.items() if k != "seconds"}


def _train(exp_dir, n_iters=7, **kw):
    """run_train on the CPU; returns (its output, [_step_record of each
    step], the log lines)."""
    seen, said = [], []
    out = loop.run_train(
        _tiny_resume_config(n_iters), RESUME_DATA, seed=0, device="cpu", log_fn=said.append,
        log_every=1, exp_dir=str(exp_dir), callback=lambda s, m: seen.append(_step_record(s, m)),
        **kw)
    return out, seen, said


def _assert_same_model(a, b):
    (_, cfg_a, pa, _), (_, cfg_b, pb, _) = a, b
    assert cfg_a == cfg_b and pa.act_shift == pb.act_shift
    for (na, ta), (nb, tb) in zip(sorted(pa.state_dict().items()), sorted(pb.state_dict().items())):
        assert na == nb and ta.dtype == tb.dtype and torch.equal(ta, tb), na


def _assert_same_opt_state(path_a, path_b):
    *_, step_a, oa = ckpt.load_model(str(path_a))
    *_, step_b, ob = ckpt.load_model(str(path_b))
    assert step_a == step_b and oa["step"] == ob["step"] > 0
    for key in ("exp_avg", "exp_avg_sq"):
        for name in oa[key]:
            for x, y in zip(oa[key][name], ob[key][name]):
                np.testing.assert_array_equal(x, y)


@pytest.fixture(scope="module")
def uninterrupted(tmp_path_factory):
    """Seven steps in one run, saving every two steps; each periodic
    checkpoint is copied away when the step's callback sees it."""
    exp_dir = tmp_path_factory.mktemp("whole")
    snaps = {}

    def snap(step, _):
        if step % 2 == 0 and step < 7:
            snaps[step] = exp_dir / f"snap_{step}"
            shutil.copytree(exp_dir / "fine_last", snaps[step])

    seen, said = [], []
    out = loop.run_train(
        _tiny_resume_config(), RESUME_DATA, seed=0, device="cpu", log_fn=said.append,
        log_every=1, exp_dir=str(exp_dir), save_every=2,
        callback=lambda s, m: (seen.append(_step_record(s, m)), snap(s, m)))
    return exp_dir, out, seen, snaps


@pytest.mark.parametrize("cut", [4, 2], ids=["after_a_boundary", "before_the_first_boundary"])
def test_resumed_run_is_bit_equal_to_the_uninterrupted_one(tmp_path, uninterrupted, cut):
    """A run of ``cut`` steps, then the same run to 7 in the same directory:
    the implicit resume. Boundaries at 3 and 5: cut at 4 the second falls in
    the resumed part, cut at 2 both, and the sample budget, deferred until
    the first boundary, must be deferred again on resume."""
    whole_dir, whole, whole_seen, _ = uninterrupted
    _, first, _ = _train(tmp_path, n_iters=cut)
    meta = json.load(open(tmp_path / "fine_last" / "meta.json"))
    assert meta["global_step"] == cut and meta["has_opt_state"]
    assert meta["model_kwargs"]["sample_budget"] == 16  # the true budget, never the deferral's 0
    rest, rest_seen, said = _train(tmp_path)
    assert f"fine: resumed from {tmp_path / 'fine_last'} at step {cut}" in said[0]
    assert "with the optimizer's state" in said[0]
    assert [s for s, *_ in first + rest_seen] == list(range(1, 8))
    assert first + rest_seen == whole_seen  # losses and boundary records, to the bit
    budgets = {s: (r["sample_budget_before"], r["sample_budget"]) for s, _, r in rest_seen if r}
    assert budgets == ({5: (16, 16)} if cut == 4 else {3: (0, 16), 5: (16, 16)})
    _assert_same_model(rest, whole)
    _assert_same_opt_state(tmp_path / "fine_last", whole_dir / "fine_last")


def test_periodic_saves_and_the_resume_options(tmp_path, uninterrupted):
    whole_dir, whole, whole_seen, snaps = uninterrupted
    assert sorted(snaps) == [2, 4, 6]
    for step, path in snaps.items():
        meta = json.load(open(path / "meta.json"))
        assert (meta["global_step"], meta["has_opt_state"]) == (step, True)
        assert sorted(p.name for p in path.iterdir()) == ["meta.json", f"opt_state-{step}.npz",
                                                          f"params-{step}.npz"]
    # the metrics series: every scalar of every logged step, and the boundaries
    records = [json.loads(line) for line in open(whole_dir / "fine_metrics.jsonl")]
    assert [r["step"] for r in records if "loss" in r] == list(range(1, 8))
    assert {"elapsed_s", "loss", "mse", "psnr", "lr_scale", "loss_distortion"} <= set(records[0])
    assert [r["step"] for r in records if "pg_scale" in r] == [3, 5]
    # --ft_path: resume from another checkpoint than <exp_dir>/fine_last
    out, seen, said = _train(tmp_path / "ft", ft_path=str(snaps[4]))
    assert said[0].startswith(f"fine: resumed from {snaps[4]} at step 4")
    assert seen == whole_seen[4:]
    _assert_same_model(out, whole)
    # --no_reload: a fresh start, whatever <exp_dir> holds
    _, seen, said = _train(tmp_path / "ft", n_iters=2, no_reload=True)
    assert seen == whole_seen[:2] and not any("resumed" in line for line in said)
    # --no_reload_optimizer: the model resumes (step 7's loss is the same),
    # Adam starts over (its update is not)
    out, seen, said = _train(tmp_path / "fresh_adam", ft_path=str(snaps[6]),
                             no_reload_optimizer=True)
    assert "without the optimizer's state" in said[0] and seen == whole_seen[6:]
    assert not torch.equal(out[2].k0.grid, whole[2].k0.grid)
    # a run already at its last step trains nothing and saves nothing
    stamp = (whole_dir / "fine_last" / "params-7.npz").stat().st_mtime_ns
    _, seen, said = _train(whole_dir)
    assert seen == [] and (whole_dir / "fine_last" / "params-7.npz").stat().st_mtime_ns == stamp
    assert sorted(p.name for p in (whole_dir / "fine_last").iterdir()) == [
        "meta.json", "opt_state-7.npz", "params-7.npz"]


def test_sampler_fast_forward_stands_where_the_run_stands():
    """Reshuffles and background draws share one generator: replaying n
    batches leaves it where n steps leave it, through an epoch's end."""
    gen = lambda: torch.Generator().manual_seed(3)
    a = tstep.FlattenSampler(50, 16, gen(), torch.device("cpu"), rand_bkgd=True)
    draws = [a.next_batch() for _ in range(7)]
    b = tstep.FlattenSampler(50, 16, gen(), torch.device("cpu"), rand_bkgd=True)
    b.fast_forward(4)
    for idx, bg in draws[4:]:
        idx2, bg2 = b.next_batch()
        assert torch.equal(idx, idx2) and torch.equal(bg, bg2)
    assert tstep.FlattenSampler(50, 16, gen(), torch.device("cpu")).next_batch()[1] is None


def test_jax_optimizer_state_carries_into_the_port_and_back(tmp_path):
    """Two JAX steps, the JAX checkpoint with its ``opt_state.msgpack``, its
    state carried into the port, back to the JAX layout and through the
    port's checkpoint: equal throughout; then one step from the carried state
    in each package."""
    jcfg, jp, tcfg, _ = make_pair(seed=9)
    jtrain, ttrain = JTrainStageConfig(**TRAIN_KW), TrainStageConfig(**TRAIN_KW)
    near_thres, ws_max = 0.3, float(max(jcfg.world_size))

    def jfwd(params, ro, rd, vd, key, img_index=None):
        return jfg.forward(params, jcfg, ro, rd, vd, rand_bkgd_key=key)

    j_step = jax.jit(jstep.make_train_step(jfwd, jtrain, world_size_max=ws_max,
                                           near_thres=near_thres, lr_anchor=1))
    j_state = jstep.create_train_state(jp, jtrain)
    rng = np.random.default_rng(4)

    def batch(s):
        o, d, vd = make_rays(n=TRAIN_KW["N_rand"], seed=40 + s)
        return dict(rays_o=o, rays_d=d, viewdirs=vd,
                    rgb=rng.random((o.shape[0], 3)).astype(np.float32))

    for s in range(2):
        j_state, _ = j_step(j_state, {k: jnp.asarray(v) for k, v in batch(s).items()},
                            jax.random.PRNGKey(s))
    jpath = str(tmp_path / "jax_last")
    jckpt.save_model(jpath, "FourierGrid", jcfg, j_state.params, global_step=2,
                     opt_state=j_state.opt_state)
    _, _, jp2, step, opt_bytes = jckpt.load_model(jpath)
    restored = jckpt.restore_opt_state(opt_bytes, jstep.create_train_state(jp2, jtrain).opt_state)
    tree = convert.opt_state_tree_from_object(restored)
    assert int(tree["step"]) == 2 and float(np.abs(tree["exp_avg"]["k0"]["grid"]).max()) > 0

    tp = convert.fourier_grid_params_from_numpy(jax_params_to_numpy(jp2), "cpu")
    t_state = tstep.create_train_state(tp, ttrain, start_step=step,
                                       opt_state=convert.opt_state_from_numpy(tree))
    assert t_state.optimizer.step_count == 2

    def assert_same_tree(got, want):
        flat_g, flat_w = ckpt._flatten(got), ckpt._flatten(want)
        assert sorted(flat_g) == sorted(flat_w) and len(flat_g) == 1 + 2 * (2 + 2 * 3)
        for k in flat_w:
            assert flat_g[k].dtype == flat_w[k].dtype and flat_g[k].shape == flat_w[k].shape, k
            np.testing.assert_array_equal(flat_g[k], flat_w[k], err_msg=k)

    back = convert.opt_state_to_numpy(t_state.optimizer.state_dict())
    assert_same_tree(back, tree)
    # and as the JAX package's own state again
    j_back = restored._replace(
        step=jnp.asarray(back["step"]),
        exp_avg={n: jax.tree.map(lambda _, v: jnp.asarray(v), restored.exp_avg[n],
                                 _as_jax_subtree(restored.exp_avg[n], back["exp_avg"][n]))
                 for n in restored.exp_avg},
        exp_avg_sq={n: jax.tree.map(lambda _, v: jnp.asarray(v), restored.exp_avg_sq[n],
                                    _as_jax_subtree(restored.exp_avg_sq[n],
                                                    back["exp_avg_sq"][n]))
                    for n in restored.exp_avg_sq})
    for a, b in zip(jax.tree.leaves(j_back), jax.tree.leaves(restored)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    # through the port's checkpoint
    tpath = str(tmp_path / "fine_last")
    ckpt.save_model(tpath, "FourierGrid", tcfg, tp, global_step=step,
                    opt_state=t_state.optimizer.state_dict())
    *_, opt_loaded = ckpt.load_model(tpath)
    assert_same_tree(convert.opt_state_to_numpy(
        {k: v if k == "step" else {n: [torch.from_numpy(a) for a in ms] for n, ms in v.items()}
         for k, v in opt_loaded.items()}), tree)

    # one step from the carried state in each package
    j_state = jstep.TrainState(params=jp2, opt_state=restored, step=jnp.asarray(2, jnp.int32))
    t_step = tstep.make_train_step(
        lambda p, ro, rd, vd, bg: fg.forward(p, tcfg, ro, rd, vd, bg_color=bg), ttrain,
        world_size_max=ws_max, near_thres=near_thres, lr_anchor=1)
    b, key = batch(2), jax.random.PRNGKey(7)
    j_state, j_m = j_step(j_state, {k: jnp.asarray(v) for k, v in b.items()}, key)
    bg = torch.from_numpy(np.array(jax.random.uniform(key, (b["rgb"].shape[0], 3))))
    t_m = t_step(t_state, {k: torch.from_numpy(v) for k, v in b.items()}, bg)
    lr_scale = float(t_m["lr_scale"])
    assert lr_scale == pytest.approx(float(j_m["lr_scale"])) and lr_scale < 1.0
    assert float(t_m["loss"]) == pytest.approx(float(j_m["loss"]), rel=1e-4, abs=1e-6)
    pairs = [(t_state.params.density.grid, j_state.params.density.grid),
             (t_state.params.k0.grid, j_state.params.k0.grid)]
    pairs += [(lin.weight.T, w) for lin, w in zip(t_state.params.rgbnet.layers,
                                                   j_state.params.rgbnet.weights)]
    for got, want in pairs:
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-4, atol=2e-5)
    assert t_state.optimizer.step_count == 3 == int(j_state.opt_state.step)


def _as_jax_subtree(template, sub: dict):
    """The JAX-layout numpy ``sub`` as a pytree shaped like ``template`` (a
    JAX FourierGrid or MLP)."""
    if "grid" in sub:
        return template.replace(grid=sub["grid"])
    return template.replace(weights=tuple(sub["weights"]), biases=tuple(sub["biases"]))
