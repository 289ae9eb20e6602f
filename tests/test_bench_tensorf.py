"""The benchmark's TensoRF cell (``ship_tensorf.train``) on the CPU at a
small size: a box of about 20^3 voxels, ``n_comp`` 2 (density) and 3 (k0),
k0 of 6 channels, 64 rays, the benchmark's seeded weights.

The port's DVGO forward over TensoRF fields, its losses, every leaf's
gradient and one masked Adam step against the plain reference
(``benchmark/reference/tensorf.py``); the box, lattice, weights and
occupancy cache that both build; the VM lookup's bytes and flops against a
shape worked by hand, and its counter; the ``field/vm`` and ``backward/vm``
spans (and none without a profiler) and the VM query's autograd node equal
to the bit to the plain graph; the cell's run, its faults and its control;
and that the reference and the family load no JAX and nothing of the port.
"""

from __future__ import annotations

import copy
import json
import pathlib
import subprocess
import sys

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

ROOT = pathlib.Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark.core import check, program, spec  # noqa: E402
from benchmark.core.spies import Spies  # noqa: E402
from benchmark.counts import vm  # noqa: E402
from benchmark.inputs import bounded  # noqa: E402
from benchmark.inputs.capture import training_rays  # noqa: E402
from benchmark.reference import tensorf as T  # noqa: E402
from benchmark.reference.train import losses  # noqa: E402
from unboundednerfpytorch_tpu_torch.fields import grids  # noqa: E402
from unboundednerfpytorch_tpu_torch.ops import losses as L  # noqa: E402
from unboundednerfpytorch_tpu_torch.train import loop  # noqa: E402
from unboundednerfpytorch_tpu_torch.train.step import (  # noqa: E402
    create_train_state, make_train_step,
)
from unboundednerfpytorch_tpu_torch.utils import profiling  # noqa: E402

CELL = "ship_tensorf.train"
CPU = torch.device("cpu")
SEED = 2**31 + 12345  # past 32 signed bits, as a run may be given
SMALL = {
    "config": {
        "fine_model_and_render": {
            **{k: 20**3 for k in ("num_voxels_rgb", "num_voxels_density", "num_voxels_base_rgb",
                                  "num_voxels_base_density")},
            "rgbnet_dim": 6, "rgbnet_width": 16,
            "density_config": [["n_comp", 2]], "k0_config": [["n_comp", 3]]},
        "coarse_model_and_render": {k: 24**3 for k in (
            "num_voxels_rgb", "num_voxels_density", "num_voxels_base_rgb",
            "num_voxels_base_density")},
        "capture": {"n_views": 6, "H": 24, "W": 32},
        "fine_train": {"N_rand": 64},
    },
    "traffic": {"trace_seconds": 0.3},
}
N_RAYS = 64


@pytest.fixture(scope="module")
def both():
    """(cfg dict, capture, the program's (cfg, family, mcfg, params, rk),
    the reference's recipe and model) at the window's step."""
    torch.set_num_threads(2)
    cell = spec.load(ROOT, CELL)
    cfgd = spec.merged(cell.config, SMALL["config"])
    step = program.start_step(cfgd, cell.traffic)
    cap = bounded.capture(cfgd, SEED, CPU, images=False)
    cfg, name, mcfg, params, rk, _ = cell.kind.build(cfgd, SEED, step, cap, CPU, cell.family)
    R, model = T.recipe_and_model(cfgd, step, cap, SEED, CPU)
    return cfgd, cap, (cfg, name, mcfg, params, rk), R, model, cell


def _rays(cap, R, model, n=N_RAYS):
    """``n`` training rays that meet the occupancy cache, and their colours."""
    idx = torch.arange(cap.poses.shape[0] * cap.H * cap.W)
    ro, rd, vd, rgb = training_rays(cap, idx)
    with torch.no_grad():
        pts, live = T.sample(R, ro, rd)
        hit = (live & T.mask_lookup(R, model["mask"], pts)).any(-1)
    pick = hit.nonzero()[:, 0]
    pick = pick[torch.randperm(len(pick), generator=torch.Generator().manual_seed(0))[:n]]
    assert len(pick) == n
    return ro[pick], rd[pick], vd[pick], rgb[pick]


def test_the_box_lattice_weights_and_occupancy_cache_agree(both):
    _, _, (_, name, mcfg, params, _), R, model, cell = both
    assert name == "dvgo"
    # the port's frustum and coarse-geometry boxes, worked out plainly: equal to the bit
    assert mcfg.xyz_min == R.xyz_min and mcfg.xyz_max == R.xyz_max
    assert tuple(mcfg.world_size) == R.world_size
    assert mcfg.voxel_size == R.voxel_size and mcfg.voxel_size_ratio == R.voxel_size_ratio
    assert params.act_shift == R.act_shift and mcfg.fast_color_thres == R.thres
    leaves = cell.family.program_leaves(params)
    assert set(leaves) == set(model["leaves"])
    assert len([k for k in leaves if not k.startswith("mlp.")]) == 13
    for k, p in leaves.items():
        assert torch.equal(p.detach(), model["leaves"][k]), k
    # the fine density's alpha is taken through other lookups (grid_sample
    # against the port's gather) but no voxel lies within rounding of the
    # threshold here
    assert torch.equal(params.mask_cache.mask, model["mask"])
    assert 0.05 < float(model["mask"].float().mean()) < 0.95


def test_the_forward_and_losses_agree(both):
    _, cap, (_, _, mcfg, params, rk), R, model, cell = both
    ro, rd, vd, target = _rays(cap, R, model)
    res = loop.make_forward(mcfg, rk)(params, ro, rd, vd)
    out = cell.family.forward(R, model["leaves"], model["mask"], ro, rd, vd)
    # the same samples survive both thresholds
    assert res.mask.any() and torch.equal(res.mask, out["mask"])
    # f32 throughout; the lookups' sums run in other orders (the port's
    # corner gather against grid_sample's), which the scan carries along
    # the ray: a few units in the last place of each output
    for a, b in ((res.rgb_marched, out["rgb"]), (res.alphainv_last, out["alphainv_last"]),
                 (res.weights, out["weights"])):
        assert torch.allclose(a, b, atol=2e-6, rtol=1e-5)
    # the forward colours the kept samples alone, in order (compacted)
    keep = out["mask"]
    assert torch.allclose(res.raw_rgb, out["raw_rgb"][keep], atol=1e-6, rtol=1e-5)
    ft = R.train
    port = (ft["weight_main"] * L.mse(res.rgb_marched, target)
            + ft["weight_entropy_last"] * L.entropy_last(res.alphainv_last)
            + ft["weight_rgbper"] * L.rgbper(res.raw_rgb, target, res.weights, N_RAYS, res.mask))
    assert torch.allclose(port, losses(R, out, target, 0.0), rtol=1e-5)


def test_a_train_step_agrees_leaf_by_leaf(both):
    cfgd, cap, (cfg, _, mcfg, params, rk), R, model, cell = both
    ro, rd, vd, rgb = _rays(cap, R, model)
    params = copy.deepcopy(params)
    ft = cfg.fine_train
    state = create_train_state(params, ft, start_step=R.start_step - 1)
    step = make_train_step(loop.make_forward(mcfg, rk), ft,
                           world_size_max=float(max(mcfg.world_size)), lr_anchor=R.lr_anchor)
    m = step(state, {"rays_o": ro, "rays_d": rd, "viewdirs": vd, "rgb": rgb})
    ref = {k: v.clone() for k, v in model["leaves"].items()}
    loss, grads = T.Trainer(R, ref, model["mask"]).step((ro, rd, vd), rgb)
    assert torch.allclose(m["loss"], loss, rtol=1e-5)
    opt = state.optimizer
    for k, p in cell.family.program_leaves(state.params).items():
        g = grads[k]
        m1 = opt.exp_avg[p] / (1 - opt.beta1)
        # f32 sums over the samples in other orders (the port's index_add_
        # against grid_sample's backward): a gradient agrees to rounding;
        # the skip of masked Adam agrees element by element
        assert torch.equal(m1 != 0, g != 0), k
        tol = 1e-6 * float(g.abs().max())
        assert torch.allclose(m1, g, rtol=1e-4, atol=tol), k
        # the first update is lr m / (sqrt(v) + eps) with m = 0.1 g and
        # sqrt(v) = 0.1 |g|: where |g| is near eps it is lr g / eps times a
        # tenth, so a gap of ``tol`` in g moves it by up to lr 0.1 tol / eps;
        # elsewhere p moves by lr whatever g's rounding (p's own rounding)
        lr = ft.lrate_rgbnet if k.startswith("mlp.") else getattr(ft, "lrate_" + k.split(".")[0])
        gap = (p.detach() - ref[k]).abs()
        assert float(gap.max()) <= lr * 0.1 * tol / opt.eps + 1e-7, k


def test_the_vm_lookup_counts_against_a_shape_worked_by_hand():
    # k0: R = 2 components a plane, 6 channels: a point reads 3 planes x 4
    # corners x 2 + 3 lines x 2 corners x 2 = 36 values and writes 3 x 2
    # features (42 f32: 168 B); flops: 36 corners x 2 + 6 products + 2 x 6 x 6
    # for the projection = 150
    assert vm.lookup_work(10, (2, 2, 2), 6, 4) == (1680, 1500)
    # density: one channel, the 6 products summed (6 flops)
    assert vm.lookup_work(10, (2, 2, 2), 1, 4) == (1680, 840)
    # a step: 3 x (n_density x 84 + n_colour x (150 + the MLP's 2 x (39x16 +
    # 16x16 + 16x3) = 1856))
    dims = ((39, 16), (16, 16), (16, 3))
    assert vm.step_flops(100, 10, 2, 2, 6, dims) == 3 * (100 * 84 + 10 * (150 + 1856))


def test_the_counter_counts_each_query(both):
    _, cap, (_, _, mcfg, params, rk), R, model, _ = both
    ro, rd, vd, _ = _rays(cap, R, model, 16)
    spies = Spies(ROOT, {"colour_budget": 0})
    with spies.installed(), torch.no_grad():
        res = loop.make_forward(mcfg, rk)(params, ro, rd, vd)
    # the port queries the density at every sample slot, k0 at the samples
    # over both thresholds alone
    n, kept = 16 * R.n_samples, int(res.mask.sum())
    assert 0 < kept < n
    want = [vm.lookup_work(n, (2,) * 3, 1, 4), vm.lookup_work(kept, (3,) * 3, 6, 4)]
    assert spies.totals()["ops"]["vm_lookup"] == tuple(float(sum(w)) for w in zip(*want))


def _step(both):
    _, cap, (cfg, _, mcfg, params, rk), R, model, _ = both
    ro, rd, vd, rgb = _rays(cap, R, model, 16)
    state = create_train_state(copy.deepcopy(params), cfg.fine_train, start_step=R.start_step - 1)
    step = make_train_step(loop.make_forward(mcfg, rk), cfg.fine_train, lr_anchor=R.lr_anchor)
    batch = {"rays_o": ro, "rays_d": rd, "viewdirs": vd, "rgb": rgb}
    return lambda: step(state, batch)


def test_a_step_opens_the_vm_spans_under_a_profiler(both):
    fn = _step(both)
    fn()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    ev = lambda p: [e for e in prof.events() if e.name.startswith(p)]  # noqa: E731
    (fwd,), (bwd,) = ev("train_step/forward_loss"), ev("train_step/backward")
    field, back = ev("field/vm"), ev("backward/vm")
    inside = lambda e, outer: (outer.time_range.start <= e.time_range.start  # noqa: E731
                               <= e.time_range.end <= outer.time_range.end)
    assert len(field) == 2 and all(inside(e, fwd) for e in field)  # density's and k0's
    # each query's node, and inside it the six lookups' gathers
    assert len(back) == 2 + 12 and all(inside(e, bwd) for e in back)
    assert not ev("backward/gather")  # the dense grids' span reads none of TensoRF's
    nodes = [e for e in back if not any(o is not e and inside(e, o) for o in back)]
    adds = ev("aten::index_add_")
    assert len(nodes) == 2 and len(adds) == 12
    assert all(any(inside(a, b) for b in nodes) for a in adds)
    mms = [e for e in ev("aten::mm") if inside(e, bwd)]  # the projection's and the MLP's
    assert any(any(inside(a, b) for b in nodes) for a in mms)


def test_a_step_opens_no_range_without_a_profiler(both, monkeypatch):
    made = []
    real = profiling.record_function
    monkeypatch.setattr(profiling, "record_function", lambda name: made.append(name) or real(name))
    fn = _step(both)
    fn()
    assert made == []


@pytest.mark.parametrize("channels,xyz_grad", [(1, False), (6, False), (6, True)])
def test_the_vm_node_is_the_plain_graph_to_the_bit(channels, xyz_grad):
    g = torch.Generator().manual_seed(channels)
    t = grids.TensoRFGrid(channels, (9, 11, 7), (-1, -1.2, -0.8), (1, 1.1, 0.9), n_comp=3,
                          generator=g)
    xyz = (torch.rand(40, 5, 3, generator=g) * 2.4 - 1.2).requires_grad_(xyz_grad)
    w = torch.randn(40, 5, channels, generator=g)
    tables = tuple(getattr(t, n) for n in grids.TENSORF_LEAVES[:6])
    outs, grads = [], []
    for query in (lambda: t(xyz), lambda: grids.vm_lookup(
            grids._norm01(xyz, t.xyz_min, t.xyz_max), t.f_vec, tables)):
        t.zero_grad(set_to_none=True)
        xyz.grad = None
        out = query()
        (out * w).sum().backward()
        outs.append(out.detach())
        grads.append([p.grad for p in t.leaves().values()] + ([xyz.grad] if xyz_grad else []))
    assert torch.equal(*outs)
    for a, b in zip(*grads):
        assert torch.equal(a, b)


RUNS = {"plain": {}, "traced": {"trace": True}, "half_batch": {"faults": ["half_batch"]},
        "state_unchanged": {"faults": ["state_unchanged"]}, "control": {"control": True}}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The cell's runs at the small size, in a process of their own: this
    one holds JAX (the tests' conftest), which a run refuses to share."""
    tmp = tmp_path_factory.mktemp("runs")
    code = f"""
import json, sys
sys.path.insert(0, {str(ROOT)!r})
sys.path.insert(0, {str(ROOT / "tests")!r})
import torch
from benchmark.core import runner
from test_bench_tensorf import CELL, RUNS, SEED, SMALL
torch.set_num_threads(2)
out = {{k: runner.run({str(ROOT)!r}, CELL, SEED, 0.3, kw.get("trace", False), "cpu",
                     overrides=SMALL, faults=kw.get("faults", ()), control=kw.get("control", False),
                     log=lambda *a, **k: None) for k, kw in RUNS.items()}}
print(json.dumps(out))
"""
    env = {"PATH": "/usr/bin:/bin", "HOME": str(tmp), "TMPDIR": str(tmp), "OMP_NUM_THREADS": "2"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=600, env=env)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("run", ["plain", "traced"])
def test_the_cell_runs_and_is_correct(runs, run):
    res = runs[run]
    assert res["correct"], res["checks"]
    assert res["attempted"] >= 1 and res["failed"] == 0
    c = spec.load(ROOT, CELL)
    if run == "plain":
        assert set(res["metrics"]) == {"setup_s", "train_rays_per_s.dcvgo"}
    else:  # no kernel ran on the CPU: the device's metrics are left out
        assert set(res["metrics"]) <= {m["name"] for m in c.per_layer}


@pytest.mark.parametrize("fault", ["half_batch", "state_unchanged"])
def test_a_broken_timed_path_is_not_correct(runs, fault):
    assert runs[fault]["correct"] is False, runs[fault]["checks"]


def test_the_control_fails_a_limit(runs):
    """The reference in bfloat16 in the program's place."""
    res = runs["control"]
    assert res["correct"], res["checks"]
    ok, checks = check.judge(res["control"], spec.load(ROOT, CELL).limits)
    assert not ok, checks


def test_the_reference_and_the_family_load_no_jax_and_nothing_of_the_port(tmp_path):
    code = f"""
import json, sys
sys.path.insert(0, {str(ROOT)!r})
from benchmark.core import spec
import benchmark.reference.tensorf, benchmark.counts.vm
spec.module({str(ROOT)!r}, "families", "tensorf")
print(json.dumps(sorted({{m.split(".", 1)[0] for m in sys.modules}})))
"""
    env = {"PATH": "/usr/bin:/bin", "HOME": str(tmp_path), "TMPDIR": str(tmp_path)}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=300, env=env)
    assert out.returncode == 0, out.stderr[-3000:]
    tops = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "torch" in tops and "benchmark" in tops
    assert not tops & {"jax", "jaxlib", "flax", "unboundednerfpytorch_tpu",
                       "unboundednerfpytorch_tpu_torch"}, sorted(tops)
