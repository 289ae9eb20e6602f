"""The plain reference of DVGO's bounded train step with TensoRF fields
(``nerf/ship.tensorf.py``; the vector-matrix decomposition of Chen et al.,
"TensoRF", ECCV 2022, as DirectVoxGO's ``TensoRFGrid`` carries it), at the
window's step, from a configuration file of the benchmark and its capture
alone. Plain PyTorch: nothing of the program, no JAX, TF32 off.

- The box: the coarse stage's, every training ray's points at ``near`` and
  ``far``; a coarse voxel density holding the written scene
  (``inputs/bounded.py``), read by trilinear interpolation at its nodes,
  gives the fine box (the nodes whose alpha passes ``bbox_thres``), widened
  by ``world_bound_scale``; the fine lattice follows from ``num_voxels``.
- The occupancy cache: the coarse alpha at the fine lattice's nodes, 3^3
  max-pooled, at least ``mask_cache_thres``, and the fine density's alpha
  there, pooled, over ``fast_color_thres``.
- The forward: each ray's entry into the box, samples ``stepsize`` voxels
  apart from there, the cache's nearest lookup, the density, ``raw2alpha``
  with the interval, both ``fast_color_thres`` cuts around the transmittance
  (``cumprod``, the early exit at 1e-3), the MLP on k0 and the
  view-direction embedding, compositing on the white background.
- The VM field: ``F.grid_sample`` (bilinear, ``align_corners=True``, zeros
  padding) on the planes and lines laid out as images [1, R, A, B] and
  [1, R, A, 1], as the published ``compute_tensorf_feat`` samples them;
  each plane's sample times its complementary line's, the three products
  projected by ``f_vec`` (k0) or summed (density).
- The losses: ``reference/train.py::losses`` (main, ``entropy_last``,
  ``rgbper``). Adam: the moments and the bias-corrected step of masked Adam,
  an element of a ``skip_zero_grad_fields`` group whose gradient is 0
  keeping its value and moments, over the 13 VM leaves and the MLP.

Departures from the published code: the density is computed at the samples
the cache keeps and k0 and the MLP at those over both thresholds, then
scattered into [N, S] (the published forward compacts its samples so); the
rest weigh 0 in every output and gradient. ``dt`` bfloat16 (the control):
the leaves and each lookup rounded to bfloat16, the products, projection,
alpha, scan, MLP and compositing in it; the ray geometry and the lookups'
coordinates stay float32.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.inputs import bounded, weights
from benchmark.inputs.capture import view_rays
from benchmark.reference import model as M
from benchmark.reference.recipe import thres_at
from benchmark.reference.train import BETA1, BETA2, EPS, losses

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

FIELDS = ("density", "k0")
VIEWBASE_PE = 4  # DVGO's view-direction embedding: 3 + 6 * 4 inputs


@dataclasses.dataclass(frozen=True)
class VMRecipe:
    xyz_min: tuple
    xyz_max: tuple
    world_size: tuple
    voxel_size: float
    voxel_size_ratio: float
    mlp_dims: tuple
    viewbase_pe: int
    stepsize: float
    act_shift: float
    thres: float
    near: float
    bg: float
    train: dict
    start_step: int

    @property
    def interval(self) -> float:
        return self.stepsize * self.voxel_size_ratio

    @property
    def n_samples(self) -> int:
        return int(np.linalg.norm(np.asarray(self.world_size, np.float64) + 1) / self.stepsize) + 1

    @property
    def lr_anchor(self) -> int:
        return max([1] + [int(b) for b in self.train["pg_scale"] if int(b) <= self.start_step])


def act_shift(alpha_init: float) -> float:
    return math.log(1.0 / (1.0 - alpha_init) - 1.0)


def lattice(xyz_min, xyz_max, num_voxels: int, num_voxels_base: int):
    """(world size, voxel size, voxel size ratio) of DVGO's lattice on a box."""
    ext = np.array(xyz_max, np.float64) - np.array(xyz_min, np.float64)
    vs = float((np.prod(ext) / num_voxels) ** (1.0 / 3.0))
    base = float((np.prod(ext) / num_voxels_base) ** (1.0 / 3.0))
    return tuple(int(v) for v in (ext / vs).astype(np.int64)), vs, vs / base


def norm01(pts, xyz_min, xyz_max):
    mn = torch.tensor(xyz_min, dtype=torch.float32, device=pts.device)
    mx = torch.tensor(xyz_max, dtype=torch.float32, device=pts.device)
    return (pts - mn) / (mx - mn)


@torch.no_grad()
def on_nodes(fn, axes, slab_nodes: int = 1 << 21):
    """``fn`` (points [..., 3] -> values [...]) at the nodes of the lattice
    of ``axes``: [len(axes[0]), ...] f32, in x-slabs."""
    ys, zs = axes[1], axes[2]
    out = torch.empty([len(a) for a in axes], dtype=torch.float32, device=ys.device)
    step = max(1, slab_nodes // (len(ys) * len(zs)))
    for a in range(0, len(axes[0]), step):
        out[a:a + step] = fn(torch.stack(torch.meshgrid(axes[0][a:a + step], ys, zs,
                                                        indexing="ij"), -1))
    return out


def voxel_field(grid, xyz_min, xyz_max):
    """A voxel grid [X, Y, Z] on a box, read by trilinear interpolation."""
    return lambda p: M.trilerp(grid.reshape(-1, 1), tuple(grid.shape),
                               norm01(p, xyz_min, xyz_max), torch.float32)[..., 0]


def _sample_image(img, coords, dt):
    """``img`` [A, B, R] (a plane) bilinearly at ``coords`` [M, 2] in [0, 1]
    (the first indexing A): [M, R] in ``dt``."""
    x = img.to(dt).float().permute(2, 0, 1)[None]
    g = (coords[:, [1, 0]] * 2.0 - 1.0)[None, None]
    out = F.grid_sample(x, g, mode="bilinear", padding_mode="zeros", align_corners=True)
    return out[0, :, 0].T.to(dt)


def vm_field(leaves: dict, n01, dt):
    """A VM field at points ``n01`` [M, 3] in [0, 1]: [M, C] in ``dt``."""
    x, y, z = n01[:, 0:1], n01[:, 1:2], n01[:, 2:3]
    zero = torch.zeros_like(x)
    xy = _sample_image(leaves["xy_plane"], torch.cat([x, y], 1), dt)
    xz = _sample_image(leaves["xz_plane"], torch.cat([x, z], 1), dt)
    yz = _sample_image(leaves["yz_plane"], torch.cat([y, z], 1), dt)
    xv = _sample_image(leaves["x_vec"][:, None, :], torch.cat([x, zero], 1), dt)
    yv = _sample_image(leaves["y_vec"][:, None, :], torch.cat([y, zero], 1), dt)
    zv = _sample_image(leaves["z_vec"][:, None, :], torch.cat([z, zero], 1), dt)
    if "f_vec" in leaves:
        return torch.cat([xy * zv, xz * yv, yz * xv], -1) @ leaves["f_vec"].to(dt)
    return ((xy * zv).sum(-1) + (xz * yv).sum(-1) + (yz * xv).sum(-1))[:, None]


def recipe_fields(cfg: dict) -> dict:
    """The fields' components, k0's channels and the MLP's ((in, out), ...)."""
    fm = cfg["fine_model_and_render"]
    if fm["density_type"] != "TensoRFGrid" or fm["k0_type"] != "TensoRFGrid":
        raise ValueError("the reference covers TensoRF density and k0")
    k0_dim, width, depth = int(fm["rgbnet_dim"]), int(fm["rgbnet_width"]), int(fm["rgbnet_depth"])
    dims = [3 + 6 * VIEWBASE_PE + k0_dim] + [width] * (depth - 1) + [3]
    return {"n_comp": {"density": int(dict(fm["density_config"])["n_comp"]),
                       "k0": int(dict(fm["k0_config"])["n_comp"])},
            "k0_dim": k0_dim, "mlp_dims": tuple(zip(dims[:-1], dims[1:]))}


def recipe_and_model(cfg: dict, start_step: int, cap, seed: int, device) -> tuple:
    """(VMRecipe, {"leaves": {"density.<leaf>", "k0.<leaf>", "mlp.<i>.weight",
    "mlp.<i>.bias"}, "mask"}) at the window's first step."""
    fm, cm, ft = cfg["fine_model_and_render"], cfg["coarse_model_and_render"], cfg["fine_train"]
    # the coarse stage's box: every training ray at near and far
    lo = hi = None
    for v in range(cap.poses.shape[0]):
        ro, _, vd = view_rays(cap.H, cap.W, cap.poses[v].to(device))
        for p in (ro + vd * bounded.NEAR, ro + vd * bounded.FAR):
            lo = p.amin(0) if lo is None else torch.minimum(lo, p.amin(0))
            hi = p.amax(0) if hi is None else torch.maximum(hi, p.amax(0))
    c_min, c_max = lo.tolist(), hi.tolist()
    c_ws, _, c_ratio = lattice(c_min, c_max, int(cm["num_voxels_rgb"]), int(cm["num_voxels_base_rgb"]))
    c_shift = act_shift(float(cm["alpha_init"]))
    coarse = bounded.written_density(c_ws, c_min, c_max, c_shift, device)
    # the fine box: the coarse nodes whose alpha passes bbox_thres, widened
    axes = bounded.axis_nodes(c_min, c_max, c_ws, device)
    alpha = M.raw2alpha(on_nodes(voxel_field(coarse, c_min, c_max), axes), c_shift, c_ratio)
    hit = alpha > float(fm["bbox_thres"])
    ends = [axes[i][hit.any(dim=tuple(j for j in range(3) if j != i))] for i in range(3)]
    b_min = np.array([float(e.min()) for e in ends], np.float64)
    b_max = np.array([float(e.max()) for e in ends], np.float64)
    widen = (b_max - b_min) * (float(fm["world_bound_scale"]) - 1) / 2
    xyz_min, xyz_max = tuple(map(float, b_min - widen)), tuple(map(float, b_max + widen))
    ws, vs, ratio = lattice(xyz_min, xyz_max, int(fm["num_voxels_rgb"]),
                            int(fm["num_voxels_base_rgb"]))
    passed = sum(1 for b in ft["pg_scale"] if int(b) <= start_step)
    shift = act_shift(float(fm["alpha_init"])) - float(ft["decay_after_scale"]) * passed
    sched = fm["fast_color_thres_schedule"]
    thres = thres_at(sched, start_step) if sched else float(fm["fast_color_thres"])
    fields = recipe_fields(cfg)
    k0_dim, n_comp = fields["k0_dim"], fields["n_comp"]
    R = VMRecipe(xyz_min=xyz_min, xyz_max=xyz_max, world_size=ws, voxel_size=vs,
                 voxel_size_ratio=ratio, mlp_dims=fields["mlp_dims"], viewbase_pe=VIEWBASE_PE,
                 stepsize=float(fm["stepsize"]), act_shift=shift, thres=thres, near=bounded.NEAR,
                 bg=1.0 if cfg["data"]["white_bkgd"] else 0.0, train=dict(ft),
                 start_step=start_step)
    leaves = {}
    for f, ch, sh in (("density", 1, shift), ("k0", k0_dim, None)):
        vals = bounded.vm_leaves(bounded.VM_STREAMS[f], n_comp[f], ch, xyz_min, xyz_max, ws, sh,
                                 seed, device)
        leaves.update({f"{f}.{k}": v for k, v in vals.items()})
    mlp = [(torch.zeros((b, a), device=device), torch.zeros((b,), device=device))
           for a, b in R.mlp_dims]
    weights.fill_mlp(mlp, seed)
    for i, (w, b) in enumerate(mlp):
        leaves[f"mlp.{i}.weight"], leaves[f"mlp.{i}.bias"] = w, b
    # the occupancy cache: the coarse seed at the fine nodes, then the fine alpha
    axes = bounded.axis_nodes(xyz_min, xyz_max, ws, device)
    density = {k.split(".", 1)[1]: v for k, v in leaves.items() if k.startswith("density.")}
    with torch.no_grad():
        c_alpha = M.raw2alpha(on_nodes(voxel_field(coarse, c_min, c_max), axes), c_shift, c_ratio)
        seed_mask = pool(c_alpha) >= float(fm["mask_cache_thres"])
        del c_alpha, coarse
        d = on_nodes(lambda p: vm_field(density, norm01(p.reshape(-1, 3), xyz_min, xyz_max),
                                        torch.float32).reshape(p.shape[:-1]), axes)
        alive = pool(M.raw2alpha(d, shift, ratio)) > thres
    return R, {"leaves": leaves, "mask": seed_mask & alive}


def pool(vol):
    return F.max_pool3d(vol[None, None], kernel_size=3, stride=1, padding=1)[0, 0]


def sample(R: VMRecipe, ro, rd):
    """DVGO's bounded samples: (pts [N, S, 3], live [N, S]) from each ray's
    entry into the box (past ``near``), ``stepsize`` voxels apart, live
    below the ray's step count and inside the box."""
    mn = torch.tensor(R.xyz_min, dtype=torch.float32, device=ro.device)
    mx = torch.tensor(R.xyz_max, dtype=torch.float32, device=ro.device)
    vec = torch.where(rd == 0, torch.full_like(rd, 1e-6), rd)
    rate_a, rate_b = (mx - ro) / vec, (mn - ro) / vec
    t_min = torch.clamp(torch.minimum(rate_a, rate_b).amax(-1), R.near, 1e9)
    t_max = torch.clamp(torch.maximum(rate_a, rate_b).amin(-1), R.near, 1e9)
    d_norm = torch.clamp_min(torch.sqrt(rd[:, 0] * rd[:, 0] + rd[:, 1] * rd[:, 1]
                                        + rd[:, 2] * rd[:, 2]), 1e-12)
    stepdist = R.stepsize * R.voxel_size
    n_steps = torch.clamp_min(torch.ceil((t_max - t_min) * d_norm / stepdist), 1.0)
    start = ro + rd * t_min[:, None]
    dirn = rd / d_norm[:, None]
    step = torch.arange(R.n_samples, dtype=torch.float32, device=ro.device)
    pts = start[:, None, :] + dirn[:, None, :] * (step * stepdist)[None, :, None]
    live = (step[None, :] < n_steps[:, None]) & ((pts >= mn) & (pts <= mx)).all(-1)
    return pts, live


def mask_lookup(R: VMRecipe, mask, pts):
    """The occupancy cache at the node nearest each point; False outside."""
    size = torch.tensor(mask.shape, dtype=torch.float32, device=pts.device)
    mn = torch.tensor(R.xyz_min, dtype=torch.float32, device=pts.device)
    mx = torch.tensor(R.xyz_max, dtype=torch.float32, device=pts.device)
    scale = (size - 1) / (mx - mn)
    ijk = torch.round(pts * scale + -mn * scale).to(torch.int64)
    sz = size.to(torch.int64)
    inside = ((ijk >= 0) & (ijk < sz)).all(-1)
    ijk = torch.minimum(torch.clamp_min(ijk, 0), sz - 1)
    return mask.reshape(-1)[(ijk[..., 0] * sz[1] + ijk[..., 1]) * sz[2] + ijk[..., 2]] & inside


def forward(R: VMRecipe, leaves: dict, mask, ro, rd, vd, dt=torch.float32) -> dict:
    """A batch of rays through the forward; the outputs the losses read."""
    with torch.no_grad():
        pts, live = sample(R, ro, rd)
        live &= mask_lookup(R, mask, pts)
        n01 = norm01(pts, R.xyz_min, R.xyz_max)
    N, S = live.shape
    field = {f: {k.split(".", 1)[1]: v for k, v in leaves.items() if k.startswith(f + ".")}
             for f in FIELDS}
    at = live.nonzero(as_tuple=True)
    density = torch.zeros((N, S), dtype=dt, device=ro.device).index_put(
        at, vm_field(field["density"], n01[at], dt)[:, 0])
    w, ai, keep = M.march(R, density, live, dt)
    kat = keep.nonzero(as_tuple=True)
    x = torch.cat([vm_field(field["k0"], n01[kat], dt),
                   M.view_embedding(vd, R.viewbase_pe).to(dt)[kat[0]]], -1)
    n_mlp = len(R.mlp_dims)
    for i in range(n_mlp):
        x = F.linear(x, leaves[f"mlp.{i}.weight"].to(dt), leaves[f"mlp.{i}.bias"].to(dt))
        if i < n_mlp - 1:
            x = torch.relu(x)
    rgb = torch.zeros((N, S, 3), dtype=dt, device=ro.device).index_put(kat, torch.sigmoid(x))
    rgb_marched = (w[..., None] * rgb).sum(1) + ai[:, None] * R.bg
    return {"rgb": rgb_marched, "alphainv_last": ai, "weights": w, "raw_rgb": rgb, "mask": keep,
            "live": live}


class Trainer:
    """The recipe's training state from the window's first step: the leaves
    (f32), Adam's moments and count, the occupancy cache."""

    def __init__(self, R: VMRecipe, leaves: dict, mask, dt=torch.float32):
        self.R, self.params, self.mask, self.dt = R, leaves, mask, dt
        self.m = {k: torch.zeros_like(p) for k, p in leaves.items()}
        self.v = {k: torch.zeros_like(p) for k, p in leaves.items()}
        self.count = 0
        self.step_no = R.start_step - 1
        self.slots = []  # each step's (slots, kept by the cache, kept over both thresholds)

    def step(self, rays, target):
        """One update; returns (loss, the gradients as Adam gets them)."""
        step = self.step_no + 1
        ft = self.R.train
        leaves = {k: p.detach().clone().requires_grad_() for k, p in self.params.items()}
        out = forward(self.R, leaves, self.mask, *rays, dt=self.dt)
        self.slots.append((out["live"].numel(), int(out["live"].sum()), int(out["mask"].sum())))
        out = {k: v.float() if v.is_floating_point() else v for k, v in out.items()}
        loss = losses(self.R, out, target, 0.0)
        loss.backward()
        grads = {k: torch.zeros_like(p) if p.grad is None else p.grad for k, p in leaves.items()}
        del out, leaves
        self.count += 1
        bias = math.sqrt(1.0 - BETA2**self.count) / (1.0 - BETA1**self.count)
        decay = 0.1 ** (max(step - self.R.lr_anchor, 0) / (int(ft["lrate_decay"]) * 1000))
        skip = set(ft["skip_zero_grad_fields"])
        with torch.no_grad():
            for k, p in self.params.items():
                group = "rgbnet" if k.startswith("mlp.") else k.split(".", 1)[0]
                size = bias * float(ft[f"lrate_{group}"]) * decay
                g = grads[k]
                m1 = self.m[k] * BETA1 + g * (1.0 - BETA1)
                v1 = self.v[k] * BETA2 + g * (1.0 - BETA2) * g
                upd = p - size * m1 / (torch.sqrt(v1) + EPS)
                if group in skip:
                    keep = g != 0
                    m1, v1, upd = (torch.where(keep, a, b) for a, b in
                                   ((m1, self.m[k]), (v1, self.v[k]), (upd, p)))
                self.m[k], self.v[k] = m1, v1
                p.copy_(upd)
        self.step_no = step
        return loss.detach(), grads
