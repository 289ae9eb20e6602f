"""The plain reference's parts that the families' forward passes share, in
plain PyTorch operations, in blocks; each family's own forward is its file,
``benchmark/families/<family>.py`` (FourierGrid, CVPR'24; DCVGO, DVGO v2).

It imports nothing of the program. Every step is the published model's
mathematics as the recipe configures it: the contraction of the unbounded
scene into the cube, the contracted sampling, the occupancy cache's nearest
lookup, a sample budget's compaction (each ray's first ``budget`` samples of
a mask), the trilinear corner sums of every bank and channel, raw density
to alpha, the transmittance scan with its early exit, both
``fast_color_thres`` thresholds, the colour MLP on k0 and the
view-direction embedding, and compositing.

``dt`` is the precision the field's arithmetic runs in: float32 as the
configuration states, or bfloat16 for the control (the ray geometry stays
float32 there; the interpolation, alpha, scan, MLP and compositing do not).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from benchmark.reference.recipe import Recipe

EARLY_EXIT_T = 1e-3


def softplus(x):
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-x.abs()))


def raw2alpha(density, shift: float, interval: float):
    return 1.0 - torch.exp(-softplus(density + shift) * interval)


def scan(alpha):
    """w_i = T_i alpha_i, T_{i+1} = T_i (1 - alpha_i), a sample counted
    while the transmittance entering it is at least ``EARLY_EXIT_T``:
    (weights, alphainv_last, t_excl)."""
    t_incl = torch.cumprod(1.0 - alpha, dim=-1)
    t_excl = torch.cat([torch.ones_like(t_incl[:, :1]), t_incl[:, :-1]], dim=-1)
    processed = t_excl >= EARLY_EXIT_T
    weights = t_excl * alpha * processed.to(alpha.dtype)
    stop = ~processed
    first = stop.to(torch.int32).argmax(dim=-1)
    at_stop = torch.gather(t_excl, -1, first[:, None].long())[:, 0]
    return weights, torch.where(stop.any(-1), at_stop, t_incl[:, -1]), t_excl


def linspace(lo: float, hi: float, n: int, device):
    """lo (1 - i/(n-1)) + hi i/(n-1), the last node exactly ``hi``."""
    i = torch.arange(n, dtype=torch.float32, device=device) / float(n - 1)
    out = lo * (1.0 - i) + hi * i
    out[-1] = hi
    return out


def t_values(n_inner: int, t_boundary: float, device):
    """Bin centres: n_inner inside [0, t_boundary], as many outside at
    t_boundary / linspace(1, 1/128)."""
    b_in = torch.linspace(0.0, t_boundary, n_inner + 1, device=device)
    b_out = t_boundary / torch.linspace(1.0, 1.0 / 128.0, n_inner + 1, device=device)
    return torch.cat([(b_in[1:] + b_in[:-1]) * 0.5, (b_out[1:] + b_out[:-1]) * 0.5])


def contract(pts, bg_len: float):
    """Points beyond the unit cube (inf-norm) pulled into [-1-bg_len,
    1+bg_len]: p / |p| (B - bg_len / |p|) with B = 1 + bg_len."""
    norm = pts.abs().amax(-1, keepdim=True)
    inner = norm <= 1.0
    safe = torch.clamp_min(norm, 1e-10)
    B = 1.0 + bg_len
    return torch.where(inner, pts, pts / safe * (B - (B - 1.0) / safe)), inner[..., 0]


def sample(R: Recipe, center, radius, ro, rd):
    """Contracted sample points [N, S, 3], their inner mask and t [S]."""
    o = (ro - center) / radius
    d = rd / torch.linalg.norm(rd, dim=-1, keepdim=True)
    t = t_values(R.n_inner, R.t_boundary, ro.device)
    pts, inner = contract(o[:, None, :] + d[:, None, :] * t[None, :, None], R.bg_len)
    return pts, inner, t


def norm01(pts, cube: float):
    """Points of the cube [-cube, cube]^3 mapped to [0, 1]^3, as (p - min) /
    (max - min) with the corners as tensors: the port's float operations, so
    that a point on a voxel's rounding edge falls alike on both sides."""
    mn = torch.tensor([-cube] * 3, dtype=pts.dtype, device=pts.device)
    mx = torch.tensor([cube] * 3, dtype=pts.dtype, device=pts.device)
    return (pts - mn) / (mx - mn)


def mask_lookup(mask, pts, cube: float):
    """The occupancy cache [X, Y, Z] at the voxel nearest each point; False
    outside it."""
    size = torch.tensor(mask.shape, dtype=torch.float32, device=pts.device)
    mn = torch.tensor([-cube] * 3, dtype=torch.float32, device=pts.device)
    mx = torch.tensor([cube] * 3, dtype=torch.float32, device=pts.device)
    scale = (size - 1) / (mx - mn)
    ijk = torch.round(pts * scale + -mn * scale).to(torch.int64)
    sz = size.to(torch.int64)
    inside = ((ijk >= 0) & (ijk < sz)).all(-1)
    ijk = torch.minimum(torch.clamp_min(ijk, 0), sz - 1)
    flat = (ijk[..., 0] * sz[1] + ijk[..., 1]) * sz[2] + ijk[..., 2]
    return mask.reshape(-1)[flat] & inside


def compact(mask, budget: int):
    """Each row's first ``budget`` true entries, near to far: (index, live)."""
    s = mask.shape[1]
    order = torch.arange(s, device=mask.device)
    score = torch.where(mask, s - order, torch.full_like(order, -1))
    top, sel = torch.topk(score, budget, dim=-1)
    live = top > 0
    return torch.where(live, sel, torch.zeros_like(sel)), live


def take(x, sel):
    """x [N, S, ...] at sel [N, B]."""
    idx = sel.reshape(sel.shape + (1,) * (x.ndim - 2)).expand(*sel.shape, *x.shape[2:])
    return torch.gather(x, 1, idx)


def trilerp(table, dims, c01, dt, offset: int = 0, packed: bool = False):
    """Trilinear interpolation of a flat table [T, C] (a lattice of ``dims``
    at rows ``offset`` on) at ``c01`` [..., 3] in [0, 1] (nodes at 0 and 1,
    corners outside weighted 0), summed over the eight corners in ``dt``:
    one after another, or with ``packed`` as one sum over a corner axis (the
    order of the port's two gathers, the grids' and the packed tables')."""
    X, Y, Z = dims
    size = torch.tensor(dims, dtype=torch.int64, device=c01.device)
    c = c01 * (size.to(c01.dtype) - 1)
    c0 = torch.floor(c)
    f = c - c0
    c0 = c0.to(torch.int64)
    out, terms = None, []
    for dx in (0, 1):
        for dy in (0, 1):
            for dz in (0, 1):
                ijk = c0 + torch.tensor([dx, dy, dz], device=c0.device)
                ok = ((ijk >= 0) & (ijk < size)).all(-1)
                fx = f[..., 0] if dx else 1.0 - f[..., 0]
                fy = f[..., 1] if dy else 1.0 - f[..., 1]
                fz = f[..., 2] if dz else 1.0 - f[..., 2]
                w = (fx * fy * fz * ok.to(f.dtype)).to(dt)
                ijk = torch.minimum(torch.clamp_min(ijk, 0), size - 1)
                flat = (ijk[..., 0] * Y + ijk[..., 1]) * Z + ijk[..., 2] + offset
                rows = table.index_select(0, flat.reshape(-1)).reshape(*flat.shape, -1)
                term = rows.to(dt) * w[..., None]
                if packed:
                    terms.append(term)
                else:
                    out = term if out is None else out + term
    return torch.stack(terms, -2).sum(-2) if packed else out


def bank_coords(pts, cube: float, banks: int):
    """Each bank's query point in [0, 1]: [..., banks, 3]; bank 0 the point
    itself, then sin and cos of 2^k times it."""
    c = norm01(pts, cube) * 2.0 - 1.0
    out = [c]
    for k in range((banks - 1) // 2):
        out += [torch.sin(c * 2.0**k), torch.cos(c * 2.0**k)]
    return (torch.stack(out, -2) + 1.0) * 0.5


def field(grid, c01b, dt, packed: bool = False):
    """The mean over banks of each bank's trilinear value: grid [B, X, Y, Z,
    C] (any float dtype, a leaf for a gradient) at c01b [..., B, 3]."""
    B, X, Y, Z, C = grid.shape
    flat = grid.reshape(B * X * Y * Z, C)
    out = None
    for b in range(B):
        v = trilerp(flat, (X, Y, Z), c01b[..., b, :], dt, offset=b * X * Y * Z, packed=packed)
        out = v if out is None else out + v
    return out / B


def view_embedding(vd, pe: int):
    freqs = 2.0 ** torch.arange(pe, dtype=vd.dtype, device=vd.device)
    emb = (vd[..., None] * freqs).reshape(*vd.shape[:-1], -1)
    return torch.cat([vd, torch.sin(emb), torch.cos(emb)], -1)


def colour(R: Recipe, mlp, k0, vd, dt):
    """sigmoid(MLP([k0, viewdir embedding])): [N, S, 3]. ``mlp``: [(weight
    [out, in], bias [out])]."""
    N, S = k0.shape[:2]
    e = view_embedding(vd, R.viewbase_pe).to(dt)
    x = torch.cat([k0.to(dt), e[:, None, :].expand(N, S, e.shape[-1])], -1)
    for i, (w, b) in enumerate(mlp):
        x = F.linear(x, w.to(dt), b.to(dt))
        if i < len(mlp) - 1:
            x = torch.relu(x)
    return torch.sigmoid(x)


def march(R: Recipe, density, live, dt):
    """Alpha, the scan and both thresholds: (weights masked, alphainv_last,
    mask of the samples kept)."""
    alpha = raw2alpha(density.to(dt), R.act_shift, R.interval)
    with torch.no_grad():
        keep = live & (alpha > R.thres)
    alpha = torch.where(keep, alpha, torch.zeros_like(alpha))
    w, ai, _ = scan(alpha)
    keep = keep & (w > R.thres)
    return w * keep.to(w.dtype), ai, keep


def cumdist_thres(dist, thres: float):
    """Per ray a running sum of step lengths that marks a sample and starts
    again from 0 wherever it passes ``thres``."""
    cum = torch.zeros(dist.shape[0], dtype=dist.dtype, device=dist.device)
    out = torch.empty(dist.shape, dtype=torch.bool, device=dist.device)
    for i in range(dist.shape[1]):
        cum = cum + dist[:, i]
        over = cum > thres
        cum = cum * (1.0 - over.to(dist.dtype))
        out[:, i] = over
    return out


def forward(R: Recipe, g: dict, ro, rd, vd, bg, dt=torch.float32, render: bool = False):
    """One block of rays through the family's forward (its file's
    ``forward``). ``g``: density, k0 (grids [B, X, Y, Z, C]), mlp, mask (the
    occupancy cache), center, radius, and what the family's
    ``prepare_render`` adds. A render sums each lookup's corners as the
    port's render tables do. ``bg``: a number or [N, 3]. Returns a dict of
    the outputs the losses read, with the per-sample ones at the samples the
    forward kept (``outputs``)."""
    return R.family.forward(R, g, ro, rd, vd, bg, dt, render)


def outputs(w, ai, keep, rgb, rgb_marched, density, tt, n_max: int) -> dict:
    s = 1.0 - 1.0 / (1.0 + tt)
    return {"rgb": rgb_marched, "alphainv_last": ai, "weights": w, "raw_rgb": rgb,
            "raw_density": density, "mask": keep, "t": tt, "s": s,
            "depth": (w * s.to(w.dtype)).sum(-1), "n_max": n_max}


@torch.no_grad()
def density_on_lattice(R: Recipe, grid, dims, packed: bool = False, slab_nodes: int = 1 << 21):
    """The density field (every bank) at the nodes of a ``dims`` lattice on
    the cube: [X, Y, Z] f32, in x-slabs. ``packed``: corners summed as the
    port's render tables sum them (its density bake)."""
    X, Y, Z = dims
    dev = grid.device
    cube = R.cube
    axes = [linspace(-cube, cube, n, dev) for n in dims]
    out = torch.empty(dims, dtype=torch.float32, device=dev)
    slab = max(1, slab_nodes // (Y * Z))
    for a in range(0, X, slab):
        p = torch.stack(torch.meshgrid(axes[0][a:a + slab], axes[1], axes[2], indexing="ij"), -1)
        out[a:a + slab] = R.family.density_at(R, grid, p, packed)
    return out


@torch.no_grad()
def occupancy(R: Recipe, density_grid):
    """The occupancy cache a refresh makes from the density: the 3^3
    max-pool of the alpha of a voxel's length at the lattice's nodes, over
    the threshold."""
    d = density_on_lattice(R, density_grid, R.world_size)
    alpha = raw2alpha(d, R.act_shift, R.voxel_size_ratio)
    pooled = F.max_pool3d(alpha[None, None], kernel_size=3, stride=1, padding=1)[0, 0]
    return pooled > R.thres
