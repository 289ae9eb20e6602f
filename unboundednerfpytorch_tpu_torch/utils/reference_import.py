"""Import reference UnboundedNeRFPytorch checkpoints (torch ``.tar``), and
export the port's models as such.

The port's counterpart of ``unboundednerfpytorch_tpu/utils/reference_import.py``:
a trained reference checkpoint, ``{global_step, model_kwargs,
model_state_dict, optimizer_state_dict}`` as the reference's
``FourierGrid_ckpt_manager.py`` and ``run_train.py`` write it, becomes the
port's (family, config, params), so it can be rendered, served or fine-tuned
here without retraining; ``utils.checkpoint.load_model`` takes a ``.tar``
path transparently. The port is PyTorch, so ``torch.load`` reads the file
as it is.

Layouts (the reference is channel-first; the tensors go through the tree of
``convert.py``, the JAX package's layouts, so the port's own layout rules
stay in one place):

=====================  ==============================  ========================
tensor                 reference (torch)               port
=====================  ==============================  ========================
FourierGrid bank grid  ``[2K+1, C, X, Y, Z]``          ``[2K+1, X, Y, Z, C]``
DenseGrid              ``[1, C, X, Y, Z]``             ``[1, X, Y, Z, C]``
rgbnet Linear          ``weight [out, in]``            ``nn.Linear`` as it is
TensoRF plane          ``[1, R, A, B]``                ``[A, B, R]``
TensoRF vector         ``[1, R, A, 1]``                ``[A, R]``
mask_cache.mask        ``[X, Y, Z] bool``              same
dmpigo act_shift       ``DenseGrid [1,1,1,1,D]``       ``[D]``
=====================  ==============================  ========================

The family is read off the ``model_kwargs`` key set (``fourier_freq_num`` ->
FourierGrid, ``mpi_depth`` -> dmpigo, ``contracted_norm`` -> dcvgo, else
dvgo). Every tensor is checked against the shape of the model its config
builds (a template on the ``meta`` device, which allocates nothing).

The optimizer's state is not imported, as in the JAX package: the reference
keys its moments by the index of a flat parameter group, whose order follows
its module construction; a migrated model is rendered or fine-tuned with
fresh moments.

A FourierGrid checkpoint's view-direction grid (``num_voxels_viewdir`` > 0,
``vd.*``) and coarse colour head (``rgbnet_dim`` <= 0: no MLP, k0 one plain
bank of 3 channels) are imported and exported as the JAX package does. Its
appearance embeddings (``img_embeddings.*``) are dropped on import, as the
JAX package drops them: the reference's forward never reads them, and its
MLP's input has no room for them. The other way, a model of the port whose
MLP reads appearance embeddings has no reference counterpart, and its export
raises (the JAX package writes a file that no loader takes back).
"""

from __future__ import annotations

import dataclasses
import re

import numpy as np
import torch

from unboundednerfpytorch_tpu_torch import convert
from unboundednerfpytorch_tpu_torch.fields.grids import DenseGrid

__all__ = [
    "detect_family",
    "import_checkpoint",
    "convert_reference_ckpt",
    "convert_to_reference",
    "export_checkpoint",
    "overlay_render_knobs",
]

# Render/train-time knobs that reference checkpoints do NOT store (they are
# config values in the reference too, not model state). When a converted
# .tar is used with a scene config, the config's values must win over the
# converter's defaults. Geometry/topology fields (num_voxels*, bg_len,
# fourier_freq_num, rgbnet_*) are model state and are NEVER overlaid.
_RENDER_KNOBS = (
    "stepsize",
    "t_boundary",
    "sample_budget",
    "color_budget",
    "budget_probe_stride",
    "density_bake_scale",
    "packed_gather",
)


def overlay_render_knobs(mcfg, cfg_model):
    """Overlay scene-config render knobs onto a config converted from a
    reference checkpoint (which cannot carry them). Only fields present on
    BOTH dataclasses are copied; returns the (possibly replaced) mcfg."""
    updates = {}
    for name in _RENDER_KNOBS:
        if hasattr(mcfg, name) and hasattr(cfg_model, name):
            v = getattr(cfg_model, name)
            if v is not None and getattr(mcfg, name) != v:
                updates[name] = v
    return dataclasses.replace(mcfg, **updates) if updates else mcfg


# ---------------------------------------------------------------------------
# leaf converters: reference tensors -> convert.py's tree
# ---------------------------------------------------------------------------


def _np(t) -> np.ndarray:
    """torch tensor / numpy array -> float-preserving numpy array."""
    if isinstance(t, torch.Tensor):
        t = t.detach().cpu().numpy()
    return np.asarray(t)


def _banks(t) -> np.ndarray:
    """[B, C, X, Y, Z] -> [B, X, Y, Z, C]."""
    a = _np(t)
    if a.ndim != 5:
        raise ValueError(f"expected 5D bank grid, got shape {a.shape}")
    return np.ascontiguousarray(np.transpose(a, (0, 2, 3, 4, 1)))


def _dense(t) -> np.ndarray:
    """[1, C, X, Y, Z] -> [X, Y, Z, C]."""
    a = _np(t)
    if a.ndim != 5 or a.shape[0] != 1:
        raise ValueError(f"expected [1,C,X,Y,Z] dense grid, got shape {a.shape}")
    return np.ascontiguousarray(np.transpose(a[0], (1, 2, 3, 0)))


def _mlp_layers(sd: dict, prefix: str) -> dict:
    """An nn.Sequential's Linear layers under ``prefix`` in module order
    (numeric key paths like ``rgbnet.0`` / ``rgbnet.2.0`` sort by their int
    tuple), as convert.py's ``{"weights": [in, out], "biases"}``."""
    pat = re.compile(re.escape(prefix) + r"\.((?:\d+\.)*\d+)\.weight$")
    paths = sorted(tuple(int(p) for p in m.group(1).split("."))
                   for m in map(pat.match, sd) if m)
    if not paths:
        raise KeyError(f"no Linear layers found under {prefix!r}")
    bases = [prefix + "." + ".".join(str(i) for i in p) for p in paths]
    return {"weights": [_np(sd[b + ".weight"]).T for b in bases],
            "biases": [_np(sd[b + ".bias"]) for b in bases]}


def _tensorf(sd: dict, prefix: str, field) -> dict:
    """Reference TensoRFGrid tensors -> convert.py's TensoRF leaves (the JAX
    layouts: planes [A, B, R], vectors [A, R], f_vec [R+R+Rxy, C])."""
    def plane(k):
        return np.ascontiguousarray(np.transpose(_np(sd[k])[0], (1, 2, 0)))

    def vec(k):
        return np.ascontiguousarray(_np(sd[k])[0, :, :, 0].T)

    out = {f"{a}_plane": plane(f"{prefix}.{a}_plane") for a in ("xy", "xz", "yz")}
    out.update({f"{a}_vec": vec(f"{prefix}.{a}_vec") for a in "xyz"})
    if f"{prefix}.f_vec" in sd:
        out["f_vec"] = _np(sd[f"{prefix}.f_vec"])
    return {**out, "xyz_min": field.xyz_min, "xyz_max": field.xyz_max,
            "channels": field.channels}


def _thres(v) -> float:
    """fast_color_thres may be a step-keyed dict schedule in model_kwargs
    (garden_single.py:12-21); a trained ckpt's effective value is the last
    schedule entry."""
    if isinstance(v, dict):
        return float(v[max(v, key=lambda k: int(k))])
    return float(v)


def _field_tree(template_field, sd: dict, key: str) -> dict:
    """The tree of one field (FourierGrid banks, DenseGrid or TensoRFGrid),
    in the form its template has."""
    if not template_field.dense:
        return _tensorf(sd, key, template_field)
    banked = not isinstance(template_field, DenseGrid)
    tree = {"grid": _banks(sd[f"{key}.grid"]) if banked else _dense(sd[f"{key}.grid"]),
            "xyz_min": template_field.xyz_min, "xyz_max": template_field.xyz_max}
    if banked:
        tree["num_freqs"] = template_field.num_freqs
    return tree


# ---------------------------------------------------------------------------
# family detection + config translation
# ---------------------------------------------------------------------------


def detect_family(model_kwargs: dict) -> str:
    if "fourier_freq_num" in model_kwargs:
        return "FourierGrid"
    if "mpi_depth" in model_kwargs:
        return "dmpigo"
    if "contracted_norm" in model_kwargs:
        return "dcvgo"
    return "dvgo"


def _cfg_items(d: dict | None) -> tuple:
    """dict grid config (e.g. TensoRF n_comp) -> hashable frozen items."""
    return tuple(sorted((d or {}).items()))


def _box(kw: dict, name: str) -> tuple:
    return tuple(float(v) for v in np.asarray(kw[name]).ravel())


def _mask_ws(kw: dict):
    ws = kw.get("mask_cache_world_size")
    return tuple(int(v) for v in ws) if ws else None


def _rgb_fields(kw: dict, viewbase_pe: int) -> dict:
    return dict(rgbnet_dim=int(kw.get("rgbnet_dim", 0)),
                rgbnet_depth=int(kw.get("rgbnet_depth", 3)),
                rgbnet_width=int(kw.get("rgbnet_width", 128)),
                viewbase_pe=int(kw.get("viewbase_pe", viewbase_pe)))


def _fourier_cfg(kw: dict, sd: dict) -> dict:
    return dict(
        scene_center=tuple(float(v) for v in _np(sd["scene_center"])),
        scene_radius=tuple(float(v) for v in _np(sd["scene_radius"])),
        num_voxels_density=int(kw["num_voxels_density"]),
        num_voxels_rgb=int(kw["num_voxels_rgb"]),
        num_voxels_base_density=int(kw["num_voxels_base_density"]),
        num_voxels_base_rgb=int(kw["num_voxels_base_rgb"]),
        num_voxels_viewdir=int(kw.get("num_voxels_viewdir", -1)),
        alpha_init=float(kw["alpha_init"]),
        fast_color_thres=_thres(kw["fast_color_thres"]),
        bg_len=_box(kw, "xyz_max")[0] - 1.0,
        contracted_norm=str(kw["contracted_norm"]),
        fourier_freq_num=int(kw["fourier_freq_num"]),
        # the reference builds appearance embeddings but its forward never
        # reads them and its MLP's input excludes them: dropped
        img_emb_dim=-1,
        sample_num=int(kw.get("sample_num", -1)),
        **_rgb_fields(kw, 4),
    )


def _dvgo_cfg(kw: dict, sd: dict) -> dict:
    return dict(
        xyz_min=_box(kw, "xyz_min"),
        xyz_max=_box(kw, "xyz_max"),
        num_voxels=int(kw["num_voxels"]),
        num_voxels_base=int(kw["num_voxels_base"]),
        alpha_init=float(kw["alpha_init"]),
        fast_color_thres=_thres(kw["fast_color_thres"]),
        density_type=str(kw.get("density_type", "DenseGrid")),
        k0_type=str(kw.get("k0_type", "DenseGrid")),
        density_config=_cfg_items(kw.get("density_config")),
        k0_config=_cfg_items(kw.get("k0_config")),
        rgbnet_direct=bool(kw.get("rgbnet_direct", False)),
        rgbnet_full_implicit=bool(kw.get("rgbnet_full_implicit", False)),
        mask_cache_world_size=_mask_ws(kw),
        mask_cache_thres=float(kw.get("mask_cache_thres") or 1e-3),
        **_rgb_fields(kw, 4),
    )


def _dcvgo_cfg(kw: dict, sd: dict) -> dict:
    return dict(
        scene_center=tuple(float(v) for v in _np(sd["scene_center"])),
        scene_radius=tuple(float(v) for v in _np(sd["scene_radius"])),
        num_voxels=int(kw["num_voxels"]),
        num_voxels_base=int(kw["num_voxels_base"]),
        alpha_init=float(kw["alpha_init"]),
        fast_color_thres=_thres(kw["fast_color_thres"]),
        bg_len=_box(kw, "xyz_max")[0] - 1.0,
        contracted_norm=str(kw["contracted_norm"]),
        mask_cache_world_size=_mask_ws(kw),
        **_rgb_fields(kw, 4),
    )


def _dmpigo_cfg(kw: dict, sd: dict) -> dict:
    return dict(
        xyz_min=_box(kw, "xyz_min"),
        xyz_max=_box(kw, "xyz_max"),
        num_voxels=int(kw["num_voxels"]),
        mpi_depth=int(kw["mpi_depth"]),
        fast_color_thres=_thres(kw["fast_color_thres"]),
        density_type=str(kw.get("density_type", "DenseGrid")),
        k0_type=str(kw.get("k0_type", "DenseGrid")),
        mask_cache_world_size=_mask_ws(kw),
        **_rgb_fields(kw, 0),
    )


_CONFIG_FIELDS = {"FourierGrid": _fourier_cfg, "dvgo": _dvgo_cfg, "dcvgo": _dcvgo_cfg,
                  "dmpigo": _dmpigo_cfg}


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------


def _check_shapes(template, params) -> None:
    """Every tensor of the imported model against the model its config
    builds."""
    want = {k: tuple(v.shape) for k, v in template.state_dict().items()}
    got = {k: tuple(v.shape) for k, v in params.state_dict().items()}
    if got != want:
        diff = sorted(k for k in want.keys() | got.keys() if want.get(k) != got.get(k))
        raise ValueError("the checkpoint's tensors do not fit the model its model_kwargs "
                         "build: " + "; ".join(f"{k}: checkpoint {got.get(k)} vs model "
                                               f"{want.get(k)}" for k in diff))


def convert_reference_ckpt(ckpt: dict, family: str | None = None,
                           overrides: dict | None = None, device=None):
    """In-memory conversion of a loaded reference checkpoint dict, onto
    ``device`` (``None`` -> ``cuda``, raising without a GPU; ``"cpu"`` for
    the plain path). ``family`` overrides the detection from its
    ``model_kwargs``; ``overrides`` sets config fields that the reference's
    checkpoints do not store (render-time knobs such as ``stepsize`` and
    ``t_boundary``). Returns ``(family, cfg, params, global_step)``."""
    from unboundednerfpytorch_tpu_torch.device import resolve_device

    device = resolve_device(device)
    kw = dict(ckpt["model_kwargs"])
    sd = dict(ckpt["model_state_dict"])
    family = family or detect_family(kw)
    if family not in _CONFIG_FIELDS:
        raise ValueError(f"unknown model family {family!r}")
    cfg = convert.CONFIGS[family](**{**_CONFIG_FIELDS[family](kw, sd), **(overrides or {})})
    template = convert.FAMILIES[family].create(cfg, None, device="meta")
    if family == "dmpigo":
        act_shift = _np(sd["act_shift.grid"]).reshape(-1).astype(np.float32)
    else:
        act_shift = np.float32(_np(sd["act_shift"]).ravel()[0])
    mask = _np(sd["mask_cache.mask"]).astype(bool)
    tree = {
        "density": _field_tree(template.density, sd, "density"),
        "k0": _field_tree(template.k0, sd, "k0"),
        "rgbnet": None if template.rgbnet is None else _mlp_layers(sd, "rgbnet"),
        "act_shift": act_shift,
        "mask_cache": {"mask": mask, "xyz_min": template.mask_cache.xyz_min,
                       "xyz_max": template.mask_cache.xyz_max},
    }
    if getattr(template, "vd", None) is not None:
        tree["vd"] = _field_tree(template.vd, sd, "vd")
    params = convert.params_from_numpy(family, tree, device)
    _check_shapes(template, params)
    for name in ("density", "k0"):  # the grids in the dtype the config asks for
        field, want = getattr(params, name), getattr(template, name)
        if field.dense:
            field.grid.data = field.grid.data.to(want.grid.dtype)
    return family, cfg, params, int(ckpt.get("global_step", 0))


# ---------------------------------------------------------------------------
# export (port -> reference .tar)
# ---------------------------------------------------------------------------


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


def _export_grid(sd: dict, prefix: str, tree: dict) -> None:
    """Write a field's tensors and buffers under ``prefix`` in the
    reference's layouts and buffer key set (the reference's grid.py
    registers xyz_min/xyz_max on every grid module; a strict
    load_state_dict requires them)."""
    sd[f"{prefix}.xyz_min"] = torch.tensor(list(tree["xyz_min"]), dtype=torch.float32)
    sd[f"{prefix}.xyz_max"] = torch.tensor(list(tree["xyz_max"]), dtype=torch.float32)
    if "xy_plane" in tree:  # TensoRF: [A, B, R] -> [1, R, A, B], [A, R] -> [1, R, A, 1]
        for a in ("xy", "xz", "yz"):
            sd[f"{prefix}.{a}_plane"] = _t(np.transpose(tree[f"{a}_plane"], (2, 0, 1))[None])
        for a in "xyz":
            sd[f"{prefix}.{a}_vec"] = _t(tree[f"{a}_vec"].T[None, :, :, None])
        if tree.get("f_vec") is not None:
            sd[f"{prefix}.f_vec"] = _t(tree["f_vec"])
        return
    g = np.asarray(tree["grid"], np.float32)
    if g.ndim == 5:  # FourierGrid banks [B,X,Y,Z,C] -> [B,C,X,Y,Z]
        sd[f"{prefix}.grid"] = _t(np.transpose(g, (0, 4, 1, 2, 3)))
    else:  # DenseGrid [X,Y,Z,C] -> [1,C,X,Y,Z]
        sd[f"{prefix}.grid"] = _t(np.transpose(g, (3, 0, 1, 2))[None])


def _export_mask_cache(sd: dict, mc: dict) -> None:
    mask = np.asarray(mc["mask"], bool)
    mn = np.asarray(mc["xyz_min"], np.float32)
    mx = np.asarray(mc["xyz_max"], np.float32)
    scale = (np.asarray(mask.shape, np.float32) - 1) / (mx - mn)
    sd["mask_cache.mask"] = torch.tensor(mask)
    sd["mask_cache.xyz2ijk_scale"] = torch.tensor(scale)
    sd["mask_cache.xyz2ijk_shift"] = torch.tensor(-mn * scale)


def _export_rgbnet(sd: dict, mlp: dict) -> None:
    """The [in, out] MLP -> the reference's nested-Sequential key structure
    (FourierGrid_model.py:234-241): Linear at 0, hidden Sequentials from 2,
    final Linear at index depth."""
    depth = len(mlp["weights"])
    for i, (w, b) in enumerate(zip(mlp["weights"], mlp["biases"])):
        if i == 0:
            base = "rgbnet.0"
        elif i == depth - 1:
            base = f"rgbnet.{depth}"
        else:
            base = f"rgbnet.{1 + i}.0"
        sd[base + ".weight"] = _t(np.asarray(w).T)
        sd[base + ".bias"] = _t(b)


def convert_to_reference(family: str, cfg, params, global_step: int = 0) -> dict:
    """The port's (family, cfg, params) -> the reference's checkpoint dict
    (``FourierGrid_ckpt_manager.save_model`` layout), so reference tooling
    can ``load_state_dict`` it strictly. Grids are written as float32, as
    the JAX package writes them (a bfloat16 value is exact in float32)."""
    if family not in convert.CONFIGS:
        raise ValueError(f"unknown model family {family!r}")
    if getattr(params, "img_embeddings", None) is not None:
        raise ValueError("the model's MLP reads appearance embeddings, which no reference "
                         "checkpoint holds (the reference's MLP never reads them)")
    tree = convert.params_to_numpy(params)
    sd: dict = {}
    bbox_min = np.asarray(cfg.xyz_min, np.float32)
    bbox_max = np.asarray(cfg.xyz_max, np.float32)
    sd["xyz_min"] = torch.tensor(bbox_min)
    sd["xyz_max"] = torch.tensor(bbox_max)
    if tree["rgbnet"] is not None:
        sd["viewfreq"] = torch.tensor([2.0**i for i in range(cfg.viewbase_pe)])
        _export_rgbnet(sd, tree["rgbnet"])
    _export_grid(sd, "density", tree["density"])
    _export_grid(sd, "k0", tree["k0"])
    _export_mask_cache(sd, tree["mask_cache"])

    rgb_kw = dict(rgbnet_dim=int(cfg.rgbnet_dim), rgbnet_depth=int(cfg.rgbnet_depth),
                  rgbnet_width=int(cfg.rgbnet_width), viewbase_pe=int(cfg.viewbase_pe))
    mc_ws = [int(v) for v in tree["mask_cache"]["mask"].shape]
    shift = torch.tensor([float(np.asarray(tree["act_shift"]).ravel()[0])])
    if family == "FourierGrid":
        sd["scene_center"] = torch.tensor(list(cfg.scene_center))
        sd["scene_radius"] = torch.tensor(list(cfg.scene_radius))
        sd["act_shift"] = shift
        if "vd" in tree:
            _export_grid(sd, "vd", tree["vd"])
        kw = dict(
            xyz_min=bbox_min, xyz_max=bbox_max,
            num_voxels_density=int(cfg.num_voxels_density),
            num_voxels_rgb=int(cfg.num_voxels_rgb),
            num_voxels_viewdir=int(cfg.num_voxels_viewdir),
            fourier_freq_num=int(cfg.fourier_freq_num),
            num_voxels_base_density=int(cfg.num_voxels_base_density),
            num_voxels_base_rgb=int(cfg.num_voxels_base_rgb),
            alpha_init=float(cfg.alpha_init),
            voxel_size_ratio_density=float(cfg.voxel_size_ratio_density),
            voxel_size_ratio_rgb=float(cfg._voxel_size(cfg.num_voxels_rgb)
                                       / cfg._voxel_size(cfg.num_voxels_base_rgb)),
            mask_cache_world_size=mc_ws,
            fast_color_thres=float(cfg.fast_color_thres),
            contracted_norm=str(cfg.contracted_norm),
            density_type="FourierGrid", k0_type="FourierGrid",
            density_config={}, k0_config={},
            sample_num=int(cfg.sample_num),
            **rgb_kw,
        )
    elif family == "dvgo":
        sd["act_shift"] = shift
        kw = dict(
            xyz_min=bbox_min, xyz_max=bbox_max,
            num_voxels=int(cfg.num_voxels),
            num_voxels_base=int(cfg.num_voxels_base),
            alpha_init=float(cfg.alpha_init),
            voxel_size_ratio=float(cfg.voxel_size_ratio),
            mask_cache_path=None,
            mask_cache_thres=float(cfg.mask_cache_thres),
            mask_cache_world_size=mc_ws,
            fast_color_thres=float(cfg.fast_color_thres),
            density_type=str(cfg.density_type), k0_type=str(cfg.k0_type),
            density_config=dict(cfg.density_config),
            k0_config=dict(cfg.k0_config),
            rgbnet_direct=bool(cfg.rgbnet_direct),
            rgbnet_full_implicit=bool(cfg.rgbnet_full_implicit),
            **rgb_kw,
        )
    elif family == "dcvgo":
        sd["scene_center"] = torch.tensor(list(cfg.scene_center))
        sd["scene_radius"] = torch.tensor(list(cfg.scene_radius))
        sd["act_shift"] = shift
        kw = dict(
            xyz_min=bbox_min, xyz_max=bbox_max,
            num_voxels=int(cfg.num_voxels),
            num_voxels_base=int(cfg.num_voxels_base),
            alpha_init=float(cfg.alpha_init),
            voxel_size_ratio=float(cfg.voxel_size_ratio),
            mask_cache_world_size=mc_ws,
            fast_color_thres=float(cfg.fast_color_thres),
            contracted_norm=str(cfg.contracted_norm),
            density_type="DenseGrid", k0_type="DenseGrid",
            density_config={}, k0_config={},
            **rgb_kw,
        )
    else:  # dmpigo: its act_shift is a (frozen) DenseGrid module [1,1,1,1,D]
        act = np.asarray(tree["act_shift"], np.float32).reshape(1, 1, 1, 1, -1)
        sd["act_shift.grid"] = torch.tensor(act)
        sd["act_shift.xyz_min"] = torch.tensor(bbox_min)
        sd["act_shift.xyz_max"] = torch.tensor(bbox_max)
        kw = dict(
            xyz_min=bbox_min, xyz_max=bbox_max,
            num_voxels=int(cfg.num_voxels),
            mpi_depth=int(cfg.mpi_depth),
            voxel_size_ratio=float(cfg.voxel_size_ratio),
            mask_cache_path=None, mask_cache_thres=1e-3,
            mask_cache_world_size=mc_ws,
            fast_color_thres=float(cfg.fast_color_thres),
            density_type=str(cfg.density_type), k0_type=str(cfg.k0_type),
            density_config={}, k0_config={},
            **rgb_kw,
        )
    return {
        "global_step": int(global_step),
        "model_kwargs": kw,
        "model_state_dict": sd,
        "optimizer_state_dict": {},
    }


def export_checkpoint(ckpt_dir: str, out_tar: str) -> dict:
    """Load one of the port's checkpoint directories and write a
    reference-format torch ``.tar``. Returns the exported dict."""
    from unboundednerfpytorch_tpu_torch.utils.checkpoint import load_model

    family, cfg, params, step, _ = load_model(ckpt_dir, with_opt_state=False)
    ref = convert_to_reference(family, cfg, params, global_step=step)
    torch.save(ref, out_tar)
    return ref


def import_checkpoint(tar_path: str, out_dir: str | None = None, family: str | None = None,
                      overrides: dict | None = None, device=None):
    """Load a reference ``.tar`` checkpoint and convert it onto ``device``
    (``None`` -> ``cuda``); ``family`` and ``overrides`` as
    :func:`convert_reference_ckpt` takes them. With ``out_dir``, also write
    it there as one of the port's checkpoint directories, which loads
    wherever a native checkpoint does. Returns ``(family, cfg, params,
    global_step)``."""
    # reference ckpts carry numpy arrays inside model_kwargs (get_kwargs
    # stores xyz_min/xyz_max as .numpy()), so full unpickling is required;
    # only import checkpoints you trust, exactly as with the reference
    ckpt = torch.load(tar_path, map_location="cpu", weights_only=False)
    family, cfg, params, step = convert_reference_ckpt(ckpt, family=family, overrides=overrides,
                                                       device=device)
    if out_dir is not None:
        from unboundednerfpytorch_tpu_torch.utils.checkpoint import save_model

        save_model(out_dir, family, cfg, params, global_step=step)
    return family, cfg, params, step
