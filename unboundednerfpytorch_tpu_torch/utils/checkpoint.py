"""Checkpoints of the port: a directory with ``meta.json`` and the numpy
archives it names: the parameters and, where the optimizer's state is kept,
the optimizer's state.

Counterpart of ``unboundednerfpytorch_tpu/utils/checkpoint.py`` for the
FourierGrid, DVGO, DCVGO and DMPIGO families: the same ``meta.json`` keys
(global_step, family, model_kwargs, has_opt_state, format_version), so the
model can be re-instantiated from the files alone. The port writes numpy
archives of the JAX layouts (nested keys joined by ``/``): the parameters
as ``convert.params_to_numpy`` gives them, the optimizer's state as
``convert.opt_state_to_numpy`` (step count and both Adam moments).

Format 3 names its members by step (``params-<step>.npz``,
``opt_state-<step>.npz``) and lists them in ``meta.json``. A save writes the
new members beside the old ones, then ``meta.json`` by an atomic rename, and
only then removes the members that the previous ``meta.json`` named. A
process killed at any point of a save thus leaves a whole checkpoint: the
previous one until the rename, the new one after it. While a save runs, both
lie on disk (for a 320^3 seven-bank model with its moments, twice some 30 GB).
Formats 2 (``params.npz`` and ``opt_state.npz``, the port's last) and 1 (bf16
grids stored as float32 values) still load. Since format 2 a bfloat16 grid is
stored as its 16-bit patterns (uint16), named with its dtype in
``meta.json``'s ``stored_dtypes``, and a float ``act_shift`` as float64.

The JAX package's own checkpoints load as well, with neither flax nor the
``msgpack`` package (``utils/flax_msgpack.py``): a directory with the JAX
``meta.json`` (format 1, no ``members``), ``params.msgpack`` and
``opt_state.msgpack`` (a ``fine_last``, a ``fine_last_merged``, a block of
``--num_per_block``). The msgpack holds the state dict of the JAX params
(their arrays, in their stored dtype: a bfloat16 grid stays bfloat16); the
bounds and frequency counts that the JAX dataclasses keep static come from
the model the config builds, as the JAX ``load_model`` takes them from its
template. :func:`save_jax_model` writes that layout, its msgpack bytes those
of ``flax.serialization.to_bytes`` of the JAX tree, so that a run of the port
goes back to the JAX package.

A reference ``.tar`` checkpoint loads through :func:`load_model` as well
(``utils/reference_import.py``). :func:`merge_blocks` makes one checkpoint of
the block checkpoints of ``--num_per_block`` training.

A Block-NeRF block is saved by :func:`save_block_nerf` as ``params.npz`` (the
layout of ``convert.block_nerf_to_numpy``, nested keys joined by ``/``) and
``meta.json`` (the JAX entry point's block, steps and psnr, and the model's
sizes), in the JAX package's directory layout. :func:`load_block_nerf` also
reads the JAX entry point's block (``params.msgpack`` and its ``meta.json``),
and :func:`save_jax_block_nerf` writes one.
"""

from __future__ import annotations

import json
import os
import zipfile

import numpy as np
import torch

from unboundednerfpytorch_tpu_torch import convert
from unboundednerfpytorch_tpu_torch.fields.grids import TENSORF_LEAVES, DenseGrid, TensoRFGrid
from unboundednerfpytorch_tpu_torch.parallel import mesh as mesh_mod
from unboundednerfpytorch_tpu_torch.utils import flax_msgpack

FAMILIES = tuple(convert.CONFIGS)
FORMAT_VERSION = 3
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
JAX_PARAMS, JAX_OPT_STATE = "params.msgpack", "opt_state.msgpack"


def _flatten(tree, prefix: str = "") -> dict:
    out = {}
    for key, val in tree.items():
        name = f"{prefix}{key}"
        if val is None:  # a model without an rgb MLP
            continue
        if isinstance(val, dict):
            out.update(_flatten(val, name + "/"))
        elif isinstance(val, (list, tuple)) and val and isinstance(val[0], np.ndarray):
            out.update({f"{name}/{i}": v for i, v in enumerate(val)})
        else:
            out[name] = np.asarray(val)
    return out


def _unflatten(flat: dict) -> dict:
    """Nested dicts from ``/``-joined keys; a level keyed 0..n-1 is a list."""
    tree: dict = {}
    for name, val in flat.items():
        node = tree
        parts = name.split("/")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = val
    return flax_msgpack.lists(tree)


def _write_npz(path: str, arrays: dict) -> None:
    """``np.savez``'s archive (stored members, one ``.npy`` each), each
    member written in one piece: ``np.savez`` copies and checksums 16 MB at
    a time, half again as slow at full width."""
    with zipfile.ZipFile(path + ".tmp", "w", zipfile.ZIP_STORED, allowZip64=True) as zf:
        for name, arr in arrays.items():
            arr = np.require(arr, requirements="C")  # keeps a 0-d array 0-d
            with zf.open(name + ".npy", "w", force_zip64=True) as f:
                np.lib.format.write_array_header_1_0(
                    f, np.lib.format.header_data_from_array_1_0(arr))
                f.write(memoryview(arr.reshape(-1)).cast("B"))
    os.replace(path + ".tmp", path)


def _read_npz(path: str) -> dict:
    """The arrays of an ``np.savez`` archive, each read straight from its
    offset in the file: ``np.load`` reads a member 256 KB at a time through
    ``zipfile``, four to five times as slow at full width."""
    out = {}
    with zipfile.ZipFile(path) as zf, open(path, "rb") as raw:
        for info in zf.infolist():
            name = info.filename[:-len(".npy")]
            if info.compress_type != zipfile.ZIP_STORED:
                raise ValueError(f"{path}: member {info.filename} is compressed")
            with zf.open(info) as f:
                version = np.lib.format.read_magic(f)
                read_header = (np.lib.format.read_array_header_1_0 if version == (1, 0)
                               else np.lib.format.read_array_header_2_0)
                shape, fortran, dtype = read_header(f)
                header_len = f.tell()
            raw.seek(info.header_offset)
            local = raw.read(30)  # the local file header, then its name and extra field
            raw.seek(info.header_offset + 30 + int.from_bytes(local[26:28], "little")
                     + int.from_bytes(local[28:30], "little") + header_len)
            count = int(np.prod(shape))
            arr = np.fromfile(raw, dtype=dtype, count=count)
            if arr.size != count:
                raise ValueError(f"{path}: member {info.filename} is truncated")
            out[name] = arr.reshape(shape, order="F" if fortran else "C")
    return out


def _current_members(path: str) -> set:
    """The file names that ``path``'s meta.json names (none without one)."""
    try:
        with open(os.path.join(path, "meta.json")) as f:
            meta = json.load(f)
    except FileNotFoundError:
        return set()
    members = meta.get("members") or {"params": "params.npz", "opt_state": "opt_state.npz"}
    return {m for m in members.values() if m}


def _member(kind: str, step: int, taken: set) -> str:
    """A file name for a new member that the current checkpoint does not use
    (a second save of one step must not overwrite what meta.json names)."""
    name, k = f"{kind}-{step}.npz", 1
    while name in taken:
        name, k = f"{kind}-{step}.{k}.npz", k + 1
    return name


def _check_family(family: str) -> None:
    if family not in FAMILIES:
        raise NotImplementedError(f"{family!r} checkpoints are not ported yet; the port "
                                  f"writes and reads {FAMILIES}")


def save_model(path: str, family: str, cfg, params, global_step: int = 0,
               opt_state: dict | None = None) -> None:
    """``opt_state``: a ``MaskedAdam.state_dict()``, saved beside the
    parameters (``has_opt_state``).

    Grids cut along x over a grid group (``--grid_parallel``), and their
    moments, are assembled whole in host memory of the group's first rank
    (``parallel.mesh.gather_to_host``: no card holds more than its slab and
    one in flight), which writes the checkpoint in the one format that every
    reader takes; every rank of the group calls this, and the others write
    nothing."""
    _check_family(family)
    shards = {n: getattr(params, n).shard for n in mesh_mod.sharded_names(params)}
    grids = {n: mesh_mod.gather_to_host(getattr(params, n).grid, s) for n, s in shards.items()}
    if opt_state is not None and shards:
        opt_state = {**opt_state, **{key: {
            g: [mesh_mod.gather_to_host(m, shards[g]) for m in ms] if g in shards else ms
            for g, ms in opt_state[key].items()} for key in ("exp_avg", "exp_avg_sq")}}
    if any(g is None for g in grids.values()):
        return  # not the group's first rank
    os.makedirs(path, exist_ok=True)
    flat = _flatten(convert.params_to_numpy(params, bf16_bits=True, grids=grids))
    if np.ndim(flat["act_shift"]) == 0:
        flat["act_shift"] = np.float64(params.act_shift)
    stored = {f"{name}/grid": "bfloat16" for name in ("density", "k0")
              if getattr(params, name).dense and flat[f"{name}/grid"].dtype == np.uint16}
    taken = _current_members(path)
    members = {"params": _member("params", global_step, taken), "opt_state": None}
    _write_npz(os.path.join(path, members["params"]), flat)
    if opt_state is not None:
        members["opt_state"] = _member("opt_state", global_step, taken)
        _write_npz(os.path.join(path, members["opt_state"]),
                   _flatten(convert.opt_state_to_numpy(opt_state, family)))
    meta = {
        "global_step": int(global_step),
        "family": family,
        "model_kwargs": convert.config_to_dict(cfg),
        "has_opt_state": opt_state is not None,
        "format_version": FORMAT_VERSION,
        "stored_dtypes": stored,
        "members": members,
    }
    with open(os.path.join(path, "meta.json.tmp"), "w") as f:
        json.dump(meta, f, indent=2)
    os.replace(os.path.join(path, "meta.json.tmp"), os.path.join(path, "meta.json"))
    # the new checkpoint is whole: what no longer belongs to it goes
    keep = {m for m in members.values() if m}
    for old in os.listdir(path):
        if old.startswith(("params", "opt_state")) and ".npz" in old and old not in keep:
            os.remove(os.path.join(path, old))


def load_model(path: str, device="cpu", with_opt_state: bool = True):
    """Re-instantiate from the checkpoint alone, on ``device``. Returns
    (family, cfg, params, global_step, opt_state), as the JAX package does;
    ``opt_state`` is None where the checkpoint holds none or
    ``with_opt_state`` is false (a render needs none), else a state for
    ``MaskedAdam.load_state_dict`` whose moments are numpy arrays. A JAX
    checkpoint directory loads with its optimizer's state, its grids in the
    dtype they were stored in. A path to a reference ``.tar`` file is
    imported transparently (``utils/reference_import.py``), without the
    optimizer's state."""
    if os.path.isfile(path) and path.endswith(".tar"):
        # a reference checkpoint, converted in memory: --ft_path run.tar
        # migrates a reference run; it carries no optimizer state
        from unboundednerfpytorch_tpu_torch.utils.reference_import import import_checkpoint

        family, cfg, params, step = import_checkpoint(path, device=device)
        return family, cfg, params, step, None
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    family = meta["family"]
    _check_family(family)
    if is_jax_checkpoint(path, meta):
        return _load_jax_model(path, meta, device, with_opt_state)
    version = meta.get("format_version", 1)
    if version not in (1, 2, FORMAT_VERSION):
        raise ValueError(f"{path}: checkpoint format {version} is unknown")
    members = meta.get("members") or {"params": "params.npz", "opt_state": "opt_state.npz"}
    cfg = convert.config_from_dict(meta["model_kwargs"], family)
    stored = meta.get("stored_dtypes", {})
    flat = _read_npz(os.path.join(path, members["params"]))
    flat = {k: convert.bf16_from_bits(v) if stored.get(k) == "bfloat16" else v
            for k, v in flat.items()}
    params = convert.params_from_numpy(family, _unflatten(flat), device)
    dt = getattr(cfg, "grid_dtype", "float32")
    for field in (params.density, params.k0):
        if field.dense:
            field.grid.data = field.grid.data.to(_DTYPES[dt])
    opt_state = None
    if with_opt_state and meta.get("has_opt_state"):
        opt_state = convert.opt_state_from_numpy(
            _unflatten(_read_npz(os.path.join(path, members["opt_state"]))), family)
    return family, cfg, params, int(meta["global_step"]), opt_state


def merge_blocks(block_paths, out_path: str, device="cpu") -> None:
    """The block checkpoints merged into one at ``out_path``: the elementwise
    minimum of every block's ``density`` and ``k0`` grids (every bank, in
    their stored dtype), the first block's other parameters and global step,
    the family's ``update_occupancy_cache`` run on the result; no
    optimizer state. As in the JAX package, a field without a lattice grid
    (a TensoRF field) cannot be merged: ``AttributeError``."""
    assert block_paths, "no blocks to merge"
    family, cfg, params, step, _ = load_model(block_paths[0], device=device,
                                              with_opt_state=False)
    params.requires_grad_(False)
    for path in block_paths[1:]:
        family_i, _, params_i, _, _ = load_model(path, device=device, with_opt_state=False)
        assert family_i == family
        for name in ("density", "k0"):
            field, other = getattr(params, name), getattr(params_i, name)
            if not (field.dense and other.dense):
                raise AttributeError(f"{path}: its {name} field has no lattice grid to merge "
                                     f"({type(other).__name__})")
            torch.minimum(field.grid.data, other.grid.data, out=field.grid.data)
        del params_i
    params = convert.FAMILIES[family].update_occupancy_cache(params, cfg)
    save_model(out_path, family, cfg, params, global_step=step)


def save_block_nerf(path: str, model, meta: dict) -> None:
    """A Block-NeRF block's ``params.npz`` and ``meta.json`` (``meta`` and
    ``model_kwargs``, the model's sizes) in the directory ``path``."""
    os.makedirs(path, exist_ok=True)
    _write_npz(os.path.join(path, "params.npz"), _flatten(convert.block_nerf_to_numpy(model)))
    with open(os.path.join(path, "meta.json"), "w") as f:
        json.dump({**meta, "model_kwargs": model.dims}, f, indent=2)


def has_block_nerf(path: str) -> bool:
    """Whether ``path`` holds a Block-NeRF block of either package."""
    return any(os.path.isfile(os.path.join(path, name)) for name in ("params.npz", JAX_PARAMS))


def load_block_nerf(path: str, device="cpu"):
    """(model on ``device``, meta) of a block saved by :func:`save_block_nerf`
    or by the JAX entry point (``params.msgpack``; the port's own
    ``params.npz`` wins where a directory holds both)."""
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    npz = os.path.join(path, "params.npz")
    if os.path.isfile(npz):
        tree = _unflatten(_read_npz(npz))
    else:
        tree = flax_msgpack.lists(flax_msgpack.read(os.path.join(path, JAX_PARAMS)))
    return convert.block_nerf_from_numpy(tree, device), meta


def save_jax_block_nerf(path: str, model, meta: dict) -> None:
    """A Block-NeRF block in the JAX entry point's layout: ``params.msgpack``
    (the bytes of ``flax.serialization.to_bytes`` of the JAX
    ``BlockNeRFParams``) and ``meta.json`` (``meta``, as the JAX entry point
    writes its block, steps and psnr)."""
    os.makedirs(path, exist_ok=True)
    _write_msgpack(os.path.join(path, JAX_PARAMS),
                   _state_dict(convert.block_nerf_to_numpy(model)))
    with open(os.path.join(path, "meta.json"), "w") as f:
        json.dump(meta, f)


# ---------------------------------------------------------------------------
# the JAX package's checkpoints (flax msgpack)


def is_jax_checkpoint(path: str, meta: dict) -> bool:
    """A directory the JAX package's ``save_model`` wrote: its
    ``params.msgpack`` and a ``meta.json`` that names no port members."""
    return "members" not in meta and os.path.isfile(os.path.join(path, JAX_PARAMS))


def _state_dict(tree):
    """flax's state dict of a tree in ``convert``'s layouts: lists as maps
    keyed ``"0"``, ``"1"``, ..."""
    if isinstance(tree, dict):
        return {k: _state_dict(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return {str(i): _state_dict(v) for i, v in enumerate(tree)}
    return tree


def _write_msgpack(path: str, tree) -> None:
    with open(path + ".tmp", "wb") as f:
        flax_msgpack.write(f, tree)
    os.replace(path + ".tmp", path)


def _jax_field(field):
    """The state dict of a field as the JAX package lays it out: a lattice
    grid (``[X, Y, Z, C]`` for a dense one, the banks for a Fourier one) in
    its dtype, or a TensoRF field's leaves (``f_vec`` nil where it has none)."""
    if field is None:
        return None
    if isinstance(field, TensoRFGrid):
        leaves = field.leaves()
        return {k: (leaves[k].detach() if k in leaves else None) for k in TENSORF_LEAVES}
    grid = field.grid.detach()
    return {"grid": grid[0] if isinstance(field, DenseGrid) else grid}


def jax_params_state_dict(family: str, params) -> dict:
    """The state dict that flax gives the JAX params of ``family`` (its
    dataclass fields in order), the arrays the port's own tensors."""
    rgbnet = None
    if params.rgbnet is not None:
        rgbnet = {"weights": [lin.weight.detach().t() for lin in params.rgbnet.layers],
                  "biases": [lin.bias.detach() for lin in params.rgbnet.layers]}
    shift = params.act_shift
    shift = (shift.detach().float() if isinstance(shift, torch.Tensor)
             else np.asarray(np.float32(shift)))
    tree = {"density": _jax_field(params.density), "k0": _jax_field(params.k0),
            "rgbnet": rgbnet}
    if family == "FourierGrid":
        emb = params.img_embeddings
        tree["vd"] = _jax_field(params.vd)
        tree["img_embeddings"] = None if emb is None else emb.detach()
    tree["act_shift"] = shift
    tree["mask_cache"] = {"mask": params.mask_cache.mask}
    return _state_dict(tree)


def jax_opt_state_state_dict(state: dict, family: str) -> dict:
    """The state dict of the JAX ``MaskedAdamState`` of a port optimizer's
    ``state_dict()``: the step as int32, each moment tree keyed by group in
    sorted order (the JAX state's trees are made by ``jax.tree.map``, which
    sorts a dict's keys), a TensoRF group's ``f_vec`` nil where it has none."""
    tree = convert.opt_state_to_numpy(state, family)
    out = {"step": np.asarray(np.int32(tree["step"]))}
    for key in ("exp_avg", "exp_avg_sq"):
        groups = {}
        for name in sorted(tree[key]):
            sub = tree[key][name]
            if isinstance(sub, dict) and "xy_plane" in sub:
                sub = {k: sub.get(k) for k in TENSORF_LEAVES}
            groups[name] = sub
        out[key] = groups
    return _state_dict(out)


def save_jax_model(path: str, family: str, cfg, params, global_step: int = 0,
                   opt_state: dict | None = None) -> None:
    """The JAX package's checkpoint layout in the directory ``path``:
    ``params.msgpack`` (and with ``opt_state``, a ``MaskedAdam.state_dict()``,
    ``opt_state.msgpack``), each the bytes of ``flax.serialization.to_bytes``
    of the JAX tree, and its ``meta.json`` (format 1, the port's config as
    ``model_kwargs``: the JAX ``load_model`` drops the fields its config
    lacks). Each array is written from host memory a tensor at a time."""
    _check_family(family)
    os.makedirs(path, exist_ok=True)
    _write_msgpack(os.path.join(path, JAX_PARAMS), jax_params_state_dict(family, params))
    opt_path = os.path.join(path, JAX_OPT_STATE)
    if opt_state is not None:
        _write_msgpack(opt_path, jax_opt_state_state_dict(opt_state, family))
    elif os.path.exists(opt_path):
        os.remove(opt_path)
    meta = {"global_step": int(global_step), "family": family,
            "model_kwargs": convert.config_to_dict(cfg), "has_opt_state": opt_state is not None,
            "format_version": 1}
    with open(os.path.join(path, "meta.json.tmp"), "w") as f:
        json.dump(meta, f, indent=2)
    os.replace(os.path.join(path, "meta.json.tmp"), os.path.join(path, "meta.json"))


def _with_statics(sub, template):
    """A field's arrays from the msgpack with the bounds, frequencies and
    channels the JAX dataclasses keep static, from the config's model."""
    if sub is None:
        return None
    if template is None:
        raise ValueError("the checkpoint holds a field that its config's model does not have")
    out = {k: v for k, v in sub.items() if v is not None}
    out.update(xyz_min=template.xyz_min, xyz_max=template.xyz_max)
    if isinstance(template, TensoRFGrid):
        out["channels"] = template.channels
    elif hasattr(template, "num_freqs") and not isinstance(template, DenseGrid):
        out["num_freqs"] = template.num_freqs
    return out


def _load_jax_model(path: str, meta: dict, device, with_opt_state: bool):
    family = meta["family"]
    cfg = convert.config_from_dict(meta["model_kwargs"], family)
    template = convert.FAMILIES[family].create(cfg, None, device="meta")
    tree = flax_msgpack.lists(flax_msgpack.read(os.path.join(path, JAX_PARAMS)))
    tree["mask_cache"] = _with_statics(tree["mask_cache"], template.mask_cache)
    for name in ("density", "k0", "vd"):
        if name in tree:
            tree[name] = _with_statics(tree[name], getattr(template, name, None))
    if (tree["rgbnet"] is None) != (template.rgbnet is None):
        raise ValueError(f"{path}: rgbnet {'absent' if tree['rgbnet'] is None else 'present'} "
                         "against the config's model")
    params = convert.params_from_numpy(family, tree, device)
    opt_state = None
    opt_path = os.path.join(path, JAX_OPT_STATE)
    if with_opt_state and meta.get("has_opt_state") and os.path.exists(opt_path):
        opt_state = convert.opt_state_from_numpy(flax_msgpack.lists(flax_msgpack.read(opt_path)),
                                                 family)
    return family, cfg, params, int(meta["global_step"]), opt_state
