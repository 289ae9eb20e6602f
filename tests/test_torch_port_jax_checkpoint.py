"""The JAX package's checkpoints read and written by the port without flax or
the ``msgpack`` package (``utils/flax_msgpack.py``, ``utils/checkpoint.py``),
against the JAX package on the CPU.

Small models of each family (12^3 voxels, one Fourier frequency, rgbnet
width 16; FourierGrid also with bfloat16 grids, the view grid and
appearance embeddings; DVGO also with TensoRF fields) are drawn by the JAX
package's ``build_model`` and saved by its ``save_model`` with an Adam state
whose moments are random. Tolerances: none. The port's ``load_model`` must
give, to the bit, what the JAX ``load_model`` (with ``restore_opt_state``)
gives, carried into the port's layout by ``convert``; the port's writer must
give the bytes of ``flax.serialization.to_bytes``; and the command line's
``train --ft_path <JAX directory>`` must resume as from the native
checkpoint of the same run, every loss equal (``chip_smoke.py`` phase 15b
holds the render of such a directory on the card).
"""

import dataclasses
import json
import pathlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import serialization

from unboundednerfpytorch_tpu.configs.schema import ExpConfig as JExpConfig
from unboundednerfpytorch_tpu.configs.schema import ModelRenderConfig as JModelRenderConfig
from unboundednerfpytorch_tpu.configs.schema import TrainStageConfig as JTrainStageConfig
from unboundednerfpytorch_tpu.models.block_nerf import model as jbn
from unboundednerfpytorch_tpu.train import loop as jloop
from unboundednerfpytorch_tpu.train import step as jstep
from unboundednerfpytorch_tpu.utils import checkpoint as jckpt
from unboundednerfpytorch_tpu_torch import convert
from unboundednerfpytorch_tpu_torch.cli import main as cli
from unboundednerfpytorch_tpu_torch.configs.schema import TrainStageConfig
from unboundednerfpytorch_tpu_torch.data import synthetic
from unboundednerfpytorch_tpu_torch.optim import factory
from unboundednerfpytorch_tpu_torch.train import loop
from unboundednerfpytorch_tpu_torch.utils import checkpoint as ckpt
from unboundednerfpytorch_tpu_torch.utils import flax_msgpack
from torch_threads import torch_threads  # noqa: F401: the workers' share of the cores

ROOT = pathlib.Path(__file__).resolve().parents[1]
XYZ_MIN, XYZ_MAX = (-1.0, -1.2, -0.8), (1.1, 1.0, 1.2)
MODEL_KW = dict(num_voxels_density=12**3, num_voxels_rgb=12**3, num_voxels_base_density=12**3,
                num_voxels_base_rgb=12**3, rgbnet_dim=6, rgbnet_width=16, rgbnet_depth=3,
                alpha_init=1e-2, fast_color_thres=1e-4, maskout_near_cam_vox=False,
                fourier_freq_num=1, mpi_depth=8, stepsize=0.5)
TENSORF = dict(density_type="TensoRFGrid", k0_type="TensoRFGrid",
               density_config=(("n_comp", 3),), k0_config=(("n_comp", 4),))
CASES = {
    "FourierGrid_f32": ("FourierGrid", {}, {}),
    "FourierGrid_bf16_vd_emb": ("FourierGrid", dict(grid_dtype="bfloat16",
                                                    num_voxels_viewdir=6**3, img_emb_dim=4),
                                dict(lrate_vd=0.1, lrate_img_embeddings=0.01)),
    "dvgo": ("dvgo", {}, {}),
    "dvgo_tensorf": ("dvgo", TENSORF, {}),
    "dcvgo": ("dcvgo", {}, {}),
    "dmpigo": ("dmpigo", {}, {}),
}


def jax_model(name, seed=0):
    """(family, JAX config, JAX params, JAX train config) with random values
    in every array the JAX model trains (and a mask that drops a fifth of
    the voxels), so that no leaf is a constant."""
    family, extra, train_extra = CASES[name]
    exp = JExpConfig()
    if family == "FourierGrid":
        exp = dataclasses.replace(exp, model="FourierGrid")
    elif family == "dcvgo":
        exp = dataclasses.replace(exp, data=dataclasses.replace(exp.data, unbounded_inward=True))
    elif family == "dmpigo":
        exp = dataclasses.replace(exp, data=dataclasses.replace(exp.data, ndc=True))
    tcfg = JTrainStageConfig(pg_scale=(), **train_extra)
    fam, jcfg, jp = jloop.build_model(exp, JModelRenderConfig(**{**MODEL_KW, **extra}), tcfg,
                                      np.array(XYZ_MIN), np.array(XYZ_MAX),
                                      jax.random.PRNGKey(seed), n_train=5)
    assert fam == family
    rng = np.random.default_rng(seed)
    noisy = lambda x: jnp.asarray(rng.standard_normal(x.shape), x.dtype)  # noqa: E731
    params = jax.tree.map(noisy, jp.replace(mask_cache=None))
    mask = rng.random(jp.mask_cache.mask.shape) > 0.2
    return family, jcfg, params.replace(mask_cache=jp.mask_cache.replace(mask=jnp.asarray(mask))), \
        tcfg


def jax_opt_state(params, tcfg, seed=1):
    """The JAX train state's Adam state with random moments and step 7."""
    state = jstep.create_train_state(params, tcfg).opt_state
    rng = np.random.default_rng(seed)
    rand = lambda x: jnp.asarray(rng.random(x.shape), x.dtype)  # noqa: E731
    return state._replace(step=jnp.asarray(7, jnp.int32),
                          exp_avg=jax.tree.map(rand, state.exp_avg),
                          exp_avg_sq=jax.tree.map(rand, state.exp_avg_sq))


def port_train_cfg(name):
    return TrainStageConfig(pg_scale=(), **CASES[name][2])


def assert_trees_equal(got, want, path=""):
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            assert_trees_equal(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_trees_equal(g, w, f"{path}/{i}")
    elif isinstance(want, (np.ndarray, torch.Tensor)):
        g, w = (np.asarray(x.view(torch.int16) if isinstance(x, torch.Tensor) and
                           x.dtype == torch.bfloat16 else x) for x in (got, want))
        assert g.dtype == w.dtype and g.shape == w.shape, (path, g.dtype, w.dtype)
        np.testing.assert_array_equal(g, w, err_msg=path)
    else:
        assert np.asarray(got).tolist() == np.asarray(want).tolist(), path


def port_tree(params):
    """The port's params in the JAX layout, bf16 grids as bit patterns."""
    return convert.params_to_numpy(params, bf16_bits=True)


def opt_numpy(state):
    """A ``MaskedAdam.state_dict()``-shaped state, moments as numpy."""
    return {"step": int(state["step"]),
            **{k: {n: [np.asarray(m.detach().cpu() if isinstance(m, torch.Tensor) else m)
                       for m in ms] for n, ms in state[k].items()}
               for k in ("exp_avg", "exp_avg_sq")}}


@pytest.mark.parametrize("name", list(CASES))
def test_a_jax_checkpoint_loads_as_jax_loads_it_and_writes_back_to_its_bytes(name, tmp_path):
    family, jcfg, jp, tcfg = jax_model(name)
    jopt = jax_opt_state(jp, tcfg)
    path = str(tmp_path / "jax")
    jckpt.save_model(path, family, jcfg, jp, global_step=11, opt_state=jopt)

    jfam, jcfg2, jp2, jstep_, opt_bytes = jckpt.load_model(path)
    jopt2 = jckpt.restore_opt_state(opt_bytes, jstep.create_train_state(jp2, tcfg).opt_state)
    want = convert.params_from_numpy(family, convert.tree_from_params_object(jp2), "cpu")
    want_opt = convert.opt_state_from_numpy(convert.opt_state_tree_from_object(jopt2), family)

    fam, cfg, params, step, opt = ckpt.load_model(path)
    assert (fam, step) == (jfam, jstep_) == (family, 11)
    jfields = {f.name: getattr(jcfg2, f.name) for f in dataclasses.fields(jcfg2)}
    for f in dataclasses.fields(cfg):  # as JSON: JAX leaves nested tuples as lists
        if f.name in jfields:
            assert json.dumps(getattr(cfg, f.name)) == json.dumps(jfields[f.name]), f.name
    assert_trees_equal(port_tree(params), port_tree(want))
    for name_ in ("density", "k0"):  # the stored dtype, bf16 where JAX keeps bf16
        field = getattr(params, name_)
        if field.dense:
            assert field.grid.dtype == getattr(want, name_).grid.dtype
    assert_trees_equal(opt_numpy(opt), opt_numpy(want_opt))

    # the port's writer: the bytes of flax's to_bytes, which JAX reads back
    optim = factory.make_optimizer(params, port_train_cfg(name))
    optim.load_state_dict(opt)
    out = str(tmp_path / "port")
    ckpt.save_jax_model(out, family, cfg, params, global_step=11, opt_state=optim.state_dict())
    for member in (ckpt.JAX_PARAMS, ckpt.JAX_OPT_STATE):
        assert (tmp_path / "port" / member).read_bytes() == \
            (tmp_path / "jax" / member).read_bytes(), member
    _, _, jp3, step3, _ = jckpt.load_model(out)
    assert step3 == 11
    assert_trees_equal(convert.tree_from_params_object(jp3), convert.tree_from_params_object(jp2))


def test_chunked_arrays_load_and_write_as_flax_chunks_them(tmp_path, monkeypatch):
    """Arrays over flax's MAX_CHUNK_SIZE (here 4 KB, so that the grids and
    the moments of a 12^3 model are chunked) are split into its chunk maps."""
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 4096)
    monkeypatch.setattr(flax_msgpack, "MAX_CHUNK_SIZE", 4096)
    family, jcfg, jp, tcfg = jax_model("FourierGrid_bf16_vd_emb", seed=3)
    jopt = jax_opt_state(jp, tcfg, seed=4)
    path = str(tmp_path / "jax")
    jckpt.save_model(path, family, jcfg, jp, global_step=2, opt_state=jopt)
    raw = (tmp_path / "jax" / ckpt.JAX_PARAMS).read_bytes()
    assert flax_msgpack.CHUNKED.encode() in raw
    _, _, jp2, _, _ = jckpt.load_model(path)
    _, cfg, params, _, opt = ckpt.load_model(path)
    want = convert.params_from_numpy(family, convert.tree_from_params_object(jp2), "cpu")
    assert_trees_equal(port_tree(params), port_tree(want))
    optim = factory.make_optimizer(params, port_train_cfg("FourierGrid_bf16_vd_emb"))
    optim.load_state_dict(opt)
    ckpt.save_jax_model(str(tmp_path / "port"), family, cfg, params, 2, optim.state_dict())
    for member in (ckpt.JAX_PARAMS, ckpt.JAX_OPT_STATE):
        assert (tmp_path / "port" / member).read_bytes() == \
            (tmp_path / "jax" / member).read_bytes(), member


def test_the_codec_decodes_what_msgpack_encodes():
    """Every header the codec reads, against the msgpack package's encoder
    (which the card's machine lacks), and the ndarray and scalar exts."""
    import msgpack

    values = [0, 1, 127, 128, 255, 256, 65535, 65536, 2**32 - 1, 2**32, -1, -32, -33, -128,
              -129, -32768, -32769, -2**31, -2**31 - 1, 1.5, -2.25, "x" * 31, "x" * 32,
              "x" * 300, "y" * 70000, True, False, None, list(range(20)), b"ab", b"z" * 300,
              {str(i): i for i in range(20)}]
    for v in values:
        raw = msgpack.packb(v, use_bin_type=True)
        assert flax_msgpack.pack(v) == raw, v
        got = flax_msgpack.unpack(raw)
        assert (bytes(got) if isinstance(got, memoryview) else got) == v
    tree = {"a": np.arange(6, dtype=np.float32).reshape(2, 3), "s": np.float32(2.5),
            "i": np.zeros((), np.int32), "m": np.array([True, False])}
    back = flax_msgpack.unpack(serialization.msgpack_serialize(tree))
    assert isinstance(back["s"], np.float32) and back["s"] == 2.5
    assert_trees_equal({k: back[k] for k in ("a", "i", "m")}, {k: tree[k] for k in ("a", "i", "m")})


def test_a_block_nerf_block_of_the_jax_entry_point(tmp_path):
    """The JAX entry point's block (``params.msgpack`` and its meta.json)
    loads as ``block_nerf_from_numpy`` of the JAX object, and the port's
    writer gives its bytes; ``eval_block_nerf`` finds either layout."""
    from unboundednerfpytorch_tpu.fields.mlp import MLP as JMLP
    from unboundednerfpytorch_tpu_torch.models.block_nerf.model import BlockNeRF

    # the JAX dataclass, its leaves a small seeded block's (numpy: no JAX compile)
    tree = convert.block_nerf_to_numpy(BlockNeRF(
        n_appearance=3, D=3, W=16, skips=[1], xyz_freqs=2, dir_freqs=2, exposure_freqs=1,
        appearance_dim=4, vis_width=8, generator=torch.Generator().manual_seed(0)))
    p = jbn.BlockNeRFParams(
        **{k: JMLP(weights=tuple(v["weights"]), biases=tuple(v["biases"]))
           for k, v in tree.items() if k != "appearance"}, appearance=tree["appearance"])
    block = tmp_path / "jax" / "block_0"
    block.mkdir(parents=True)
    raw = serialization.to_bytes(jax.tree.map(np.asarray, p))
    (block / ckpt.JAX_PARAMS).write_bytes(raw)
    meta = {"block": "block_0", "steps": 5, "psnr": 12.5}
    (block / "meta.json").write_text(json.dumps(meta))
    assert ckpt.has_block_nerf(str(block))
    model, got_meta = ckpt.load_block_nerf(str(block))
    want = convert.block_nerf_from_numpy(convert.block_nerf_tree_from_object(p))
    assert got_meta == meta
    assert_trees_equal(convert.block_nerf_to_numpy(model), convert.block_nerf_to_numpy(want))
    ckpt.save_jax_block_nerf(str(tmp_path / "port"), model, meta)
    assert (tmp_path / "port" / ckpt.JAX_PARAMS).read_bytes() == raw
    assert json.loads((tmp_path / "port" / "meta.json").read_text()) == meta


def test_a_merged_jax_checkpoint(tmp_path):
    """``merge_blocks`` of the JAX package (the elementwise minimum of two
    blocks' grids, its occupancy refresh) read by the port as JAX reads it."""
    paths = []
    for seed in (5, 6):
        family, jcfg, jp, _ = jax_model("dvgo", seed=seed)
        paths.append(str(tmp_path / f"fine_last_{seed}"))
        jckpt.save_model(paths[-1], family, jcfg, jp, global_step=4)
    merged = str(tmp_path / "fine_last_merged")
    jckpt.merge_blocks(paths, merged)
    _, _, jp2, _, _ = jckpt.load_model(merged)
    fam, _, params, step, opt = ckpt.load_model(merged)
    assert (fam, step, opt) == ("dvgo", 4, None)
    want = convert.params_from_numpy(fam, convert.tree_from_params_object(jp2), "cpu")
    assert_trees_equal(port_tree(params), port_tree(want))


# ---------------------------------------------------------------------------
# train --ft_path <JAX directory> through the command line


def _write_config(path, scene, logs, n_iters):
    path.write_text(f"""
_base_ = {str(ROOT / 'configs' / 'nerf_unbounded' / 'bicycle_single.py')!r}
expname = 'run'
basedir = {str(logs)!r}
data = dict(datadir={str(scene)!r})
fine_train = dict(N_iters={n_iters}, N_rand=64, pg_scale=[])
fine_model_and_render = dict(num_voxels_density=16**3, num_voxels_base_density=16**3,
    num_voxels_rgb=16**3, num_voxels_base_rgb=16**3, sample_budget=0, grid_dtype='bfloat16',
    fourier_freq_num=1)
""")
    return str(path)


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """A port run of 3 steps (its native ``fine_last``, with Adam's state)
    and the same checkpoint written in the JAX layout by the port."""
    from unboundednerfpytorch_tpu_torch.configs.loader import load_config
    from unboundednerfpytorch_tpu_torch.data.common import load_everything

    root = tmp_path_factory.mktemp("jaxrun")
    synthetic.write_llff_scene(str(root / "scene"), synthetic.orbit_scene(9, 12, 16, seed=5))
    cfg = _write_config(root / "cfg.py", root / "scene", root / "logs", 3)
    loop.run_train(load_config(cfg), load_everything(load_config(cfg)), device="cpu",
                   log_fn=lambda _: None, exp_dir=str(root / "logs" / "run"))
    native = str(root / "logs" / "run" / "fine_last")
    family, mcfg, params, step, opt = ckpt.load_model(native)
    optim = factory.make_optimizer(params, load_config(cfg).fine_train)
    optim.load_state_dict(opt)
    jax_dir = str(root / "jax_fine_last")
    ckpt.save_jax_model(jax_dir, family, mcfg, params, step, optim.state_dict())
    return root, native, jax_dir


def test_the_command_line_resumes_from_a_jax_checkpoint(jax_run, tmp_path, capsys):
    """``train --ft_path`` from the JAX-layout directory: the optimizer's
    state carried, each loss equal to a resume from the native one."""
    root, native, jax_dir = jax_run
    losses = []
    for i, ft in enumerate((native, jax_dir)):
        logs = tmp_path / f"logs{i}"
        cfg5 = _write_config(tmp_path / f"cfg{i}.py", root / "scene", logs, 5)
        assert cli.main(["--config", cfg5, "--ft_path", ft, "--i_print", "1"], device="cpu") == 0
        out = capsys.readouterr().out
        assert f"fine: resumed from {ft} at step 3 (with the optimizer's state" in out
        with open(logs / "run" / "fine_metrics.jsonl") as f:
            losses.append([r["loss"] for r in map(json.loads, f) if "loss" in r])
    assert len(losses[0]) == 2 and losses[0] == losses[1]
