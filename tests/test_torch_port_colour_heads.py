"""The port's three further colour heads against the JAX package's: the
coarse head (``rgbnet_dim <= 0``: no MLP, k0 one plain bank of 3 channels),
the view-direction grid (``num_voxels_viewdir``) and the appearance
embeddings (``img_emb_dim`` with ``sample_num``), through the forward, its
gradients, train steps with their Adam groups (``lrate_vd``,
``lrate_img_embeddings``), the native checkpoint and the reference ``.tar``.

Each model is drawn by the JAX ``create`` (random grids on top) and carried
into the port. Tolerances: values within 1e-4 relative / 1e-6 absolute,
gradients within 1e-4 relative / 1e-5 absolute (float32 sums over the
samples in another order); parameters after two train steps within 1e-4
relative / 2e-5 absolute, as ``tests/test_torch_port_train.py`` holds them.
"""

import dataclasses
import functools
import io

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_port_sparse_probe import to_port
from unboundednerfpytorch_tpu.configs.schema import TrainStageConfig as JTrainStageConfig
from unboundednerfpytorch_tpu.models import fourier_grid as jfg
from unboundednerfpytorch_tpu.train import step as jstep
from unboundednerfpytorch_tpu.utils import reference_import as jri
from unboundednerfpytorch_tpu_torch import convert
from unboundednerfpytorch_tpu_torch.configs.schema import ExpConfig, TrainStageConfig
from unboundednerfpytorch_tpu_torch.data import synthetic
from unboundednerfpytorch_tpu_torch.models import fourier_grid as fg
from unboundednerfpytorch_tpu_torch.train import loop
from unboundednerfpytorch_tpu_torch.train import step as tstep
from unboundednerfpytorch_tpu_torch.utils import checkpoint as ckpt
from unboundednerfpytorch_tpu_torch.utils import reference_import as ri

HEADS = {"coarse": dict(rgbnet_dim=0), "viewgrid": dict(num_voxels_viewdir=8**3),
         "embeddings": dict(img_emb_dim=3, sample_num=5)}
N_RAYS = 40


def head_pair(head: str, seed: int = 0):
    """(JAX config, JAX params, port config, port params) with random grids;
    the port's params are a fresh copy at every call."""
    jcfg, jp = jax_head(head, seed)
    return (jcfg, jp, *to_port(jcfg, jp))


@functools.lru_cache(maxsize=None)
def jax_head(head: str, seed: int):
    """(JAX config, JAX params) of ``head``, drawn once a process."""
    kw = dict(scene_center=(0.0, 0.0, 0.0), scene_radius=(1.5, 1.5, 1.5),
              num_voxels_density=12**3, num_voxels_rgb=12**3, num_voxels_base_density=12**3,
              num_voxels_base_rgb=12**3, alpha_init=1e-2, fast_color_thres=1e-4,
              fourier_freq_num=1, rgbnet_dim=4, rgbnet_width=16, stepsize=0.5)
    jcfg = jfg.FourierGridConfig(**{**kw, **HEADS[head]})
    jp = jfg.create(jcfg, jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    rand = lambda a, s, m: jnp.asarray(rng.standard_normal(a.shape) * s + m, a.dtype)
    jp = jp.replace(density=jp.density.replace(grid=rand(jp.density.grid, 3.0, -2.0)),
                    k0=jp.k0.replace(grid=rand(jp.k0.grid, 0.5, 0.0)))
    if jp.vd is not None:
        jp = jp.replace(vd=jp.vd.replace(grid=rand(jp.vd.grid, 0.5, 0.0)))
    return jcfg, jp


def ray_batch(seed: int = 1, n: int = N_RAYS):
    rng = np.random.default_rng(seed)
    o = rng.standard_normal((n, 3)) * 0.5 + np.array([2.5, 0.0, 0.0])
    d = rng.standard_normal((n, 3)) * 0.2 - o
    vd = d / np.linalg.norm(d, axis=-1, keepdims=True)
    return {"rays_o": o.astype(np.float32), "rays_d": d.astype(np.float32),
            "viewdirs": vd.astype(np.float32), "rgb": rng.random((n, 3)).astype(np.float32),
            "img_index": rng.integers(0, 5, n).astype(np.int32)}


def leaves(tp) -> dict:
    """The port's trainable leaves in the JAX layouts (MLP kernels [in, out])."""
    out = {"density": tp.density.grid, "k0": tp.k0.grid}
    if tp.rgbnet is not None:
        out.update({f"w{i}": lin.weight.T for i, lin in enumerate(tp.rgbnet.layers)})
    if tp.vd is not None:
        out["vd"] = tp.vd.grid
    if tp.img_embeddings is not None:
        out["img_embeddings"] = tp.img_embeddings
    return out


def jax_leaves(jp) -> dict:
    out = {"density": jp.density.grid, "k0": jp.k0.grid}
    if jp.rgbnet is not None:
        out.update({f"w{i}": w for i, w in enumerate(jp.rgbnet.weights)})
    if jp.vd is not None:
        out["vd"] = jp.vd.grid
    if jp.img_embeddings is not None:
        out["img_embeddings"] = jp.img_embeddings
    return out


@pytest.mark.parametrize("head", sorted(HEADS))
def test_create_matches_jax(head):
    """The same parameter shapes as the JAX ``create``: k0 one plain bank and
    no MLP for the coarse head, the view grid on [-1, 1]^3 at
    ``world_size_viewdir``, the embeddings [sample_num, img_emb_dim] with the
    MLP's input widened by them; the unfused query for the coarse head's
    banks, which the packed render cache then does not take."""
    jcfg, jp, tcfg, _ = head_pair(head)
    tp = fg.create(tcfg, torch.Generator().manual_seed(0))
    want = {k: tuple(v.shape) for k, v in jax_leaves(jp).items()}
    assert {k: tuple(v.shape) for k, v in leaves(tp).items()} == want
    assert tp.k0.num_freqs == jp.k0.num_freqs
    if head == "viewgrid":
        assert tcfg.world_size_viewdir == jcfg.world_size_viewdir == (8, 8, 8)
        assert (tp.vd.xyz_min, tp.vd.xyz_max) == ((-1.0,) * 3, (1.0,) * 3)
    if head == "embeddings":
        assert float(tp.img_embeddings.std()) > 0.5  # N(0, 1)
    assert fg._fused_banks(tp) == (head != "coarse")
    assert (fg.build_render_cache(tp, tcfg) is None) == (head == "coarse")


@pytest.mark.parametrize("head", sorted(HEADS))
def test_colour_heads_match_jax(head):
    """Forward values and the gradients of every leaf, the rays' views given
    as ``img_index``."""
    jcfg, jp, tcfg, tp = head_pair(head)
    b = ray_batch()
    c = np.random.default_rng(2).standard_normal((N_RAYS, 3)).astype(np.float32)

    def j_loss(lv):
        p = jp.replace(density=jp.density.replace(grid=lv["density"]),
                       k0=jp.k0.replace(grid=lv["k0"]))
        if jp.rgbnet is not None:
            p = p.replace(rgbnet=jp.rgbnet.replace(
                weights=[lv[f"w{i}"] for i in range(len(jp.rgbnet.weights))]))
        if jp.vd is not None:
            p = p.replace(vd=jp.vd.replace(grid=lv["vd"]))
        if jp.img_embeddings is not None:
            p = p.replace(img_embeddings=lv["img_embeddings"])
        r = jfg.forward(p, jcfg, *(jnp.asarray(b[k]) for k in ("rays_o", "rays_d", "viewdirs")),
                        bg=0.5, img_index=jnp.asarray(b["img_index"]))
        return jnp.sum(r.rgb_marched * c) + jnp.sum(r.alphainv_last), r

    (jl, jr), jg = jax.jit(jax.value_and_grad(j_loss, has_aux=True))(jax_leaves(jp))
    r = fg.forward(tp, tcfg, *(torch.from_numpy(b[k]) for k in ("rays_o", "rays_d", "viewdirs")),
                   bg=0.5, img_index=torch.from_numpy(b["img_index"]))
    loss = torch.sum(r.rgb_marched * torch.from_numpy(c)) + torch.sum(r.alphainv_last)
    loss.backward()
    for f in ("rgb_marched", "alphainv_last", "raw_rgb", "weights"):
        np.testing.assert_allclose(getattr(r, f).detach().numpy(), np.asarray(getattr(jr, f)),
                                   rtol=1e-4, atol=1e-6, err_msg=f)
    got = {k: v.grad if k[0] != "w" else tp.rgbnet.layers[int(k[1:])].weight.grad
           for k, v in leaves(tp).items()}
    if head == "viewgrid":  # the MLP is built, never read: no gradient (JAX: zeros)
        assert all(got.pop(f"w{i}") is None for i in range(len(tp.rgbnet.layers)))
        assert not any(np.asarray(jg.pop(f"w{i}")).any() for i in range(len(tp.rgbnet.layers)))
    got = {k: g.T if k[0] == "w" else g for k, g in got.items()}
    assert sorted(got) == sorted(jg)
    for k, g in got.items():
        np.testing.assert_allclose(g.numpy(), np.asarray(jg[k]), rtol=1e-4, atol=1e-5, err_msg=k)
        if k in ("vd", "img_embeddings"):
            assert float(g.abs().max()) > 0, k


@pytest.mark.parametrize("head", ["viewgrid", "embeddings"])
def test_train_steps_with_the_new_adam_groups_match_jax(head):
    """Two train steps with ``lrate_vd`` / ``lrate_img_embeddings`` set: the
    view grid and the embeddings are masked-Adam groups of their own, and
    every leaf ends where the JAX step puts it."""
    kw = dict(N_rand=N_RAYS, lrate_vd=0.1, lrate_img_embeddings=0.05, weight_rgbper=0.1,
              weight_entropy_last=0.01, pg_scale=(), skip_zero_grad_fields=("density", "k0"))
    jcfg, jp, tcfg, tp = head_pair(head, seed=3)
    jtrain, ttrain = JTrainStageConfig(**kw), TrainStageConfig(**kw)

    def jfwd(params, ro, rd, vd, key, img_index=None):
        return jfg.forward(params, jcfg, ro, rd, vd, bg=0.0, img_index=img_index)

    j_step = jax.jit(jstep.make_train_step(jfwd, jtrain, world_size_max=12.0, lr_anchor=1))
    j_state = jstep.create_train_state(jp, jtrain)
    t_step = tstep.make_train_step(loop.make_forward(tcfg, {"stepsize": tcfg.stepsize}), ttrain,
                                   world_size_max=12.0, lr_anchor=1)
    t_state = tstep.create_train_state(tp, ttrain)
    groups = {g.name for g in t_state.optimizer.groups}
    assert {"vd" if head == "viewgrid" else "img_embeddings"} <= groups
    for s in range(2):
        b = ray_batch(seed=10 + s)
        j_state, j_m = j_step(j_state, {k: jnp.asarray(v) for k, v in b.items()},
                              jax.random.PRNGKey(s))
        t_m = t_step(t_state, {k: torch.from_numpy(v) for k, v in b.items()})
        assert float(t_m["loss"]) == pytest.approx(float(j_m["loss"]), rel=1e-4, abs=1e-6)
    want = jax_leaves(j_state.params)
    for k, v in leaves(t_state.params).items():
        np.testing.assert_allclose(v.detach().numpy(), np.asarray(want[k]), rtol=1e-4,
                                   atol=2e-5, err_msg=k)
    moved = "vd" if head == "viewgrid" else "img_embeddings"
    assert not np.allclose(np.asarray(want[moved]), np.asarray(jax_leaves(jp)[moved]))


@pytest.mark.parametrize("head", sorted(HEADS))
def test_native_checkpoint_round_trip(head, tmp_path):
    """The port's checkpoint keeps the view grid, the embeddings, a model
    without an MLP and the new groups' Adam moments."""
    _, _, tcfg, tp = head_pair(head)
    train = TrainStageConfig(lrate_vd=0.1, lrate_img_embeddings=0.1)
    state = tstep.create_train_state(tp, train)
    for p in tp.parameters():
        p.grad = torch.ones_like(p)
    state.optimizer.step()
    ckpt.save_model(str(tmp_path / "m"), "FourierGrid", tcfg, tp, global_step=1,
                    opt_state=state.optimizer.state_dict())
    family, cfg2, p2, step, opt = ckpt.load_model(str(tmp_path / "m"))
    assert (family, cfg2, step) == ("FourierGrid", tcfg, 1)
    assert (p2.rgbnet is None) == (head == "coarse")
    got, want = p2.state_dict(), tp.state_dict()
    assert sorted(got) == sorted(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    state2 = tstep.create_train_state(p2, train, opt_state=opt)
    for key in ("exp_avg", "exp_avg_sq"):
        a, b = state.optimizer.state_dict()[key], state2.optimizer.state_dict()[key]
        assert sorted(a) == sorted(b)
        for name in a:
            for x, y in zip(a[name], b[name]):
                assert torch.equal(x, y), (key, name)


@pytest.mark.parametrize("head", ["coarse", "viewgrid"])
def test_tar_import_and_export_match_jax(head):
    """The reference ``.tar`` of the coarse head and of the view grid: the
    port's export holds the JAX export's tensors and keys, and its import of
    that file holds the JAX import's leaves and renders as it does."""
    jcfg, jp, tcfg, tp = head_pair(head)
    want = jri.convert_to_reference("FourierGrid", jcfg, jp)
    got = ri.convert_to_reference("FourierGrid", tcfg, tp)
    assert sorted(got["model_state_dict"]) == sorted(want["model_state_dict"])
    for k, v in want["model_state_dict"].items():
        np.testing.assert_array_equal(got["model_state_dict"][k].numpy(), v.numpy(), err_msg=k)
    assert sorted(got["model_kwargs"]) == sorted(want["model_kwargs"])
    buf = io.BytesIO()
    torch.save(want, buf)
    buf.seek(0)
    ref = torch.load(buf, weights_only=False)
    _, jcfg2, jp2, _ = jri.convert_reference_ckpt(ref)
    _, tcfg2, tp2, _ = ri.convert_reference_ckpt(ref, device="cpu")
    assert sorted(leaves(tp2)) == sorted(jax_leaves(jp2))
    for k, v in jax_leaves(jp2).items():
        np.testing.assert_array_equal(leaves(tp2)[k].detach().numpy(), np.asarray(v), err_msg=k)
    b = ray_batch()
    with torch.no_grad():
        r = fg.forward(tp2, tcfg2, *(torch.from_numpy(b[k]) for k in ("rays_o", "rays_d",
                                                                      "viewdirs")))
    jr = jax.jit(lambda p, *r: jfg.forward(p, jcfg2, *r))(
        jp2, *(jnp.asarray(b[k]) for k in ("rays_o", "rays_d", "viewdirs")))
    np.testing.assert_allclose(r.rgb_marched.numpy(), np.asarray(jr.rgb_marched), rtol=1e-4,
                               atol=1e-6)


def test_tar_drops_appearance_embeddings():
    """A reference checkpoint with ``img_embeddings.*`` (and ``img_emb_dim``,
    ``sample_num`` in its kwargs) imports without them, as the JAX import
    does; a model whose MLP reads embeddings is not exported."""
    jcfg, jp, tcfg, tp = head_pair("viewgrid")
    ref = jri.convert_to_reference("FourierGrid", jcfg, jp)
    ref["model_kwargs"].update(img_emb_dim=3, sample_num=5)
    ref["model_state_dict"]["img_embeddings.weight"] = torch.randn(5, 3)
    _, jcfg2, jp2, _ = jri.convert_reference_ckpt(ref)
    _, tcfg2, tp2, _ = ri.convert_reference_ckpt(ref, device="cpu")
    assert jp2.img_embeddings is None and tp2.img_embeddings is None
    assert tcfg2.img_emb_dim == jcfg2.img_emb_dim == -1 and tcfg2.sample_num == 5
    for k, v in jax_leaves(jp2).items():
        np.testing.assert_array_equal(leaves(tp2)[k].detach().numpy(), np.asarray(v), err_msg=k)
    _, _, _, with_emb = head_pair("embeddings")
    with pytest.raises(ValueError, match="appearance embeddings"):
        ri.convert_to_reference("FourierGrid", head_pair("embeddings")[2], with_emb)


@pytest.mark.parametrize("host", [False, True], ids=["device", "host_store"])
def test_run_train_feeds_each_rays_view(host):
    """``run_train`` with the embeddings, on the device sampler and on the
    host ray store: every batch hands the forward its rays' views, and the
    embeddings of the views trained on move."""
    data = synthetic.orbit_scene(4, 12, 12, seed=0, n_test=1)
    base = ExpConfig()
    fm = dataclasses.replace(
        base.fine_model_and_render, num_voxels_rgb=12**3, num_voxels_density=12**3,
        num_voxels_base_rgb=12**3, num_voxels_base_density=12**3, rgbnet_width=16,
        fourier_freq_num=1, img_emb_dim=3, maskout_near_cam_vox=False)
    ft = dataclasses.replace(base.fine_train, N_iters=3, N_rand=32, pg_scale=(),
                             lrate_img_embeddings=0.1, ray_sampler="flatten")
    cfg = dataclasses.replace(base, model="FourierGrid", fine_model_and_render=fm, fine_train=ft,
                              data=dataclasses.replace(base.data, load2gpu_on_the_fly=host),
                              coarse_train=dataclasses.replace(base.coarse_train, N_iters=0))
    seen = []
    real = fg.forward

    def spy(*a, **kw):
        seen.append(kw.get("img_index"))
        return real(*a, **kw)

    fg.forward = spy
    try:
        _, mcfg, params, _ = loop.run_train(cfg, data, device="cpu", log_fn=lambda _: None)
    finally:
        fg.forward = real
    n_train = len(data["i_train"])
    assert mcfg.sample_num == n_train and params.img_embeddings.shape == (n_train, 3)
    assert len(seen) == 3 and all(i is not None and i.shape == (32,) for i in seen)
    assert all(0 <= int(i.min()) and int(i.max()) < n_train for i in seen)
    init = fg.create(mcfg, torch.Generator().manual_seed(777))
    assert not torch.equal(params.img_embeddings, init.img_embeddings)
