"""The port's hierarchical occupancy probe and ``suggest_budgets`` against
the JAX package's (``unboundednerfpytorch_tpu/models/fourier_grid.py``).

The scenes are the JAX package's own sparse fixtures
(``tests/test_sparse_probe.py``: a few density blobs in a 32^3 two-frequency
model, the occupancy cache refreshed from them), carried into the port with
``convert.tree_from_params_object``. Selections are compared as integers,
exactly; the renders within 1e-6 absolute (float32, the same samples in the
same order). Also held here: the three faults of the JAX ``--auto_budget``
path that the port does not reproduce (every probe ray is taken, the
default coarse stride is a multiple of twice the probe stride, the
full-march forward reads a single-stage render cache).
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_sparse_probe import _rays, _sparse_model
from unboundednerfpytorch_tpu.models import fourier_grid as jfg
from unboundednerfpytorch_tpu_torch import convert, render
from unboundednerfpytorch_tpu_torch.models import fourier_grid as fg


def to_port(jcfg, jp):
    """The port's (config, params) of a JAX FourierGrid model, on the CPU."""
    cfg = fg.FourierGridConfig(**{f.name: getattr(jcfg, f.name)
                                  for f in dataclasses.fields(fg.FourierGridConfig)})
    return cfg, convert.fourier_grid_params_from_numpy(convert.tree_from_params_object(jp), "cpu")


def as_torch(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


@functools.lru_cache(maxsize=None)
def sparse_pair(seed=0, n_bumps=3):
    """(JAX config, JAX params, port config, port params) of the JAX
    package's sparse fixture; the port's params are not to be changed."""
    jcfg, jp = _sparse_model(seed=seed, n_bumps=n_bumps)
    return (jcfg, jp, *to_port(jcfg, jp))


# probe rays of seed 6's scene: two chunks of 512 and a tail of 188
PROBE_RAYS, PROBE_CHUNK = 1212, 512


@functools.lru_cache(maxsize=None)
def jax_budgets():
    """The JAX ``suggest_budgets`` on the probe rays (one compile a process):
    it takes the first 1024 and drops the tail."""
    jcfg, jp, _, _ = sparse_pair(seed=6)
    return jfg.suggest_budgets(jp, jcfg, *_rays(PROBE_RAYS, seed=7), chunk=PROBE_CHUNK)


@functools.lru_cache(maxsize=None)
def port_budgets(n: int = 1024):
    """The port's ``suggest_budgets`` on the first ``n`` probe rays."""
    _, _, tcfg, tp = sparse_pair(seed=6)
    rays = (x[:n] for x in as_torch(*_rays(PROBE_RAYS, seed=7)))
    return fg.suggest_budgets(tp, tcfg, *rays, chunk=PROBE_CHUNK)


@functools.partial(jax.jit, static_argnums=(1,))
def _jax_select(jp, jc, ro, rd):
    pts, _, t = jfg.sample_ray(jc, ro, rd)
    return jfg.budget_select(jp, jc, pts, ro, rd, t)


def select_both(jcfg, jp, tcfg, tp, ro, rd, **knobs):
    """(JAX (sel, mask), port (sel, mask)) as numpy, for the config with
    ``knobs``."""
    jc, tc = dataclasses.replace(jcfg, **knobs), dataclasses.replace(tcfg, **knobs)
    want = _jax_select(jp, jc, ro, rd)
    tro, trd = as_torch(ro, rd)
    tpts, _, tt = fg.sample_ray(tc, tro, trd)
    got = fg.budget_select(tp, tc, tpts, tro, trd, tt)
    return [np.asarray(x) for x in want], [x.numpy() for x in got]


def test_hierarchical_probe_matches_flat():
    """With a candidate group for every group, the port's hierarchical
    selection is its flat probe's exactly, and so is the forward; both equal
    the JAX package's selections integer for integer, with ample candidates
    and with the automatic count."""
    jcfg, jp, tcfg, tp = sparse_pair(seed=6)
    assert float(tp.mask_cache.mask.float().mean()) < 0.45
    ro, rd, vd = _rays(128)
    S = 2 * tcfg.n_inner
    ample = dict(probe_coarse_stride=8, probe_candidate_groups=-(-S // 8))
    (jsel_f, jm_f), (sel_f, m_f) = select_both(jcfg, jp, tcfg, tp, ro, rd)
    (jsel_h, jm_h), (sel_h, m_h) = select_both(jcfg, jp, tcfg, tp, ro, rd, **ample)
    np.testing.assert_array_equal(sel_h, sel_f)
    np.testing.assert_array_equal(m_h, m_f)
    assert 0 < m_f.sum() < m_f.size
    for got, want in ((sel_f, jsel_f), (m_f, jm_f), (sel_h, jsel_h), (m_h, jm_h)):
        np.testing.assert_array_equal(got, want)
    (jsel_a, jm_a), (sel_a, m_a) = select_both(jcfg, jp, tcfg, tp, ro, rd,
                                               probe_coarse_stride=8)
    np.testing.assert_array_equal(sel_a, jsel_a)
    np.testing.assert_array_equal(m_a, jm_a)

    tro, trd, tvd = as_torch(ro, rd, vd)
    with torch.no_grad():
        res_f = fg.forward(tp, tcfg, tro, trd, tvd, bg=1.0)
        res_h = fg.forward(tp, dataclasses.replace(tcfg, **ample), tro, trd, tvd, bg=1.0)
    assert torch.equal(res_h.t, res_f.t) and torch.equal(res_h.mask, res_f.mask)
    np.testing.assert_allclose(res_h.rgb_marched.numpy(), res_f.rgb_marched.numpy(), atol=1e-6)
    np.testing.assert_allclose(res_h.depth.numpy(), res_f.depth.numpy(), atol=1e-6)


def test_candidate_truncation_drops_far_tail_only():
    """Two candidate groups a ray: each ray's selection is a prefix of the
    flat one (its far tail dropped), and the JAX package's integer for
    integer."""
    jcfg, jp, tcfg, tp = sparse_pair(seed=6)
    ro, rd, _ = _rays(128, seed=5)
    _, (sel_f, m_f) = select_both(jcfg, jp, tcfg, tp, ro, rd)
    (jsel, jm), (sel_h, m_h) = select_both(jcfg, jp, tcfg, tp, ro, rd, probe_coarse_stride=8,
                                           probe_candidate_groups=2)
    np.testing.assert_array_equal(sel_h, jsel)
    np.testing.assert_array_equal(m_h, jm)
    truncated = 0
    for i in range(sel_f.shape[0]):
        a, b = sel_f[i][m_f[i]], sel_h[i][m_h[i]]
        assert b.size <= a.size
        np.testing.assert_array_equal(b, a[:b.size])
        truncated += b.size < a.size
    assert truncated > 0


def test_coarse_occupancy_matches_jax():
    """The block max-pool over a lattice that is no multiple of the block,
    then the dilation: equal to the JAX ``_coarse_occupancy``."""
    mask = np.random.default_rng(3).random((21, 18, 23)) < 0.03
    for p, window in ((4, 5), (2, 3), (3, 7)):
        want = np.asarray(jfg._coarse_occupancy(jnp.asarray(mask), p, window))
        got = fg._coarse_occupancy(torch.from_numpy(mask), p, window).numpy()
        np.testing.assert_array_equal(got, want)


def test_suggest_budgets_matches_jax():
    """1024 probe rays (a multiple of the chunk: the JAX function takes those
    of the probe set) and the probe stride 2 (which divides 8): the same
    budget dict as the JAX package's."""
    assert port_budgets() == jax_budgets()


def test_suggest_budgets_reproduces_full_march():
    """The port's budgets, with the hierarchical probe, render held-out rays
    as the full march does: PSNR over 45 dB (the JAX package's gate)."""
    _, _, tcfg, tp = sparse_pair(seed=6)
    rec = port_budgets()
    S = 2 * tcfg.n_inner
    assert 16 <= rec["sample_budget"] <= S and 8 <= rec["color_budget"] <= rec["sample_budget"]
    ro, rd, vd = as_torch(*_rays(256, seed=8))
    cfg_b = dataclasses.replace(tcfg, sample_budget=rec["sample_budget"], probe_coarse_stride=8)
    with torch.no_grad():
        full = fg.forward(tp, dataclasses.replace(tcfg, sample_budget=0), ro, rd, vd, bg=1.0)
        budgeted = fg.forward(tp, cfg_b, ro, rd, vd, bg=1.0)
    mse = float(torch.mean((full.rgb_marched - budgeted.rgb_marched) ** 2))
    assert -10 * np.log10(max(mse, 1e-12)) > 45.0


def test_suggest_budgets_takes_every_ray():
    """Not reproduced: the JAX loop over chunks drops the last ``n % chunk``
    rays and raises with fewer than ``chunk``; the port takes every ray."""
    jcfg, jp, tcfg, tp = sparse_pair(seed=6)
    assert jax_budgets()["n_rays"] == 1024
    ro, rd, vd = _rays(PROBE_RAYS, seed=7)
    with pytest.raises(ValueError):
        jfg.suggest_budgets(jp, jcfg, ro[:100], rd[:100], vd[:100], chunk=PROBE_CHUNK)
    assert port_budgets(PROBE_RAYS)["n_rays"] == PROBE_RAYS
    rays = as_torch(ro[:100], rd[:100], vd[:100])
    few = fg.suggest_budgets(tp, tcfg, *rays, chunk=PROBE_CHUNK)
    assert few == fg.suggest_budgets(tp, tcfg, *rays, chunk=50) and few["n_rays"] == 100


def test_default_coarse_stride_is_an_even_multiple_of_the_probe_stride():
    """Not reproduced: with ``budget_probe_stride`` 3 the JAX function
    proposes the coarse stride 8, which its own ``budget_select`` refuses;
    the port rounds it up to 12, which the probe takes."""
    jcfg, jp, tcfg, tp = sparse_pair(seed=6)
    jcfg, tcfg = (dataclasses.replace(c, budget_probe_stride=3) for c in (jcfg, tcfg))
    ro, rd, vd = _rays(64, seed=9)
    want = jfg.suggest_budgets(jp, jcfg, ro, rd, vd, chunk=64)
    got = fg.suggest_budgets(tp, tcfg, *as_torch(ro, rd, vd), chunk=64)
    assert (want["probe_coarse_stride"], got["probe_coarse_stride"]) == (8, 12)
    with pytest.raises(AssertionError, match="even multiple"):
        select_both(jcfg, jp, tcfg, tp, ro, rd, probe_coarse_stride=8)
    tro, trd = as_torch(ro, rd)
    tc = dataclasses.replace(tcfg, probe_coarse_stride=got["probe_coarse_stride"])
    pts, _, t = fg.sample_ray(tc, tro, trd)
    sel, mask = fg.budget_select(tp, tc, pts, tro, trd, t)
    assert sel.shape == (64, tcfg.sample_budget) and bool(mask.any())


def test_auto_budget_reads_the_full_march_cache(monkeypatch):
    """Not reproduced: the JAX ``--auto_budget`` branch calls
    ``suggest_budgets`` without a render cache; the port's builds the
    single-stage cache first, as the function's docstring asks, and enables
    the hierarchical probe on a sparse mask (occupancy under 0.45)."""
    _, _, tcfg, tp = sparse_pair(seed=6)
    seen = []
    real = fg.suggest_budgets
    monkeypatch.setattr(fg, "suggest_budgets",
                        lambda *a, **kw: seen.append(kw.get("cache")) or real(*a, **kw))
    K = np.array([[14.0, 0, 8], [0, 14.0, 8], [0, 0, 1]])
    poses = []
    for th in np.linspace(0, 2 * np.pi, 5)[:4]:
        eye = np.array([2.6 * np.cos(th), 2.6 * np.sin(th), 0.3])
        fwd = -eye / np.linalg.norm(eye)
        right = np.cross(fwd, [0.0, 0.0, 1.0])
        right /= np.linalg.norm(right)
        up = np.cross(right, fwd)
        poses.append(np.concatenate([np.stack([right, up, -fwd, eye], 1), [[0, 0, 0, 1]]]))
    data = {"i_train": np.arange(4), "HW": np.full((4, 2), 16), "Ks": np.stack([K] * 4),
            "poses": np.stack(poses)}
    flags = dict(ndc=False, inverse_y=False, flip_x=False, flip_y=False)
    mcfg, rec = render.auto_budgets(tp, dataclasses.replace(tcfg, color_budget=8), data,
                                    flags, "cpu", log_fn=lambda _: None)
    assert len(seen) == 1 and isinstance(seen[0], fg.RenderCache)
    assert seen[0].tables is not None and seen[0].density_tables is None
    assert rec["n_rays"] == 4 * 16 * 16 and rec["hierarchical"]
    assert (mcfg.sample_budget, mcfg.color_budget, mcfg.probe_coarse_stride) == (
        rec["sample_budget"], rec["color_budget"], 8)
