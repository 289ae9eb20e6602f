"""The port's adaptive render (``fourier_grid.render_rays_adaptive``)
against its two-stage cached forward and against the JAX package's.

The model is the JAX package's fixture (``tests/test_adaptive_render.py``:
32^3, two Fourier frequencies, seeded noise on the density, budgets of 48
samples and 16 colours), carried into the port. The adaptive render equals
the two-stage cached forward within 1e-5 absolute (the JAX package's gate
is 3e-5 + 1e-4 relative): the same samples reach the same march, a dead
ray's tail getting no weight either way. A sample whose transmittance after
phase A lies within rounding of the early exit could fall on the other side
in the two paths; such rays are counted and must be none here.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_adaptive_render import _model, _rays
from test_torch_port_sparse_probe import to_port
from unboundednerfpytorch_tpu.models import fourier_grid as jfg
from unboundednerfpytorch_tpu_torch.models import fourier_grid as fg
from unboundednerfpytorch_tpu_torch.ops import alpha as alpha_ops
from unboundednerfpytorch_tpu_torch.render import renderer

ATOL = 1e-5


def pair(opaque: bool = False):
    jp, jcfg = _model()
    if opaque:  # every ray saturates inside the first segment
        jp = jp.replace(density=jp.density.replace(grid=jp.density.grid + 6.0))
    tcfg, tp = to_port(jcfg, jp)
    tp.requires_grad_(False)
    return jcfg, jp, tcfg, tp


def rays(n, key):
    return [torch.from_numpy(np.array(x)) for x in _rays(n, key)]


def check_against_two_stage(tcfg, tp, ro, rd, vd, bg, seg):
    cache = fg.build_render_cache(tp, tcfg)
    assert cache.density_tables is not None
    report = {}
    with torch.no_grad():
        ref = fg.forward(tp, tcfg, ro, rd, vd, bg=bg, cache=cache)
        got = fg.render_rays_adaptive(tp, tcfg, cache, ro, rd, vd, bg=bg, seg=seg, report=report)
    for g, f in zip(got, ("rgb_marched", "depth", "alphainv_last")):
        np.testing.assert_allclose(g.numpy(), getattr(ref, f).numpy(), rtol=0, atol=ATOL,
                                   err_msg=f)
    return ref, got, report


def test_adaptive_matches_two_stage():
    """Equal to the two-stage cached forward, and that to the JAX package's;
    the live rays fit the bucket picked."""
    jcfg, jp, tcfg, tp = pair()
    ro, rd, vd = rays(64, 3)
    ref, _, report = check_against_two_stage(tcfg, tp, ro, rd, vd, 1.0, 16)
    assert 0 < report["alive"] <= report["bucket"] <= 64
    jref = jax.jit(lambda p, c, *r: jfg.forward(p, jcfg, *r, bg=1.0, cache=c))(
        jp, jfg.build_render_cache(jp, jcfg), *(jnp.asarray(x.numpy()) for x in (ro, rd, vd)))
    for f in ("rgb_marched", "depth", "alphainv_last"):
        np.testing.assert_allclose(getattr(ref, f).numpy(), np.asarray(getattr(jref, f)),
                                   rtol=1e-4, atol=ATOL, err_msg=f)


@pytest.mark.parametrize("seg", [8, 32])
def test_adaptive_exact_when_all_rays_die_early(seg):
    """An opaque scene: the smallest bucket, the same render; no ray's
    transmittance after phase A lies within rounding of the early exit."""
    _, _, tcfg, tp = pair(opaque=True)
    ro, rd, vd = rays(64, 9)
    ref, _, report = check_against_two_stage(tcfg, tp, ro, rd, vd, 0.0, seg)
    assert report["bucket"] == 64 // 16 and report["alive"] <= 4
    t_excl = torch.cumprod(1.0 - torch.where(ref.mask, ref.raw_alpha, 0.0), -1)[:, seg - 1]
    assert not bool((torch.abs(t_excl - alpha_ops.EARLY_EXIT_T) < 1e-7).any())


def test_adaptive_through_the_renderers_rays_fn():
    """A whole view through ``render_image``'s ``rays_fn`` equals the view
    rendered chunk by chunk through the two-stage cached forward."""
    _, _, tcfg, tp = pair()
    cache = fg.build_render_cache(tp, tcfg)
    K = np.array([[20.0, 0, 8], [0, 20.0, 6], [0, 0, 1]])
    c2w = np.array([[0, 0, -1, 1.8], [1, 0, 0, 0.1], [0, -1, 0, 0.2]], np.float64)
    fwd = lambda ro, rd, vd: fg.forward(tp, tcfg, ro, rd, vd, bg=1.0, cache=cache)
    adaptive = lambda ro, rd, vd: fg.render_rays_adaptive(tp, tcfg, cache, ro, rd, vd, bg=1.0,
                                                          seg=16)
    want = renderer.render_image(fwd, 12, 16, K, c2w, chunk=64, device="cpu")
    got = renderer.render_image(fwd, 12, 16, K, c2w, chunk=64, rays_fn=adaptive, device="cpu")
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=ATOL)


def test_adaptive_needs_the_two_stage_cache():
    _, _, tcfg, tp = pair()
    ro, rd, vd = rays(8, 1)
    single = fg.build_render_cache(tp, dataclasses.replace(tcfg, color_budget=0))
    with pytest.raises(ValueError, match="two-stage"):
        fg.render_rays_adaptive(tp, tcfg, single, ro, rd, vd)
    with pytest.raises(ValueError, match="seg"):
        fg.render_rays_adaptive(tp, tcfg, fg.build_render_cache(tp, tcfg), ro, rd, vd, seg=48)
