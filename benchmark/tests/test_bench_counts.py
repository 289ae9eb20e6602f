"""The counting functions on shapes worked by hand."""

from __future__ import annotations

import math

import pytest
import torch
import bench_tiny  # noqa: F401  (puts the repository on the path)

from benchmark.counts import model, ops, peaks


def test_march_forward_reads_each_ray_up_to_its_early_exit():
    # ray 0: alpha 0.99 then 0.95, so T enters the second at 1e-2
    # (processed) and the third at 5e-4 (not); ray 1: four clear samples,
    # its second masked off
    alpha = torch.tensor([[0.99, 0.95, 0.5, 0.5], [0.1, 0.0, 0.1, 0.1]])
    mask = torch.tensor([[True, True, True, True], [True, False, True, True]])
    density = torch.zeros(2, 4)
    nbytes, flops = ops.march_forward(density, mask, alpha, residuals=True)
    processed = 2 + 4
    live = 2 + 3
    out = 2 * 4 * 4 * 3 + 2 * 4  # weights, alpha, t_excl; alphainv_last
    assert int(nbytes) == processed * 1 + live * 4 + out
    assert int(flops) == live * ops.MARCH_FORWARD_FLOPS
    nbytes, _ = ops.march_forward(density, mask, alpha, residuals=False)
    assert int(nbytes) == processed + live * 4 + 2 * 4 * 4 * 2 + 2 * 4


def test_march_backward_counts_the_processed_samples():
    t_excl = torch.tensor([[1.0, 0.5, 1e-4], [1.0, 1.0, 1.0]])
    mask = torch.tensor([[True, True, True], [False, True, True]])
    z = torch.zeros(2, 3)
    nbytes, flops = ops.march_backward(z, t_excl, z, z, mask)
    processed, live = 2 + 3, 2 + 2
    assert int(nbytes) == processed * 5 + live * 12 + 2 * 8 + 2 * 3 * 4
    assert int(flops) == live * ops.MARCH_BACKWARD_FLOPS


def test_tv_dense_reads_grid_and_gradient_and_writes_the_gradient():
    p = torch.zeros((7, 4, 5, 6, 12), dtype=torch.bfloat16)
    g = torch.zeros_like(p)
    g[0, 0, 0, 0, 0] = 1.0
    n = 7 * 4 * 5 * 6 * 12
    assert [int(x) for x in ops.tv_add_grad(p, g, dense=True)] == [n * 6, n * ops.TV_FLOPS]
    assert [int(x) for x in ops.tv_add_grad(p, g, dense=False)] == [n * 2 + 4, ops.TV_FLOPS]


def test_masked_adam_touches_only_the_elements_with_a_gradient():
    p = torch.zeros(10, dtype=torch.bfloat16)
    m, v = torch.zeros(10), torch.zeros(10)
    g = torch.zeros(10, dtype=torch.bfloat16)
    g[:3] = 1.0
    nbytes, flops = ops.masked_adam(p, m, v, g, skip_zero_grad=True, per_lr=None)
    assert int(nbytes) == 10 * 2 + 3 * 2 * (2 + 4 + 4)
    assert int(flops) == 3 * ops.ADAM_FLOPS
    nbytes, _ = ops.masked_adam(p, m, v, g, skip_zero_grad=False, per_lr=None)
    assert int(nbytes) == 10 * 2 + 10 * 2 * 10


def test_cumdist_and_the_least_time():
    nbytes, flops = ops.cumdist_thres(torch.zeros(4, 1063))
    assert int(nbytes) == 4 * 1063 * 5 and int(flops) == 4 * 1063 * 2
    assert peaks.least_seconds(3.35e12, 0) == pytest.approx(1.0)
    assert peaks.least_seconds(0, 67e12) == pytest.approx(1.0)
    assert peaks.least_seconds(3.35e12, 134e12) == pytest.approx(2.0)


def test_model_flops_of_a_step_and_a_view():
    dims = ((39, 128), (128, 128), (128, 3))
    assert model.mlp_flops(dims) == 2 * (39 * 128 + 128 * 128 + 128 * 3)
    # 10 samples need density from 7 banks, 4 of them are coloured
    fwd = model.forward_flops(10, 4, 7, 7, 12, dims)
    assert fwd == 16 * 10 * 7 + 16 * 4 * 7 * 12 + 4 * model.mlp_flops(dims)
    assert model.step_flops(10, 4, 7, 7, 12, dims) == 3 * fwd
    assert math.isclose(model.forward_flops(1, 0, 1, 1, 12, dims), 16)
