"""Grid-tangent-kernel (GTK) spectral analysis.

The port's copy of ``unboundednerfpytorch_tpu/cli/gtk_analysis.py``, the
theory tool behind the paper's figures: the tangent kernel J J^T of a 1-D
linearly interpolated VoxelGrid operator against the FourierGrid operator
(per-band embedded lookup, mean-reduced), its eigen-spectrum, its Fourier
spectrum and the band sweep, and a 1-D regression of each operator. The
kernels, spectra and test signals are numpy, as in the JAX package; the
regression (``_interp_1d``, :func:`voxel_grid_predict`,
:func:`fourier_grid_predict`, :func:`one_d_regress`) is torch, on the card
unless ``device="cpu"`` is given, with ``torch.optim.Adam`` (optax's Adam:
the same update). The reference's ``2 ^ (i // 2)``, a XOR where a power was
meant, is kept, so that the spectra are the paper's.

    python -m unboundednerfpytorch_tpu_torch.cli.gtk_analysis [--figures]
"""

from __future__ import annotations

import math

import numpy as np


def voxel_grid_jacobian(grid_len: int = 1000, n_points: int = 100) -> np.ndarray:
    """dy/dw for linear interpolation of points x=idx/n on a 1-D grid
    (run_gtk_analysis.py VoxelGrid.forward)."""
    xs = np.arange(n_points) / n_points
    J = np.zeros((n_points, grid_len))
    left = (xs * grid_len).astype(int)
    right = left + 1
    lw = np.abs(xs - right / grid_len) * grid_len
    rw = np.abs(xs - left / grid_len) * grid_len
    rows = np.arange(n_points)
    valid_l = left >= 0
    valid_r = right < grid_len
    J[rows[valid_l], left[valid_l]] = lw[valid_l]
    J[rows[valid_r], right[valid_r]] = rw[valid_r]
    return J


def _gamma(x: np.ndarray, i: int) -> np.ndarray:
    """Per-band fourier embedding to [0, 1] (reference gamma_x_i; note the
    reference uses python `2^(i//2)` == XOR — reproduced faithfully so the
    spectra match the paper figures)."""
    f = 2 ^ (i // 2)  # XOR, as in the reference
    raw = np.sin(f * np.pi * x) if i % 2 == 0 else np.cos(f * np.pi * x)
    return (raw + 1) / 2


def fourier_grid_jacobian(
    grid_len: int = 1000, band_num: int = 10, n_points: int = 100
) -> np.ndarray:
    """dy/dw for the FourierGrid operator: each band b interpolates at the
    embedded coordinate gamma_b(x) into its own grid bank."""
    xs = np.arange(n_points) / n_points
    J = np.zeros((n_points, grid_len * band_num))
    rows = np.arange(n_points)
    for b in range(band_num):
        g = _gamma(xs, b)
        # clamp the boundary case g == 1.0 (the reference would index past the
        # bank into the next one — a silent bug we do not reproduce)
        left = np.minimum((g * grid_len).astype(int), grid_len - 1)
        right = left + 1
        lw = np.abs(g - right / grid_len) * grid_len
        rw = np.abs(g - left / grid_len) * grid_len
        valid_l = left > 0
        valid_r = right < grid_len
        J[rows[valid_l], grid_len * b + left[valid_l]] = lw[valid_l]
        J[rows[valid_r], grid_len * b + right[valid_r]] = rw[valid_r]
    return J


def gtk(jacobian: np.ndarray) -> np.ndarray:
    return jacobian @ jacobian.T


def gtk_spectrum(kernel: np.ndarray) -> np.ndarray:
    """Sorted (descending) eigenvalues of the tangent kernel."""
    ev = np.linalg.eigvalsh(kernel)
    return ev[::-1]


# ---------------------------------------------------------------------------
# 1-D regression comparison (the paper's convergence experiment)
# ---------------------------------------------------------------------------

def _interp_1d(voxel, x, interval_num: int):
    import torch

    left = torch.clamp((x * interval_num).to(torch.int64), 0, interval_num - 1)
    right = left + 1
    lw = torch.abs(x - right / interval_num) * interval_num
    rw = torch.abs(x - left / interval_num) * interval_num
    return voxel[left] * lw + voxel[right] * rw


def voxel_grid_predict(voxel, x):
    import torch

    return torch.sigmoid(_interp_1d(voxel, x, voxel.shape[0] - 1))


def fourier_grid_predict(voxel, x, grid_len: int, band_num: int):
    import torch

    acc = 0.0
    for b in range(band_num):
        f = 2 ^ (b // 2)  # XOR, as in the reference
        raw = torch.sin(f * math.pi * x) if b % 2 == 0 else torch.cos(f * math.pi * x)
        g = (raw + 1) / 2
        acc = acc + _interp_1d(voxel[grid_len * b:grid_len * (b + 1)], g, grid_len - 1)
    return torch.sigmoid(acc / band_num)


def one_d_regress(predict_fn, voxel0, x_train, y_train, x_test, y_test, lr: float = 1e-2,
                  iterations: int = 150, device=None):
    """Adam regression of a 1-D signal on ``device`` (None -> ``cuda``);
    returns (final voxel, [(train loss, test loss after the step)] a step),
    the reference's train_model loop."""
    import torch

    from unboundednerfpytorch_tpu_torch.device import resolve_device

    dev = resolve_device(device)
    as_t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)  # noqa: E731
    voxel = torch.nn.Parameter(torch.as_tensor(voxel0, dtype=torch.float32, device=dev).clone())
    x_train, y_train, x_test, y_test = map(as_t, (x_train, y_train, x_test, y_test))
    opt = torch.optim.Adam([voxel], lr=lr, betas=(0.9, 0.999), eps=1e-8)
    hist = []
    for _ in range(iterations):
        opt.zero_grad(set_to_none=True)
        loss = torch.sum((predict_fn(voxel, x_train) - y_train) ** 2)
        loss.backward()
        opt.step()
        with torch.no_grad():
            test_loss = torch.mean((predict_fn(voxel, x_test) - y_test) ** 2)
        hist.append((float(loss.detach()), float(test_loss)))
    return voxel.detach(), hist


# ---------------------------------------------------------------------------
# Fourier spectrum of the kernel + band sweep (run_gtk_analysis.py:184-260)
# ---------------------------------------------------------------------------

def _gaussian_filter1d(x: np.ndarray, sigma: float = 2.0) -> np.ndarray:
    r = int(4 * sigma + 0.5)
    t = np.arange(-r, r + 1)
    k = np.exp(-0.5 * (t / sigma) ** 2)
    k /= k.sum()
    return np.convolve(np.pad(x, r, mode="wrap"), k, mode="valid")


def gtk_fourier_spectrum_row(kernel: np.ndarray, sigma: float = 2.0) -> np.ndarray:
    """fftshift(log10 |fft|) of the kernel's first row, 10**(.), smoothed —
    the `fplot` + gaussian_filter1d plotting transform (:188-189, :241-243)."""
    row = np.fft.fftshift(np.log10(np.abs(np.fft.fft(kernel)) + 1e-12))[0]
    return _gaussian_filter1d(10.0 ** row, sigma=sigma)


def fg_spectrum_by_band_num(band_num: int, grid_len: int = 10,
                            n_points: int = 100) -> np.ndarray:
    """FourierGrid GTK spectrum at 2*band_num bands (the reference's l-sweep,
    get_fg_gtk_spectrum_by_band_num, :184-190)."""
    J = fourier_grid_jacobian(grid_len, band_num * 2, n_points)
    return gtk_fourier_spectrum_row(gtk(J))


# ---------------------------------------------------------------------------
# Test signals for the 1-D regression experiment (:263-306)
# ---------------------------------------------------------------------------

def sample_random_signal(key: np.ndarray, decay_vec: np.ndarray) -> np.ndarray:
    rng = np.random.default_rng(int(np.sum(key)))
    raw = rng.normal(size=[decay_vec.shape[0], 2]) @ np.array([1, 1j])
    return np.real(np.fft.ifft(raw * decay_vec))


def sample_random_powerlaw(key, n: int, power: float) -> np.ndarray:
    coords = np.float32(
        np.fft.ifftshift(1 + n // 2 - np.abs(np.fft.fftshift(np.arange(n)) - n // 2))
    )
    decay_vec = coords ** (-power)
    decay_vec = np.array(decay_vec)
    decay_vec[n // 4 :] = 0
    return sample_random_signal(key, decay_vec)


def get_sine_signal(n: int) -> np.ndarray:
    return np.sin(np.arange(n) / n * 2 * np.pi)


def get_bessel_signal(n: int) -> np.ndarray:
    """First-kind Bessel J1(x/4) — the reference's regression target (:284-286)."""
    from scipy.special import jv

    return jv(1, np.arange(n) / 4)


# ---------------------------------------------------------------------------
# Generalization-bound surface (:333-353): Delta = y^T K^-1 y per 2-pt batch
# ---------------------------------------------------------------------------

def calculate_delta(kernel: np.ndarray, y1: np.ndarray, y2: np.ndarray) -> np.ndarray:
    """Batched y^T K^{-1} y for 2-point label pairs (calculate_Delta)."""
    ys = np.stack([np.ravel(y1), np.ravel(y2)], axis=-1)  # [B, 2]
    kinv = np.linalg.inv(kernel)
    return np.einsum("bi,ij,bj->b", ys, kinv, ys)


def regression_experiment(grid_len: int = 10, band_num: int = 3, train_num: int = 7,
                          sample_interval: int = 4, iterations: int = 150, lr: float = 1.0,
                          seed: int = 0, device=None):
    """The paper's 1-D Bessel regression on ``device`` (None -> ``cuda``):
    VoxelGrid (grid_len*band_num params) against FourierGrid (grid_len x
    band_num banks), the same budget."""
    import torch

    from unboundednerfpytorch_tpu_torch.device import resolve_device

    dev = resolve_device(device)
    n = train_num * sample_interval
    x_test = np.float32(np.linspace(0, 1.0, n, endpoint=False))
    x_train = x_test[::sample_interval]
    signal = get_bessel_signal(n)
    signal = (signal - signal.min()) / (signal.max() - signal.min())
    y_train = signal[::sample_interval]

    rng = np.random.default_rng(seed)
    v0 = np.asarray(rng.random(grid_len * band_num), np.float32)
    f0 = np.asarray(rng.random(grid_len * band_num), np.float32)

    v_final, v_hist = one_d_regress(voxel_grid_predict, v0, x_train, y_train, x_test, signal,
                                    lr=lr, iterations=iterations, device=dev)
    fg_pred = lambda v, x: fourier_grid_predict(v, x, grid_len, band_num)  # noqa: E731
    f_final, f_hist = one_d_regress(fg_pred, f0, x_train, y_train, x_test, signal, lr=lr,
                                    iterations=iterations, device=dev)
    xt = torch.as_tensor(x_test, device=dev)
    with torch.no_grad():
        y_voxel = voxel_grid_predict(v_final, xt).cpu().numpy()
        y_fourier = fg_pred(f_final, xt).cpu().numpy()
    return {
        "x_test": x_test,
        "x_train": x_train,
        "signal": signal,
        "y_train": y_train,
        "y_voxel": y_voxel,
        "y_fourier": y_fourier,
        "hist_voxel": v_hist,
        "hist_fourier": f_hist,
    }


def make_figures(out_dir: str = "figures", grid_len: int = 10,
                 freq_num: int = 10, n_points: int = 100, device=None) -> list[str]:
    """The two paper figures (vg_fg_gtk + unbounded), matplotlib Agg:
    (a) VoxelGrid GTK, (b) FourierGrid GTK, (c) spectrum band sweep,
    (d) 1-D regression; then the generalization-bound difference heatmap."""
    import os

    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    os.makedirs(out_dir, exist_ok=True)
    written = []

    Kv = gtk(voxel_grid_jacobian(grid_len * freq_num, n_points))
    Kf = gtk(fourier_grid_jacobian(grid_len, freq_num, n_points))
    norm = lambda a: (a - a.min()) / (a.max() - a.min() + 1e-12)

    fig, axes = plt.subplots(2, 2, constrained_layout=True, figsize=(6, 6))
    axes[0, 0].imshow(norm(Kv))
    axes[0, 0].set_title("(a) VoxelGrid GTK")
    axes[0, 1].imshow(norm(Kf))
    axes[0, 1].set_title("(b) FourierGrid GTK")
    ax = axes[1, 0]
    vg_plot = gtk_fourier_spectrum_row(Kv)
    ax.semilogy(np.append(vg_plot, vg_plot[0]), label="VoxelGrid")
    for l in (1, 5, 10):
        p = fg_spectrum_by_band_num(l, grid_len, n_points)
        ax.semilogy(np.append(p, p[0]), label=f"FourierGrid (l={l})")
    ax.legend(fontsize=6)
    ax.set_title("(c) GTK Fourier Spectrum")
    reg = regression_experiment(grid_len=grid_len, band_num=3, device=device)
    ax = axes[1, 1]
    ax.plot(reg["x_test"], reg["signal"], "k", label="Target signal")
    ax.scatter(reg["x_train"], reg["y_train"], edgecolors="k", color="w",
               label="Training points", zorder=2)
    ax.plot(reg["x_test"], reg["y_voxel"], label="Learned by VoxelGrid")
    ax.plot(reg["x_test"], reg["y_fourier"], label="Learned by FourierGrid")
    ax.legend(fontsize=6)
    ax.set_title("(d) 1D Regression")
    p1 = os.path.join(out_dir, "vg_fg_gtk.jpg")
    fig.savefig(p1, dpi=150)
    plt.close(fig)
    written.append(p1)

    # generalization-bound difference (figure 2, :343-396)
    Kv2 = gtk(voxel_grid_jacobian(grid_len, n_points=2))
    Kf2 = gtk(fourier_grid_jacobian(grid_len, freq_num, n_points=2))
    y = np.linspace(-1, 1, 121)
    y1, y2 = np.meshgrid(y, y)
    dv = calculate_delta(Kv2 + 1e-6 * np.eye(2), y1, y2).reshape(y1.shape)
    df = calculate_delta(Kf2 + 1e-6 * np.eye(2), y1, y2).reshape(y1.shape)
    dv /= np.abs(dv).max() + 1e-12
    df /= np.abs(df).max() + 1e-12
    fig, ax = plt.subplots(constrained_layout=True, figsize=(4, 3))
    im = ax.pcolor(dv - df, cmap="coolwarm")
    fig.colorbar(im)
    ax.set_title("Generalization Bound Diff.")
    p2 = os.path.join(out_dir, "unbounded.jpg")
    fig.savefig(p2, dpi=150)
    plt.close(fig)
    written.append(p2)
    return written


def main(out_path: str = "gtk_analysis.npz", grid_len: int = 100,
         band_num: int = 10, n_points: int = 100, figures: bool = False, device=None):
    """Compute both GTKs and their spectra and save them for plotting; with
    ``figures``, also the paper's two figures (their regression on
    ``device``, None -> ``cuda``)."""
    Jv = voxel_grid_jacobian(grid_len, n_points)
    Jf = fourier_grid_jacobian(grid_len, band_num, n_points)
    Kv, Kf = gtk(Jv), gtk(Jf)
    np.savez_compressed(
        out_path,
        gtk_voxel=Kv,
        gtk_fourier=Kf,
        spectrum_voxel=gtk_spectrum(Kv),
        spectrum_fourier=gtk_spectrum(Kf),
        fourier_spectrum_voxel=gtk_fourier_spectrum_row(Kv),
        fourier_spectrum_fourier=gtk_fourier_spectrum_row(Kf),
    )
    print(f"GTK analysis written to {out_path}")
    if figures:
        for p in make_figures(device=device):
            print(f"figure written to {p}")


if __name__ == "__main__":
    import sys

    main(figures="--figures" in sys.argv)
