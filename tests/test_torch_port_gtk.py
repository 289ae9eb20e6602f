"""The port's GTK analysis (``cli/gtk_analysis.py``) against the JAX
package's on the CPU.

The kernels, spectra, band sweep, test signals and generalisation surface
are the same numpy: equal to the bit. The regression runs in torch against
optax's Adam in JAX, both float32, the same update rounded in another
order: over 150 steps at lr 1 the predictions agree within 2e-5 and every
recorded loss within 1e-5 absolute plus 1e-4 relative (the largest gaps
seen: 3.8e-6 and 2.4e-6).
"""

import numpy as np
import pytest

from unboundednerfpytorch_tpu.cli import gtk_analysis as jgtk
from unboundednerfpytorch_tpu_torch.cli import gtk_analysis as gtk


def test_the_spectra_equal_jax():
    for fn, args in ((gtk.voxel_grid_jacobian, (40, 30)), (gtk.fourier_grid_jacobian, (20, 4, 30))):
        J = fn(*args)
        np.testing.assert_array_equal(J, getattr(jgtk, fn.__name__)(*args))
        K = gtk.gtk(J)
        np.testing.assert_array_equal(gtk.gtk_spectrum(K), jgtk.gtk_spectrum(K))
        np.testing.assert_array_equal(gtk.gtk_fourier_spectrum_row(K),
                                      jgtk.gtk_fourier_spectrum_row(K))
    np.testing.assert_array_equal(gtk.fg_spectrum_by_band_num(3), jgtk.fg_spectrum_by_band_num(3))
    assert [gtk._gamma(np.array([0.3]), i)[0] for i in range(6)] == \
        [jgtk._gamma(np.array([0.3]), i)[0] for i in range(6)]  # 2 ^ (i // 2): a XOR
    key = np.arange(4)
    np.testing.assert_array_equal(gtk.sample_random_powerlaw(key, 64, 1.5),
                                  jgtk.sample_random_powerlaw(key, 64, 1.5))
    np.testing.assert_array_equal(gtk.get_bessel_signal(28), jgtk.get_bessel_signal(28))
    K2 = gtk.gtk(gtk.voxel_grid_jacobian(10, 2)) + 1e-6 * np.eye(2)
    y1, y2 = np.meshgrid(np.linspace(-1, 1, 5), np.linspace(-1, 1, 5))
    np.testing.assert_array_equal(gtk.calculate_delta(K2, y1, y2),
                                  jgtk.calculate_delta(K2, y1, y2))


def test_the_regression_agrees_with_jax():
    want = jgtk.regression_experiment()
    got = gtk.regression_experiment(device="cpu")
    for k in ("x_test", "x_train", "signal", "y_train"):
        np.testing.assert_array_equal(got[k], want[k])
    for k in ("y_voxel", "y_fourier"):
        assert got[k].dtype == np.float32
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=2e-5)
    for k in ("hist_voxel", "hist_fourier"):
        assert len(got[k]) == 150
        np.testing.assert_allclose(np.array(got[k]), np.array(want[k]), rtol=1e-4, atol=1e-5)
    # the paper's point: FourierGrid fits the held-out signal better
    assert got["hist_fourier"][-1][1] < got["hist_voxel"][-1][1]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        gtk.regression_experiment(iterations=1)


def test_main_and_the_figures(tmp_path):
    pytest.importorskip("matplotlib")
    out = str(tmp_path / "gtk.npz")
    gtk.main(out, grid_len=20, band_num=4, n_points=30)
    jout = str(tmp_path / "jgtk.npz")
    jgtk.main(jout, grid_len=20, band_num=4, n_points=30)
    with np.load(out) as a, np.load(jout) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k])
    written = gtk.make_figures(str(tmp_path / "fig"), grid_len=5, freq_num=4, n_points=20,
                               device="cpu")
    assert [p.rsplit("/", 1)[1] for p in written] == ["vg_fg_gtk.jpg", "unbounded.jpg"]
    assert all((tmp_path / "fig" / p.rsplit("/", 1)[1]).stat().st_size > 0 for p in written)
