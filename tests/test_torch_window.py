"""The port's `window/` (window, metadata, analyze) against the JAX
package on the CPU.

The design is the same host float64 NumPy code in both packages, so
coefficients, ENBW, metadata and analysis are held equal bit for bit.
`apply` multiplies in the input's type: equal to the JAX product in
float32 and float64 (one rounding of the same two operands), and
`tests/test_window.py`'s rtol 1e-6 against the float64 window in
float32.
"""

import tests.torch_port_setup  # noqa: F401  (first: one PyTorch thread)

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from algodsp_tpu import window as jwin
from algodsp_tpu_torch import window
from algodsp_tpu_torch.window import Slope, WindowType

_PARAMS = [
    {},
    {"periodic": True},
    {"alpha": 3.0},
    {"alpha": 0.4, "slope": "LEFT"},
    {"alpha": 0.0, "slope": "RIGHT", "invert": True},
    {"dc_removal": True, "bartlett": True},
    {"custom_coeffs": (0.5, -0.3, 0.2)},
]


def _jkw(kw):
    kw = dict(kw)
    if "slope" in kw:
        kw["slope"] = jwin.Slope[kw["slope"]]
    return kw


def _tkw(kw):
    kw = dict(kw)
    if "slope" in kw:
        kw["slope"] = Slope[kw["slope"]]
    return kw


@pytest.mark.parametrize("kw", _PARAMS, ids=lambda kw: ",".join(kw) or "default")
def test_generate_equals_jax_for_every_type(kw):
    for wt in WindowType:
        for n in (0, 1, 2, 31, 64):
            ref = jwin.generate(jwin.WindowType[wt.name], n, **_jkw(kw))
            got = window.generate(wt, n, **_tkw(kw))
            np.testing.assert_array_equal(got, ref, err_msg=f"{wt} {n}")
    assert window.generate(WindowType.HANN, 8, dtype=np.float32).dtype == np.float32


def test_window_tensor_made_once_per_type_and_device():
    a = window.window.window_tensor(WindowType.KAISER, 100, torch.float32, "cpu", alpha=5.0)
    b = window.window.window_tensor(WindowType.KAISER, 100, torch.float32, "cpu", alpha=5.0)
    assert a is b
    c = window.window.window_tensor(WindowType.KAISER, 100, torch.float64, "cpu", alpha=5.0)
    np.testing.assert_array_equal(
        c.numpy(), jwin.generate(jwin.WindowType.KAISER, 100, alpha=5.0))
    np.testing.assert_array_equal(
        a.numpy(), jwin.generate(jwin.WindowType.KAISER, 100, alpha=5.0,
                                 dtype=np.float32))


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_apply_equals_jax(dtype):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 2, 96)).astype(dtype)
    for wt, kw in ((WindowType.HANN, {}), (WindowType.TUKEY, {"alpha": 0.3}),
                   (WindowType.FLAT_TOP, {"periodic": True})):
        ref = np.asarray(jwin.apply(jnp.asarray(x), jwin.WindowType[wt.name], **kw))
        got = window.apply(torch.as_tensor(x), wt, **kw)
        assert got.dtype == getattr(torch, dtype)
        np.testing.assert_array_equal(got.numpy(), ref)
        w64 = jwin.generate(jwin.WindowType[wt.name], 96, **kw)
        np.testing.assert_allclose(got.numpy(), x * w64, rtol=1e-6, atol=1e-12)
    coeffs = rng.standard_normal(96)
    np.testing.assert_array_equal(
        window.apply_coefficients(torch.as_tensor(x), coeffs).numpy(),
        np.asarray(jwin.apply_coefficients(jnp.asarray(x), coeffs)))
    with pytest.raises(ValueError, match="length mismatch"):
        window.apply_coefficients(torch.as_tensor(x), coeffs[:10])


def test_enbw_metadata_and_analysis_equal_jax():
    for wt in WindowType:
        got = dataclasses.astuple(window.info(wt))
        ref = dataclasses.astuple(jwin.info(jwin.WindowType[wt.name]))
        assert got[0] == ref[0]
        np.testing.assert_array_equal(got[1:], ref[1:])
    for wt, kw in ((WindowType.HANN, {}), (WindowType.RECTANGULAR, {}),
                   (WindowType.KAISER, {"alpha": 8.0}),
                   (WindowType.BLACKMAN_HARRIS_4TERM, {"periodic": True})):
        w = window.generate(wt, 128, **kw)
        assert window.equivalent_noise_bandwidth(w) == \
            jwin.equivalent_noise_bandwidth(w)
        assert window.equivalent_noise_bandwidth(torch.tensor(w)) == \
            jwin.equivalent_noise_bandwidth(w)
        assert dataclasses.astuple(window.analyze(torch.tensor(w))) == \
            dataclasses.astuple(jwin.analyze(w))
    assert dataclasses.astuple(window.analyze(np.zeros(0))) == \
        dataclasses.astuple(jwin.analyze(np.zeros(0)))
    for bad in (np.zeros(0), np.zeros(4)):
        with pytest.raises(ValueError):
            window.equivalent_noise_bandwidth(bad)


def test_bessel_i0_equals_jax():
    from algodsp_tpu.window.window import bessel_i0 as j_i0
    from algodsp_tpu_torch.window.window import bessel_i0
    x = np.linspace(-20.0, 20.0, 401)
    np.testing.assert_array_equal(bessel_i0(x), j_i0(x))
