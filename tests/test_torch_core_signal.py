"""The port's `core/` (numeric, config, pool), `testutil.py` and
`signal/generate.py` against the JAX package on the CPU.

Tolerances:
- the numeric helpers and generators in float64: max abs difference
  <= 1e-10 against the JAX float64 output (the same formulas; libm and
  XLA differ in the last bits of sin, exp and log10);
- float32 generators: held to the JAX float64 output no farther than
  twice the JAX float32 output's own distance from it, plus 1e-6 (the
  same float32 arithmetic, whose sin and exp round differently in
  torch and XLA; a float32 phase of thousands of radians is itself
  ~1e-4 off);
- noise: `tests/test_signal.py`'s statistics bars (the port draws from
  a `torch.Generator`, another stream than `jax.random`), and pink
  noise fed JAX's own uniforms equal to `algodsp_tpu.signal.pink_noise`
  bit for bit;
- the envelope follower: atol 1e-12 in float64 (`tests/test_signal.py`);
- host helpers (testutil, config, next_pow2): equal.
"""

import tests.torch_port_setup  # noqa: F401  (first: one PyTorch thread)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from algodsp_tpu import core as jcore
from algodsp_tpu import signal as jsig
from algodsp_tpu import testutil as jtu
from algodsp_tpu_torch import core, signal, testutil
from algodsp_tpu_torch.core import Buffer, Pool, ProcessorConfig
from algodsp_tpu_torch.signal import generate
from tests.torch_port_setup import ref_jit

SR = 48000.0


def _t(a, dtype=torch.float64):
    return torch.as_tensor(np.asarray(a), dtype=dtype)


def _same(jax_out, torch_out, atol=1e-10):
    j = np.asarray(jax_out, np.float64)
    t = torch_out.double().numpy() if isinstance(torch_out, torch.Tensor) \
        else np.asarray(torch_out, np.float64)
    assert j.shape == t.shape
    np.testing.assert_array_equal(np.isnan(j), np.isnan(t))
    np.testing.assert_array_equal(np.isinf(j) & (j > 0), np.isinf(t) & (t > 0))
    np.testing.assert_array_equal(np.isinf(j) & (j < 0), np.isinf(t) & (t < 0))
    fin = np.isfinite(j)
    np.testing.assert_allclose(t[fin], j[fin], rtol=1e-12, atol=atol)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_numeric_helpers_match_jax(dtype):
    rng = np.random.default_rng(1)
    v = np.concatenate([rng.standard_normal(64) * 30, [0.0, -0.0, 1e-31,
                                                       -1e-35, 1.0, -2.0]])
    v = v.astype(dtype)
    b = (v + rng.standard_normal(v.size).astype(dtype) * 1e-13).astype(dtype)
    tv, tb = torch.as_tensor(v), torch.as_tensor(b)
    jv, jb = jnp.asarray(v), jnp.asarray(b)
    atol = 1e-10 if dtype == "float64" else 1e-5
    _same(jcore.clamp(jv, 5.0, -3.0), core.clamp(tv, 5.0, -3.0))
    for eps in (0.0, 1e-6):
        np.testing.assert_array_equal(np.asarray(jcore.nearly_equal(jv, jb, eps)),
                                      core.nearly_equal(tv, tb, eps).numpy())
    _same(jcore.flush_denormals(jv), core.flush_denormals(tv))
    for name in ("db_to_linear", "db_power_to_linear"):
        _same(getattr(jcore.numeric, name)(jnp.asarray(v / 10)),
              getattr(core, name)(torch.as_tensor(v / 10)), atol)
    for name in ("linear_to_db", "linear_power_to_db"):
        _same(getattr(jcore.numeric, name)(jv), getattr(core, name)(tv), atol)
    assert core.db_to_linear(20.0).item() == pytest.approx(10.0, rel=1e-12)
    assert core.linear_power_to_db(100.0).item() == pytest.approx(20.0, rel=1e-12)
    assert core.clamp(torch.tensor([2.0]), 0.0, 1.0).dtype == torch.float32


def test_host_helpers_and_config_match_jax():
    for n in (0, 1, 2, 3, 5, 1000, 1024, 1025):
        assert core.next_pow2(n) == jcore.next_pow2(n)
    assert core.numeric.best_float() is torch.float64
    assert ProcessorConfig() == ProcessorConfig(44100.0, 512)
    assert ProcessorConfig(48000.0, 256).block_size == 256
    for bad in ({"sample_rate": 0.0}, {"block_size": 0}):
        with pytest.raises(ValueError):
            ProcessorConfig(**bad)
        with pytest.raises(ValueError):
            jcore.ProcessorConfig(**bad)


def test_buffer_and_pool_semantics():
    """`tests/test_core.py`'s buffer and pool checks on the port's tensors
    (on the host here; the pool's device elsewhere)."""
    b = Buffer(4, device="cpu")
    b.samples[:] = torch.tensor([1.0, 2.0, 3.0, 4.0])
    b.resize(2)
    assert len(b) == 2 and b.capacity == 4
    b.resize(4)
    np.testing.assert_array_equal(b.samples.numpy(), [1.0, 2.0, 0.0, 0.0])
    b.grow(10)
    assert b.capacity == 10 and len(b) == 4
    b.zero_range(1, 100)
    np.testing.assert_array_equal(b.samples.numpy(), [1.0, 0.0, 0.0, 0.0])
    c = b.copy()
    c.samples[0] = 9.0
    assert b.samples[0] == 1.0
    w = Buffer.from_array(torch.arange(6.0).reshape(2, 3))
    assert len(w) == 6 and w.dtype == torch.float32
    pool = Pool(device="cpu")
    p1 = pool.get(8)
    p1.samples[:] = 5.0
    pool.put(p1)
    p2 = pool.get(4)
    assert p2 is p1 and len(p2) == 4 and float(p2.samples.abs().sum()) == 0.0
    pool.put(None)
    with pytest.raises(ValueError, match="pool"):
        pool.put(Buffer(4, dtype=torch.float64, device="cpu"))


def test_testutil_matches_reference():
    for name, args in (("sine", (440.0, SR, 300, 0.5)), ("seeded_noise", (64, 3)),
                       ("impulse", (16, 5, 2.0)), ("dc", (8, 0.25))):
        np.testing.assert_array_equal(getattr(testutil, name)(*args),
                                      getattr(jtu, name)(*args))
    rng = np.random.default_rng(2)
    a = rng.standard_normal(100)
    b = a + rng.standard_normal(100) * 1e-6
    assert testutil.snr_db(a, b) == jtu.snr_db(a, b)
    assert testutil.snr_db(torch.as_tensor(a), torch.as_tensor(b).float()) == \
        jtu.snr_db(a, np.float32(b))
    assert testutil.snr_db(a, a) == np.inf
    assert testutil.snr_db(np.zeros(3), np.ones(3)) == -np.inf
    assert testutil.max_abs_diff(torch.as_tensor(a), b) == jtu.max_abs_diff(a, b)
    testutil.require_slice_nearly_equal(a, b, 1e-5)
    with pytest.raises(AssertionError, match="max abs diff"):
        testutil.require_slice_nearly_equal(a, b, 1e-9)


_GENERATORS = {
    "sine": lambda m, d, **kw: m.sine(997.0, 0.8, 4801, SR, d, **kw),
    "multisine": lambda m, d, **kw: m.multisine([100.0, 1000.0, 5000.0], 0.9,
                                                2400, SR, d, **kw),
    "impulse": lambda m, d, **kw: m.impulse(0.5, 64, 7, d, **kw),
    "linear_sweep": lambda m, d, **kw: m.linear_sweep(20.0, 20000.0, 1.0, 4800,
                                                      SR, d, **kw),
    "log_sweep": lambda m, d, **kw: m.log_sweep(20.0, 20000.0, 1.0, 4800, SR,
                                                d, **kw),
}


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_generators_match_jax(dtype):
    tdt = getattr(torch, dtype)
    for name, gen in _GENERATORS.items():
        j64 = np.asarray(gen(jsig, jnp.float64), np.float64)
        got = gen(signal, tdt, device="cpu")
        assert got.dtype == tdt and got.shape == j64.shape, name
        err = np.max(np.abs(got.double().numpy() - j64))
        if dtype == "float64":
            assert err <= 1e-10, (name, err)
        else:
            j32 = np.asarray(gen(jsig, jnp.float32), np.float64)
            assert err <= 2 * np.max(np.abs(j32 - j64)) + 1e-6, (name, err)
    with pytest.raises(ValueError):
        signal.sine(1.0, 1.0, 0, SR, device="cpu")
    with pytest.raises(ValueError):
        signal.impulse(1.0, 8, 8, device="cpu")
    with pytest.raises(ValueError):
        signal.log_sweep(0.0, 10.0, 1.0, 8, SR, device="cpu")


def test_white_noise_statistics_and_determinism():
    """`tests/test_signal.py::test_white_noise_stats`'s bars; the stream is
    the torch generator's, not jax.random's."""
    x = signal.white_noise(1.0, 100000, seed=1, device="cpu").numpy()
    assert x.dtype == np.float32
    assert np.all(np.abs(x) <= 1.0)
    assert abs(x.mean()) < 0.01
    assert abs(x.var() - 1 / 3) < 0.01
    np.testing.assert_array_equal(
        x, signal.white_noise(1.0, 100000, seed=1, device="cpu").numpy())
    assert not np.array_equal(
        x, signal.white_noise(1.0, 100000, seed=2, device="cpu").numpy())
    assert signal.white_noise(0.5, 16, dtype=torch.float64,
                              device="cpu").abs().max() <= 0.5
    with pytest.raises(ValueError):
        signal.white_noise(-1.0, 8, device="cpu")


@pytest.mark.parametrize("seed,amplitude", [(1, 1.0), (7, 0.3)])
def test_pink_noise_from_jax_uniforms_equals_jax(seed, amplitude):
    """The Voss-McCartney step fed the reference's own uniforms (the two
    draws of `algodsp_tpu/signal/generate.py:132-134`) gives the
    reference's pink noise bit for bit."""
    n = 1 << 14
    k1, k2 = jax.random.split(jax.random.PRNGKey(seed))
    ur1 = np.array(jax.random.uniform(k1, (n,), dtype=jnp.float32))
    val = np.array(jax.random.uniform(k2, (n,), dtype=jnp.float32) * 2.0 - 1.0)
    ref = np.asarray(jsig.pink_noise(amplitude, n, seed=seed))
    got = (generate.voss_mccartney(torch.as_tensor(ur1), torch.as_tensor(val))
           * amplitude).numpy()
    np.testing.assert_array_equal(got, ref)


def test_pink_noise_spectrum_slope():
    """`tests/test_signal.py::test_pink_noise_spectrum_slope`'s bar."""
    x = signal.pink_noise(1.0, 2 ** 16, seed=1, device="cpu").double().numpy()
    assert np.all(np.isfinite(x))
    spec = np.abs(np.fft.rfft(x)) ** 2
    freqs = np.fft.rfftfreq(x.size, 1 / SR)
    band = lambda lo, hi: spec[(freqs >= lo) & (freqs < hi)].mean()
    slope = 10 * np.log10(band(1600, 3200) / band(100, 200)) / 4
    assert -4.5 < slope < -1.5, slope
    assert signal.pink_noise(1.0, 64, dtype=torch.float64,
                             device="cpu").dtype == torch.float64


def test_normalize_clip_remove_dc_match_jax():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((3, 50))
    x[1] = 0.0
    _same(jsig.normalize(jnp.asarray(x), 0.7), signal.normalize(_t(x), 0.7))
    _same(jsig.clip(jnp.asarray(x), -0.5, 0.25), signal.clip(_t(x), -0.5, 0.25))
    _same(jsig.remove_dc(jnp.asarray(x)), signal.remove_dc(_t(x)))
    with pytest.raises(ValueError):
        signal.clip(_t(x), 1.0, -1.0)
    with pytest.raises(ValueError):
        signal.normalize(_t(x), -1.0)


def test_envelope_follower_matches_jax():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 700))
    ref = np.asarray(ref_jit(lambda v: jsig.envelope_follower(v, 0.3, 0.01))(
        jnp.asarray(x)))
    np.testing.assert_allclose(signal.envelope_follower(_t(x), 0.3, 0.01).numpy(),
                               ref, atol=1e-12)
    one = signal.envelope_follower(_t(x[1]), 0.3, 0.01).numpy()
    np.testing.assert_allclose(one, ref[1], atol=1e-12)
    got32 = signal.envelope_follower(_t(x, torch.float32), 0.3, 0.01)
    assert got32.dtype == torch.float32
    np.testing.assert_allclose(got32.double().numpy(), ref, atol=1e-5)
    with pytest.raises(ValueError):
        signal.envelope_follower(_t(x), 1.5, 0.1)


def test_package_exports_match_jax():
    """core, window, spectrum, signal, resample and filters export the JAX
    package's public names, no fewer and no more."""
    import importlib
    for pkg in ("core", "window", "spectrum", "signal", "resample", "filters"):
        ref = importlib.import_module(f"algodsp_tpu.{pkg}")
        port = importlib.import_module(f"algodsp_tpu_torch.{pkg}")
        assert sorted(port.__all__) == sorted(ref.__all__), pkg
        assert all(hasattr(port, name) for name in port.__all__), pkg
