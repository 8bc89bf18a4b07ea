"""The port's banded engines (`ops/cascade.cascade_apply_blocked_banded`,
`ops/linrec.ar2_apply_blocked_banded`), `filters/bank.py` (`Bank`,
`OctaveAnalyzer`, `MultirateOctaveAnalyzer` and their helpers) against
the JAX package on the CPU (its XLA paths, jitted), and the analyzer's
envelopes against the C++ golden `native.envelope`.

Tolerances:
- float64 >= 200 dB SNR against the JAX float64 output (the same
  float64 kernels, products summed in another order); states to 1e-10;
- float32 against the JAX float64 output: the port's SNR no more than
  6 dB below the JAX float32 output's own (the class of
  `tests/test_torch_cascade.py`: both sum the same float32 products in
  different orders), and the worst band's no more than 10 dB below
  (see `_f32_bands_ok`; the slow low bands set the level);
- `tests/test_bank_multirate.py`'s rtol 1e-9 / atol 1e-12 for the
  multirate analyzer's streamed peaks against one call;
- the golden: atol 1e-12 (`tests/test_native.py`'s envelope bar);
- the pinned products under a caller's lowered matmul precision:
  bit-equal.
"""

import tests.torch_port_setup  # noqa: F401  (first: one PyTorch thread)

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from algodsp_tpu import native
from algodsp_tpu.filters import bank as jbank
from algodsp_tpu.ops import cascade as jcasc
from algodsp_tpu.ops import linrec as jlin
from algodsp_tpu_torch.filters import bank
from algodsp_tpu_torch.filters.design import butterworth_hp, butterworth_lp
from algodsp_tpu_torch.ops import cascade as tcasc
from algodsp_tpu_torch.ops import linrec
from tests.conftest import snr_db
from tests.torch_port_setup import ref_jit

SR = 48000.0


def _t(a, dtype=torch.float64):
    return torch.tensor(np.asarray(a), dtype=dtype)


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape)


def _f32_ok(ref64, j32, got32, margin=6.0):
    got, own = snr_db(ref64, got32), snr_db(ref64, j32)
    assert got >= own - margin, (got, own)


def _f32_bands_ok(ref64, j32, got32):
    """Over (..., bands, N): the whole within 6 dB, and the worst band
    within 10 dB, of the JAX float32 output's own SNR. Band by band the
    two float32 evaluations scatter by up to 15 dB either way; on twelve
    seeds of the streamed analyzer the port's worst band read 7.6 dB
    below to 4.1 dB above JAX's (2.4 dB below on average, both at
    87-103 dB, the reference's slow-pole float32 class)."""
    _f32_ok(ref64, j32, got32, 6.0)
    worst = lambda a: min(snr_db(ref64[..., b, :], a[..., b, :])
                          for b in range(ref64.shape[-2]))
    assert worst(got32) >= worst(j32) - 10.0, (worst(got32), worst(j32))


# a bank with a slow-pole band (40 Hz) and faster ones: the modal basis
# and the direct one side by side
_SOS = np.stack([np.concatenate([butterworth_lp(hi, 4, SR),
                                 butterworth_hp(lo, 4, SR)])
                 for lo, hi in ((35.0, 45.0), (900.0, 1100.0),
                                (7000.0, 9000.0))])


@functools.lru_cache(maxsize=None)
def _cascade_banded_jax(dtype):
    """JAX's banded cascade engine (output, state) from s0, shared by the
    dtype cases."""
    x = _x((2, 3, 1024), 1)
    s0 = _x((2, 3, 2 * _SOS.shape[1] + 2), 2) * 0.1
    run_j = ref_jit(lambda v, s: jcasc.cascade_apply_blocked_banded(
        v, _SOS, s0=s, return_state=True))
    return tuple(np.asarray(a) for a in run_j(jnp.asarray(x, dtype),
                                              jnp.asarray(s0, dtype)))


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_cascade_banded_engine_matches_jax(dtype):
    x = _x((2, 3, 1024), 1)
    s0 = _x((2, 3, 2 * _SOS.shape[1] + 2), 2) * 0.1
    y64, s64 = _cascade_banded_jax(jnp.float64)
    y, s = tcasc.cascade_apply_blocked_banded(_t(x, getattr(torch, dtype)), _SOS,
                                              s0=_t(s0), return_state=True)
    assert y.dtype == getattr(torch, dtype)
    if dtype == "float64":
        assert snr_db(y64, y.numpy()) >= 200
        np.testing.assert_allclose(s.numpy(), s64, atol=1e-10)
        y_only = tcasc.cascade_apply_blocked_banded(_t(x), _SOS)
        y_ref = np.asarray(jcasc.cascade_apply_blocked_banded(jnp.asarray(x), _SOS))
        assert snr_db(y_ref, y_only.numpy()) >= 200
    else:
        y32, s32 = _cascade_banded_jax(jnp.float32)
        _f32_ok(y64, y32, y.numpy())
        _f32_ok(s64, s32, s.numpy())
    with pytest.raises(ValueError):
        tcasc.cascade_apply_blocked_banded(_t(x[..., :1000]), _SOS)
    with pytest.raises(ValueError):
        tcasc.cascade_apply_blocked_banded(_t(x[:, :2]), _SOS)


@functools.lru_cache(maxsize=None)
def _linrec_banded_jax(dtype):
    """JAX's banded AR(2) engine from nonzero initial conditions, shared
    by the dtype cases."""
    a1, a2 = _SOS[:, 1, 3], _SOS[:, 1, 4]
    jk = jlin.ar2_kernels(a1, a2)
    run_j = ref_jit(lambda v, a, b: jlin.ar2_apply_blocked_banded(v, jk, a, b))
    return np.asarray(run_j(*(jnp.asarray(v, dtype) for v in (
        _x((2, 3, 768), 3), _x((2, 3), 4), _x((2, 3), 5)))))


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_linrec_banded_engine_matches_jax(dtype):
    """One section a band (the second LP section: modal in the 40 Hz band)
    from nonzero initial conditions."""
    a1, a2 = _SOS[:, 1, 3], _SOS[:, 1, 4]
    tk = linrec.ar2_kernels(a1, a2)
    f = _x((2, 3, 768), 3)
    y1, y2 = _x((2, 3), 4), _x((2, 3), 5)
    y64 = _linrec_banded_jax(jnp.float64)
    tdt = getattr(torch, dtype)
    y = linrec.ar2_apply_blocked_banded(_t(f, tdt), tk, _t(y1, tdt), _t(y2, tdt))
    if dtype == "float64":
        assert snr_db(y64, y.numpy()) >= 200
    else:
        _f32_ok(y64, _linrec_banded_jax(jnp.float32), y.numpy())
    with pytest.raises(ValueError):
        linrec.ar2_apply_blocked_banded(_t(f[..., :2, :]), tk, _t(y1[:, :2]),
                                        _t(y2[:, :2]))


@functools.lru_cache(maxsize=None)
def _banks():
    return (jbank.Bank.octave(3, SR, order=4, lower_hz=25.0, upper_hz=16000.0),
            bank.Bank.octave(3, SR, order=4, lower_hz=25.0, upper_hz=16000.0))


@functools.lru_cache(maxsize=None)
def _bank_jax(dtype):
    """JAX's bank output, shared by the dtype cases."""
    return np.asarray(ref_jit(_banks()[0].process)(jnp.asarray(_x((2, 2048), 6), dtype)))


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_bank_process_matches_jax(dtype):
    jb, tb = _banks()
    np.testing.assert_array_equal(tb.centers, jb.centers)
    np.testing.assert_array_equal(tb.chain.sos, jb.chain.sos)
    x = _x((2, 2048), 6)
    y64 = _bank_jax(jnp.float64)
    y = tb.process(_t(x, getattr(torch, dtype)))
    assert y.shape == (2, tb.num_bands, 2048)
    if dtype == "float64":
        assert snr_db(y64, y.numpy()) >= 200
    else:
        _f32_bands_ok(y64, _bank_jax(jnp.float32), y.numpy())


def test_bank_stream_ragged_blocks_matches_jax():
    """Blocks that are no multiple of the engine block take the
    per-section path; the state carried across them matches JAX's."""
    jb, tb = _banks()
    x = _x((2, 1000), 7)
    jstep = ref_jit(jb.process_stream)
    js, ts = jb.init_state((2,), jnp.float64), tb.init_state((2,), torch.float64, "cpu")
    outs, jouts = [], []
    for a, b in ((0, 300), (300, 812), (812, 1000)):
        js, jy = jstep(js, jnp.asarray(x[:, a:b]))
        ts, ty = tb.process_stream(ts, _t(x[:, a:b]))
        outs.append(ty.numpy())
        jouts.append(np.asarray(jy))
    assert snr_db(np.concatenate(jouts, -1), np.concatenate(outs, -1)) >= 200
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-10)
    with pytest.raises(ValueError):
        bank.Bank.octave(3, SR, order=3)
    custom = bank.Bank.custom([100.0, 1000.0, 30000.0], 0.5, SR)
    assert custom.num_bands == 2


@functools.lru_cache(maxsize=None)
def _octave_analyzer_jax(dtype):
    """JAX's analyzer over the two streamed blocks: (state, bands,
    levels) after the second, shared by the dtype cases."""
    ja = jbank.OctaveAnalyzer(3, SR, lower_hz=25.0)
    x = _x((2, 1024), 8)
    jstep = ref_jit(ja.process)
    js = ja.init_state((2,), dtype)
    for blk in (x[:, :512], x[:, 512:]):
        js, jbands, jlev = jstep(js, jnp.asarray(blk, dtype))
    return jax.tree_util.tree_map(np.asarray, js), np.asarray(jbands), np.asarray(jlev)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_octave_analyzer_matches_jax(dtype):
    """Two streamed 512-sample blocks (the chain's block) of 2 channels:
    bands, levels and both states."""
    ja = jbank.OctaveAnalyzer(3, SR, lower_hz=25.0)
    ta = bank.OctaveAnalyzer(3, SR, lower_hz=25.0)
    assert ta.attack_coeff == ja.attack_coeff
    assert ta.release_coeff == ja.release_coeff
    tdt = getattr(torch, dtype)
    x = _x((2, 1024), 8)
    js, jbands, jlev = _octave_analyzer_jax(jnp.float64)
    ts = ta.init_state((2,), tdt, "cpu")
    for blk in (x[:, :512], x[:, 512:]):
        ts, tbands, tlev = ta.process(ts, _t(blk, tdt))
    assert tbands.dtype == tdt and tlev.shape == (2, ta.bank.num_bands)
    if dtype == "float64":
        assert snr_db(np.asarray(jbands), tbands.numpy()) >= 200
        np.testing.assert_allclose(tlev.numpy(), np.asarray(jlev), atol=1e-10)
        np.testing.assert_allclose(ts["env"].numpy(), np.asarray(js["env"]),
                                   atol=1e-12)
        np.testing.assert_allclose(ts["bank"].numpy(), np.asarray(js["bank"]),
                                   atol=1e-10)
    else:
        js32, jb32, _ = _octave_analyzer_jax(jnp.float32)
        _f32_bands_ok(jbands, jb32, tbands.numpy())
        _f32_ok(js["env"], js32["env"], ts["env"].numpy())


@pytest.mark.skipif(not native.available(), reason="native library not built")
def test_octave_analyzer_envelopes_match_golden():
    """Each band's envelope against `native.envelope` on that band's own
    rectified output, atol 1e-12 (`tests/test_native.py`)."""
    ta = bank.OctaveAnalyzer(1, SR)
    x = _x((2, 700), 9)
    st = ta.init_state((2,), torch.float64, "cpu")
    st, bands, _ = ta.process(st, _t(x))
    bands = bands.numpy()
    for c in range(2):
        for b in range(ta.bank.num_bands):
            env_f, _ = native.envelope(np.abs(bands[c, b]), ta.attack_coeff,
                                       ta.release_coeff)
            assert abs(env_f - st["env"][c, b].item()) <= 1e-12


def test_multirate_helpers_and_layout_match_jax():
    for args in ((48000.0, 17800.0, 64), (48000.0, 1122.0, 64),
                 (48000.0, 22.4, 8), (48000.0, 0.0, 64), (48000.0, 100.0, 0)):
        assert bank.choose_downsample(*args) == jbank.choose_downsample(*args)
    for args in ((100.0, 48000.0), (100.0, 48.0), (0.0, 10.0), (5.0, 0.0)):
        assert bank.clamp_envelope_hz(*args) == jbank.clamp_envelope_hz(*args)
    ja, ta = jbank.MultirateOctaveAnalyzer(3, SR), bank.MultirateOctaveAnalyzer(3, SR)
    assert [tuple(vars(b).values()) for b in ta.bands()] == \
        [tuple(vars(b).values()) for b in ja.bands()]
    assert ta.max_ds == ja.max_ds and ta.num_bands == ja.num_bands
    np.testing.assert_array_equal(ta._perm, ja._perm)
    for tg, jg in zip(ta._groups, ja._groups):
        np.testing.assert_array_equal(tg["bandpass"].sos, jg["bandpass"].sos)
        np.testing.assert_array_equal(tg["envelope"].sos, jg["envelope"].sos)
    for kw in ({"order": 3}, {"envelope_order": 5}):
        with pytest.raises(ValueError):
            bank.MultirateOctaveAnalyzer(3, SR, **kw)
    with pytest.raises(ValueError):
        bank.MultirateOctaveAnalyzer(3, -1.0)
    with pytest.raises(ValueError, match="multiple"):
        ta.analyze(_t(_x((2, 100), 0)))


@functools.lru_cache(maxsize=None)
def _multirate_jax(dtype):
    """JAX's multirate analysis of the test signal, shared by the dtype
    cases."""
    ja = jbank.MultirateOctaveAnalyzer(3, SR, lower_hz=25.0, upper_hz=16000.0)
    return np.asarray(ref_jit(ja.analyze)(jnp.asarray(_x((2, 8192), 10), dtype)))


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_multirate_analyzer_matches_jax(dtype):
    """1/3-octave, order 10, 25 Hz - 16 kHz: every decimation group, at
    2 x 8192 samples (every group's decimated stream a multiple of the
    engine block: the whole-cascade path), one call; then streamed in
    two halves (the lowest groups' 64-sample streams take the
    per-section path)."""
    kw = dict(lower_hz=25.0, upper_hz=16000.0)
    ja = jbank.MultirateOctaveAnalyzer(3, SR, **kw)
    ta = bank.MultirateOctaveAnalyzer(3, SR, **kw)
    x = _x((2, 8192), 10)
    tdt = getattr(torch, dtype)
    p64 = _multirate_jax(jnp.float64)
    p = ta.analyze(_t(x, tdt))
    assert p.dtype == tdt and p.shape == (2, ta.num_bands)
    if dtype == "float64":
        assert snr_db(p64, p.numpy()) >= 200
        st = ta.init_state((2,), torch.float64, "cpu")
        st, _ = ta.process(st, _t(x[:, :4096]))
        _, p2 = ta.process(st, _t(x[:, 4096:]))
        np.testing.assert_allclose(p2.numpy(), p.numpy(), rtol=1e-9, atol=1e-12)
    else:
        _f32_ok(p64, _multirate_jax(jnp.float32), p.numpy())


def test_banded_engines_ignore_a_lowered_precision():
    """Both banded engines, the bank and the multirate analyzer (its
    resamplers included) give the same bits under a caller's
    `torch.set_float32_matmul_precision("medium")`."""
    x = _t(_x((2, 3, 1024), 11), torch.float32)
    tk = linrec.ar2_kernels(_SOS[:, 1, 3], _SOS[:, 1, 4])
    z = torch.zeros(2, 3)
    an = bank.MultirateOctaveAnalyzer(3, SR, lower_hz=25.0)
    xs = _t(_x((2, 1024), 12), torch.float32)
    run = lambda: (tcasc.cascade_apply_blocked_banded(x, _SOS),
                   linrec.ar2_apply_blocked_banded(x, tk, z, z),
                   an.analyze(xs))
    ref = run()
    before = torch.get_float32_matmul_precision()
    try:
        torch.set_float32_matmul_precision("medium")
        got = run()
        assert torch.get_float32_matmul_precision() == "medium"
    finally:
        torch.set_float32_matmul_precision(before)
    for a, b in zip(ref, got):
        assert torch.equal(a, b)
