"""The port's spectral effects against the JAX package on the CPU (JAX
jitted): SpectralFreeze (unfrozen, frozen with the phase held and
advanced), Granular (pitch and spray, the identity regime, an input
shorter than a grain) and the SpectralPitchShifter on both paths (bin
shift for |r - 1| <= 0.15, stretch and resample), with the C++ goldens
and the scatter-free overlap-add against a scatter-add.

Tolerances: float64 >= 200 dB; float32 against JAX float64 >= 100 dB,
or no more than 6 dB below JAX float32's own SNR where that is lower
(the reference's float32 class: the overlap-add divides by the squared
window's sum, tiny at a frame's first samples; the stretch path sums its
phase over frames in float32); the goldens at tests/test_native.py's
bars (120 dB, 110 for the spectral pitch shifter).
"""

import tests.torch_port_setup  # noqa: F401  (first: one PyTorch thread)

import copy
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from algodsp_tpu import native
from algodsp_tpu.effects import pitch as jpitch
from algodsp_tpu.effects import spectral as jsp
from algodsp_tpu_torch.effects import pitch as tpitch
from algodsp_tpu_torch.effects import spectral as tsp
from tests.conftest import snr_db
from tests.torch_port_setup import meets_float32_bar, ref_jit

SR = 48000.0


def _check(fj, ft, x, run=None):
    """float64 >= 200 dB; float32 within the reference's class. `run` is
    the JAX reference (default: `fj.process` jitted)."""
    run = run or ref_jit(fj.process)
    yj = np.asarray(run(jnp.asarray(x)))
    yt = ft.process(torch.as_tensor(x)).numpy()
    assert yt.shape == x.shape and yt.dtype == np.float64
    assert snr_db(yj, yt) >= 200
    x32 = x.astype(np.float32)
    yt32 = ft.process(torch.as_tensor(x32)).numpy()
    assert yt32.dtype == np.float32
    assert meets_float32_bar(snr_db(yj, yt32),
                             lambda: snr_db(yj, np.asarray(run(jnp.asarray(x32)))))


def _tone(n, seed=140, c=None):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / SR
    shape = (n,) if c is None else (c, n)
    return np.sin(2 * np.pi * 750.0 * t) + 0.1 * rng.standard_normal(shape)


FREEZE = {"unfrozen": dict(frozen=False),
          "hold": dict(frozen=True, phase_mode="HOLD"),
          "advance": dict(frozen=True, phase_mode="ADVANCE")}


def _freeze(m, kw):
    kw = dict(kw)
    if "phase_mode" in kw:
        kw["phase_mode"] = getattr(m.FreezePhaseMode, kw["phase_mode"])
    return m.SpectralFreeze(SR, frame_size=512, hop_size=128, mix=0.9, **kw)


@pytest.mark.parametrize("case", list(FREEZE))
def test_freeze_matches_jax(case):
    _check(_freeze(jsp, FREEZE[case]), _freeze(tsp, FREEZE[case]),
           _tone(5000, c=2))


@pytest.mark.parametrize("case", list(FREEZE))
def test_freeze_matches_native(case):
    x = _tone(5000)
    fz = _freeze(tsp, FREEZE[case])
    # the golden reads the phase mode as the JAX package's enum
    as_jax = types.SimpleNamespace(**vars(fz))
    as_jax.phase_mode = jsp.FreezePhaseMode(fz.phase_mode.value)
    assert snr_db(native.spectral_freeze(as_jax, x),
                  fz.process(torch.as_tensor(x)).numpy()) > 120


GRAIN = {"pitch_spray": dict(grain_seconds=0.03, overlap=0.6, pitch=1.5,
                             spray_seconds=0.005, mix=0.8, seed=7),
         "identity": dict(grain_seconds=0.02, overlap=0.75, pitch=1.0, mix=1.0),
         "long_grain": dict(grain_seconds=0.5, overlap=0.95, pitch=0.5,
                            spray_seconds=0.2, mix=0.5, seed=3)}


@pytest.mark.parametrize("case", list(GRAIN))
def test_granular_matches_jax(case):
    """The long grain (24000 samples) is longer than the 16384-sample
    input: one grain, its reads past the end silent."""
    x = np.random.default_rng(60).standard_normal((2, 1 << 14))
    _check(jsp.Granular(SR, **GRAIN[case]), tsp.Granular(SR, **GRAIN[case]), x)


def test_granular_matches_native():
    gr = tsp.Granular(SR, **GRAIN["pitch_spray"])
    x = np.random.default_rng(60).standard_normal((2, 1 << 14))
    assert snr_db(native.granular(gr, x), gr.process(torch.as_tensor(x)).numpy()) > 120
    ident = tsp.Granular(SR, **GRAIN["identity"])
    t = np.sin(2 * np.pi * 440.0 * np.arange(1 << 14) / SR)
    y = ident.process(torch.as_tensor(t)).numpy()
    mid = slice(2048, (1 << 14) - 2048)
    assert snr_db(t[mid], y[mid]) > 40


def _bin_shift_jitted(pj):
    """JAX's bin-shift path jitted with the ratio a traced scalar: with
    the ratio a constant, XLA turns the bin map's b / r into b * (1 / r),
    which moves floor(b / r) at exact multiples (bins 33, 55, 66, ... at
    r = 1.1); traced, it divides, as JAX op by op, the port and the C++
    golden do."""
    def run(v, r):
        shifter = copy.copy(pj)
        shifter.pitch_ratio = r
        return shifter._process_bin_shift(v)
    jitted = ref_jit(run)
    return lambda v: jitted(v, jnp.float64(pj.pitch_ratio))


@pytest.mark.parametrize("ratio", [1.1, 1.5, 0.7, 0.95])
def test_spectral_pitch_matches_jax(ratio):
    """Both paths: 1.1 and 0.95 shift bins (JAX with the ratio traced,
    `_bin_shift_jitted`), 1.5 and 0.7 stretch and resample."""
    kw = dict(pitch_ratio=ratio, frame_size=512, analysis_hop=128)
    pj, pt = jpitch.SpectralPitchShifter(SR, **kw), tpitch.SpectralPitchShifter(SR, **kw)
    assert pt.effective_pitch_ratio() == pj.effective_pitch_ratio()
    assert pt.synthesis_hop == pj.synthesis_hop
    run = _bin_shift_jitted(pj) if pj._use_bin_shift() else None
    _check(pj, pt, _tone(12000, seed=141, c=2), run)


@pytest.mark.parametrize("ratio", [1.1, 1.5, 0.7])
def test_spectral_pitch_matches_native(ratio):
    ps = tpitch.SpectralPitchShifter(SR, pitch_ratio=ratio, frame_size=512,
                                     analysis_hop=128)
    t = np.arange(12000) / SR
    x = np.sin(2 * np.pi * 440.0 * t) + 0.05 * np.random.default_rng(
        141).standard_normal(12000)
    assert snr_db(native.spectral_pitch(ps, x),
                  ps.process(torch.as_tensor(x)).numpy()) > 110


def test_overlap_add_is_a_scatter_add_and_errors_match_jax():
    """overlap_add against index_add_ at hops that divide the frame, do
    not, and exceed it, with one frame; then the constructors' checks."""
    rng = np.random.default_rng(5)
    for frames, length, hop in ((9, 64, 16), (7, 50, 15), (4, 10, 13), (1, 32, 8),
                                (30, 100, 3)):
        fr = torch.as_tensor(rng.standard_normal((2, frames, length)))
        total = (frames - 1) * hop + length
        idx = (torch.arange(frames)[:, None] * hop + torch.arange(length)).reshape(-1)
        want = torch.zeros(2, total, dtype=torch.float64).index_add_(
            -1, idx, fr.reshape(2, -1))
        got = tsp.overlap_add(fr, hop)
        assert got.shape == want.shape
        torch.testing.assert_close(got, want, rtol=0, atol=1e-13)
        assert torch.equal(got, tsp.overlap_add(fr, hop))
    for m in (jsp, tsp):
        for kw in (dict(frame_size=100), dict(hop_size=0)):
            with pytest.raises(ValueError):
                m.SpectralFreeze(SR, **kw)
        for kw in (dict(grain_seconds=1.0), dict(overlap=0.99), dict(pitch=5.0)):
            with pytest.raises(ValueError):
                m.Granular(SR, **kw)
    for m in (jpitch, tpitch):
        for kw in (dict(frame_size=100), dict(analysis_hop=0), dict(pitch_ratio=0.1)):
            with pytest.raises(ValueError):
                m.SpectralPitchShifter(SR, **kw)
    x = torch.randn(2, 600, dtype=torch.float64)
    assert tpitch.SpectralPitchShifter(SR).process(x) is x
