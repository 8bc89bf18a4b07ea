"""The port stands alone and never drifts to the CPU.

- Importing every module of `algodsp_tpu_torch` loads neither `jax` nor
  `algodsp_tpu`, and no file of the port (nor chip_smoke.py) imports them.
- Entry points raise when no CUDA device exists and none is named
  (those of the analysis modules too), and run when given "cpu".
- Kernel wrappers given a CUDA tensor launch the kernel or raise: they
  never fall back to their plain versions. The cascade (zero state),
  envelope, FDL and Moog calls go through their autograd Functions; the
  calls with no backward on the card (the explicit-state cascade, the raw
  envelope kernel, the feedback dynamics detector D1, the delay and
  reverb feedback loops R1-R3, the flanger's loop M1 and the affine
  scans M2 and M3) refuse a tensor that requires grad instead of cutting
  the gradient. W1 (the WSOLA search) returns integer starts and runs on
  detached tensors; Q1 (the quantizer's loop) goes through its Function,
  whose gradient is the reference's zero: both launch under autograd.
"""

import tests.torch_port_setup  # noqa: F401  (first: one PyTorch thread)

import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import algodsp_tpu_torch
from algodsp_tpu_torch import (_build, convert, core, delayline, resample, signal,
                               spectrum, window)
from algodsp_tpu_torch.chain import Chain
from algodsp_tpu_torch.conv import OverlapAdd, OverlapSave, PartitionedConvolver, conv
from algodsp_tpu_torch.dither import Quantizer
from algodsp_tpu_torch.effects import modulation, spatial, waveshape
from algodsp_tpu_torch.effects.vocoder import Vocoder
from algodsp_tpu_torch.effects.delay_effect import Delay
from algodsp_tpu_torch.effects.dynamics import Compressor
from algodsp_tpu_torch.effects.reverb import FDNReverb, Freeverb
from algodsp_tpu_torch.filters import BiquadChain, bank
from algodsp_tpu_torch.filters.moog import MoogFilter
from algodsp_tpu_torch.ops import biquad_cascade as bq, dynfb, envscan, fdlconv, moog
from algodsp_tpu_torch.ops import dither, feedback, linrec, wsola
from algodsp_tpu_torch.pipeline import flagship_params

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.dirname(algodsp_tpu_torch.__file__)


def _port_modules():
    for dirpath, _, files in os.walk(PKG):
        for f in sorted(files):
            if f.endswith(".py"):
                rel = os.path.relpath(os.path.join(dirpath, f), ROOT)
                yield rel[:-3].replace(os.sep, ".").removesuffix(".__init__")


def test_import_leaves_jax_out():
    modules = list(_port_modules())
    assert {"algodsp_tpu_torch.diff", "algodsp_tpu_torch.ops.cascade",
            "algodsp_tpu_torch.ops.dynfb", "algodsp_tpu_torch.filters.crossover",
            "algodsp_tpu_torch.effects.dynamics.processors",
            "algodsp_tpu_torch.core.pool", "algodsp_tpu_torch.core.config",
            "algodsp_tpu_torch.testutil", "algodsp_tpu_torch.window.analyze",
            "algodsp_tpu_torch.window.metadata", "algodsp_tpu_torch.spectrum.mel",
            "algodsp_tpu_torch.spectrum.goertzel", "algodsp_tpu_torch.spectrum.stft",
            "algodsp_tpu_torch.signal.generate", "algodsp_tpu_torch.filters.bank",
            "algodsp_tpu_torch.filters.hilbert",
            "algodsp_tpu_torch.resample.resample", "algodsp_tpu_torch.ops.ring",
            "algodsp_tpu_torch.ops.feedback", "algodsp_tpu_torch.effects.delay_effect",
            "algodsp_tpu_torch.effects.reverb.freeverb",
            "algodsp_tpu_torch.effects.reverb.fdn", "algodsp_tpu_torch.conv.overlap",
            "algodsp_tpu_torch.conv.correlate",
            "algodsp_tpu_torch.conv.deconvolve", "algodsp_tpu_torch.interp",
            "algodsp_tpu_torch.delayline",
            "algodsp_tpu_torch.effects.modulation.modulation",
            "algodsp_tpu_torch.effects.waveshape",
            "algodsp_tpu_torch.effects.spatial", "algodsp_tpu_torch.effects.vocoder",
            "algodsp_tpu_torch.effects.spectral",
            "algodsp_tpu_torch.effects.pitch.spectral",
            "algodsp_tpu_torch.effects.pitch.wsola", "algodsp_tpu_torch.effects.pitch",
            "algodsp_tpu_torch.dither", "algodsp_tpu_torch.dither.designer",
            "algodsp_tpu_torch.dither.quantizer", "algodsp_tpu_torch.ops.wsola",
            "algodsp_tpu_torch.ops.dither"} <= set(modules)
    code = ("import importlib, sys\n"
            f"for m in {modules!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
            " or m == 'algodsp_tpu' or m.startswith('algodsp_tpu.')]\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                   timeout=120)


def test_no_file_imports_jax_or_the_reference():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, names in os.walk(PKG):
        files += [os.path.join(dirpath, n) for n in names if n.endswith(".py")]
    for path in files:
        with open(path) as fh:
            tree = ast.parse(fh.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mods = [node.module or ""]
            else:
                continue
            for m in mods:
                top = m.split(".")[0]
                assert top not in ("jax", "jaxlib", "algodsp_tpu"), (path, m)


def test_entry_points_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    params = flagship_params(seed=0, ir_taps=64)
    calls = [
        lambda: algodsp_tpu_torch.resolve_device(),
        lambda: convert.flagship_from_numpy(params),
        lambda: convert.state_from_numpy({"envelope": np.zeros(2)}),
        lambda: BiquadChain([1.0, 0.0, 0.0, 0.0, 0.0]).init_state((2,)),
        lambda: Compressor(48000.0).init_state((2,)),
        lambda: PartitionedConvolver(np.ones(8), 2).init_state((2,)),
        lambda: MoogFilter(48000.0).init_state((2,)),
        lambda: Chain(48000.0).init_state((2,)),
    ]
    analysis = [
        lambda device=None: core.Pool(device=device),
        lambda device=None: core.Buffer(4, device=device),
        lambda device=None: window.window.window_tensor(window.WindowType.HANN, 8,
                                                        device=device),
        lambda device=None: signal.sine(440.0, 1.0, 8, 48000.0, device=device),
        lambda device=None: signal.impulse(1.0, 8, device=device),
        lambda device=None: signal.white_noise(1.0, 8, device=device),
        lambda device=None: signal.pink_noise(1.0, 8, device=device),
        lambda device=None: spectrum.Goertzel([1000.0], 48000.0).init_state(
            (2,), device=device),
        lambda device=None: spectrum.StreamingSTFT(64, 16).init_state(
            (2,), device=device),
        lambda device=None: spectrum.StreamingISTFT(64, 16).init_state(
            (2,), device=device),
        lambda device=None: bank.Bank.octave(1, 48000.0).init_state(
            (2,), device=device),
        lambda device=None: bank.OctaveAnalyzer(1, 48000.0).init_state(
            (2,), device=device),
        lambda device=None: bank.MultirateOctaveAnalyzer(1, 48000.0).init_state(
            (2,), device=device),
        lambda device=None: resample.Resampler(1, 2).init_state((2,), device=device),
        lambda device=None: Delay(48000.0).init_state((2,), device=device),
        lambda device=None: Freeverb().init_state((2,), device=device),
        lambda device=None: FDNReverb(48000.0).init_state((2,), device=device),
        lambda device=None: OverlapSave(np.ones(8)).init_state((2,), device=device),
        lambda device=None: OverlapAdd(np.ones(8), 16).init_state((2,), device=device),
        lambda device=None: delayline.DelayLine(8).init_state((2,), device=device),
    ] + [
        lambda device=None, fx=fx: fx.init_state((2,), device=device)
        for fx in (modulation.Chorus(48000.0), modulation.Flanger(48000.0),
                   modulation.Phaser(48000.0), modulation.Tremolo(48000.0),
                   modulation.RingModulator(48000.0), modulation.AutoWah(48000.0),
                   modulation.FrequencyShifter(48000.0), waveshape.Distortion(),
                   waveshape.BitCrusher(48000.0),
                   waveshape.TransformerSimulation(48000.0),
                   waveshape.HarmonicBass(48000.0),
                   spatial.StereoWidener(48000.0), spatial.CrosstalkCanceller(48000.0),
                   spatial.CrosstalkSimulator(48000.0),
                   spatial.CrosstalkSimulator(48000.0, hrtf_irs={
                       k: np.ones(4) for k in ("left_direct", "left_cross",
                                                "right_direct", "right_cross")}),
                   Vocoder(48000.0), Quantizer(48000.0),
                   Quantizer(48000.0, iir_shelf_freq=8000.0))
    ]
    for call in calls + analysis:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    for call in analysis:
        assert call(device="cpu") is not None
    assert MoogFilter(48000.0).init_state((2,), device="cpu")["stage"].shape == (2, 4)
    assert Chain(48000.0).init_state((2,), device="cpu") == {}
    assert algodsp_tpu_torch.resolve_device("cpu") == torch.device("cpu")


class _FakeCuda:
    """Stands in for a CUDA tensor on a machine without CUDA."""

    def __init__(self, *shape, requires_grad=False):
        self.shape = torch.Size(shape)
        self.ndim = len(shape)
        self.dtype = torch.float32
        self.device = torch.device("cuda", 0)
        self.requires_grad = requires_grad

    def is_contiguous(self):
        return True

    def reshape(self, *shape):
        return self

    contiguous = reshape
    to = reshape
    detach = reshape


def test_kernel_wrappers_raise_instead_of_falling_back(monkeypatch):
    def no_kernel(name):
        raise RuntimeError(f"no kernel library {name}")

    def plain_called(*args, **kwargs):
        raise AssertionError("a CUDA tensor reached the plain version")

    monkeypatch.setattr(_build, "load", no_kernel)
    monkeypatch.setattr(bq, "biquad_cascade_plain", plain_called)
    monkeypatch.setattr(envscan, "envelope_scan_plain", plain_called)
    monkeypatch.setattr(fdlconv, "fdl_conv_plain", plain_called)
    monkeypatch.setattr(moog, "moog_ladder_plain", plain_called)
    monkeypatch.setattr(moog, "moog_zdf_plain", plain_called)
    monkeypatch.setattr(dynfb, "dynamics_feedback_plain", plain_called)
    for name in ("delay_feedback_plain", "freeverb_feedback_plain",
                 "fdn_feedback_plain", "flanger_feedback_plain"):
        monkeypatch.setattr(feedback, name, plain_called)
    for name in ("affine2_scan_plain", "affine_scan_nd_plain"):
        monkeypatch.setattr(linrec, name, plain_called)
    monkeypatch.setattr(wsola, "wsola_search_plain", plain_called)
    monkeypatch.setattr(dither, "error_feedback_plain", plain_called)
    sos = np.array([[0.5, 0.2, 0.1, -0.3, 0.1]])
    fb = Compressor(48000.0).core.feedback_params()
    for lib, call in _walk_calls(_FakeCuda):
        with pytest.raises(RuntimeError, match=f"no kernel library {lib}"):
            call()
    for call in _feedback_calls(_FakeCuda):
        with pytest.raises(RuntimeError, match="no kernel library feedback"):
            call()
    for call in _affine_calls(_FakeCuda):
        with pytest.raises(RuntimeError, match="no kernel library affine"):
            call()
    with pytest.raises(RuntimeError, match="no kernel library dynamics"):
        dynfb.dynamics_feedback(_FakeCuda(2, 256), _FakeCuda(2), _FakeCuda(2),
                                fb)
    with pytest.raises(RuntimeError, match="no kernel library biquad_cascade"):
        bq.biquad_cascade(_FakeCuda(2, 256), sos)
    with pytest.raises(RuntimeError, match="no kernel library envelope"):
        envscan.envelope_scan_kernel(_FakeCuda(2, 256), None, None, None)
    with pytest.raises(RuntimeError, match="no kernel library fdlconv"):
        fdlconv.fdl_conv(_FakeCuda(2, 256), _FakeCuda(3, 129, 2), 128)
    params = [0.1, 0.2, 0.5, 1.0, 1.0]
    with pytest.raises(RuntimeError, match="no kernel library moog"):
        moog.moog_ladder(_FakeCuda(2, 256), _FakeCuda(8, 2), params,
                         huovilainen=True)
    with pytest.raises(RuntimeError, match="no kernel library moog"):
        moog.moog_zdf(_FakeCuda(2, 256), _FakeCuda(8, 2), params)
    for wrapper in (bq.biquad_cascade, envscan.envelope_scan_kernel,
                    fdlconv.fdl_conv, moog.moog_ladder, moog.moog_zdf,
                    dynfb.dynamics_feedback, feedback.delay_feedback,
                    feedback.freeverb_feedback, feedback.fdn_feedback,
                    feedback.flanger_feedback, linrec.affine2_scan,
                    linrec.affine_scan_nd, wsola.wsola_search,
                    dither.error_feedback):
        assert isinstance(wrapper.launches, int)


def _walk_calls(make, x_grad=False):
    """W1's and Q1's wrappers on (fake) CUDA tensors made by make(*shape,
    ...), with the kernel library each needs; x requires grad where
    x_grad."""
    shaper = Quantizer(48000.0).shaper
    return [
        ("wsola", lambda: wsola.wsola_search(
            make(2, 4000, requires_grad=x_grad), make(2, 4001),
            np.array([0, 600]), np.array([False, False]), 480, 720, 1440, 360)),
        ("dither", lambda: dither.error_feedback(
            make(2, 256, requires_grad=x_grad), make(2, 256), make(2, 9),
            shaper))]


def _feedback_calls(make, x_grad=False):
    """R1-R3's wrappers on (fake) CUDA tensors made by make(*shape, ...);
    x requires grad where x_grad."""
    dl, fv, rv = Delay(48000.0), Freeverb(), FDNReverb(48000.0)
    fl = modulation.Flanger(48000.0)
    x = lambda: make(2, 256, requires_grad=x_grad)
    fv_state = lambda: {"combs": [make(2, n) for n in (1116, 1188, 1277, 1356,
                                                        1422, 1491, 1557, 1617)],
                        "filter_store": make(2, 8),
                        "allpasses": [make(2, n) for n in (556, 441, 341, 225)],
                        "step": make()}
    return [
        lambda: feedback.delay_feedback(dl, make(2, dl.buf_len), make(), x(),
                                        make(256)),
        lambda: feedback.freeverb_feedback(fv, fv_state(), x()),
        lambda: feedback.fdn_feedback(rv, make(2, 8, rv.line_len), make(2, 8),
                                      make(), make(), x(), make(2, 256)),
        lambda: feedback.flanger_feedback(fl, make(2, fl.buf_len), make(), x(),
                                          make(256))]


def _affine_calls(make, x_grad=False):
    """M3's and M2's wrappers on (fake) CUDA tensors; the offsets require
    grad where x_grad."""
    return [
        lambda: linrec.affine2_scan(make(2, 256, 4), make(2, 256, 2,
                                                          requires_grad=x_grad),
                                    make(2, 2)),
        lambda: linrec.affine_scan_nd(make(256, 7, 7), make(2, 256, 7,
                                                            requires_grad=x_grad),
                                      make(2, 7))]


def test_kernel_wrappers_refuse_grad(monkeypatch):
    """On a CUDA tensor that requires grad, the calls with a backward
    (the zero-state cascade, the FDL in either argument, fftconvolve's
    FDL branch with its kernel's spectra made differentiably, the Moog
    ladders in x or in the state) go on to their launch; the calls with
    none on the card (the explicit-state cascade, the raw envelope
    kernel) raise before any launch, since the kernels write fresh
    tensors and the gradient would be cut without a word. Under no_grad
    those go on to the launch too. The CPU paths stay differentiable."""
    def no_kernel(name):
        raise RuntimeError(f"no kernel library {name}")

    def spectra_from(b, B, P):
        raise RuntimeError(f"spectra of a kernel that requires grad "
                           f"{b.requires_grad}, B={B}, P={P}")

    monkeypatch.setattr(_build, "load", no_kernel)
    monkeypatch.setattr(conv, "kernel_spectra_torch", spectra_from)
    g = lambda *shape: _FakeCuda(*shape, requires_grad=True)
    sos = np.array([[0.5, 0.2, 0.1, -0.3, 0.1]])
    params = [0.1, 0.2, 0.5, 1.0, 1.0]
    fb = Compressor(48000.0).core.feedback_params()
    refused = [
        lambda: bq.biquad_cascade(g(2, 256), sos, state=_FakeCuda(2, 1, 4)),
        lambda: bq.biquad_cascade(_FakeCuda(2, 256), sos,
                                  state=g(2, 1, 4)),
        lambda: envscan.envelope_scan_kernel(g(2, 256), None, None, None),
        lambda: envscan.envelope_scan_kernel(_FakeCuda(2, 256), None,
                                             g(2), None),
        lambda: dynfb.dynamics_feedback(g(2, 256), _FakeCuda(2), _FakeCuda(2),
                                        fb),
        lambda: dynfb.dynamics_feedback(_FakeCuda(2, 256), g(2), _FakeCuda(2),
                                        fb),
    ]
    for call in (refused + _feedback_calls(_FakeCuda, x_grad=True)
                 + _affine_calls(_FakeCuda, x_grad=True)):
        with pytest.raises(NotImplementedError, match="no backward on the card"):
            call()
    # W1 (integer starts, detached inputs) and Q1 (a Function whose
    # gradient is zero) go on to their launches under autograd
    for lib, call in _walk_calls(_FakeCuda, x_grad=True):
        with pytest.raises(RuntimeError, match=f"no kernel library {lib}"):
            call()
    with torch.no_grad():
        with pytest.raises(RuntimeError, match="no kernel library dynamics"):
            dynfb.dynamics_feedback(g(2, 256), _FakeCuda(2), _FakeCuda(2), fb)
        for call in _feedback_calls(_FakeCuda, x_grad=True):
            with pytest.raises(RuntimeError, match="no kernel library feedback"):
                call()
        for call in _affine_calls(_FakeCuda, x_grad=True):
            with pytest.raises(RuntimeError, match="no kernel library affine"):
                call()
    launched = [
        ("biquad_cascade", lambda: bq.biquad_cascade(g(2, 256), sos)),
        ("fdlconv", lambda: fdlconv.fdl_conv(g(2, 256), _FakeCuda(3, 129, 2),
                                             128)),
        ("fdlconv", lambda: fdlconv.fdl_conv(_FakeCuda(2, 256), g(3, 129, 2),
                                             128)),
        ("requires grad True, B=8192, P=1", lambda: conv.fftconvolve(
            _FakeCuda(2, 8192), g(5000))),
        ("no kernel library moog",
         lambda: moog.moog_ladder(g(2, 256), _FakeCuda(8, 2), params)),
        ("no kernel library moog",
         lambda: moog.moog_zdf(_FakeCuda(2, 256), g(8, 2), params)),
    ]
    for match, call in launched:
        with pytest.raises(RuntimeError, match=match):
            call()
    with torch.no_grad():
        with pytest.raises(RuntimeError, match="no kernel library moog"):
            moog.moog_ladder(g(2, 256), _FakeCuda(8, 2), params)
        with pytest.raises(RuntimeError, match="no kernel library biquad"):
            bq.biquad_cascade(g(2, 256), sos, state=_FakeCuda(2, 1, 4))
    x = torch.ones(2, 64, dtype=torch.float64, requires_grad=True)
    _, y = moog.moog_ladder(x, torch.zeros(8, 2, dtype=torch.float64), params)
    y.sum().backward()
    assert x.grad is not None and bool(torch.isfinite(x.grad).all())


def test_wrappers_refuse_other_devices():
    meta = torch.empty((2, 256), device="meta")
    with pytest.raises(ValueError):
        bq.biquad_cascade(meta, np.array([[1.0, 0, 0, 0, 0]]))
    with pytest.raises(ValueError):
        envscan.envelope_scan(meta, 0.0, 0.1, 0.1)
    with pytest.raises(ValueError):
        envscan.envelope_scan_kernel(torch.zeros(2, 8), torch.zeros(2),
                                     torch.zeros(2), torch.zeros(2))
    with pytest.raises(ValueError):
        fdlconv.fdl_conv(meta, torch.empty((3, 129, 2), device="meta"), 128)
    for wrapper in (moog.moog_ladder, moog.moog_zdf):
        with pytest.raises(ValueError):
            wrapper(meta, torch.empty((8, 2), device="meta"), [1.0] * 5)
    with pytest.raises(ValueError):
        dynfb.dynamics_feedback(meta, torch.empty(2, device="meta"),
                                torch.empty(2, device="meta"),
                                Compressor(48000.0).core.feedback_params())
    on_meta = lambda *shape, requires_grad=False: torch.empty(shape, device="meta")
    for call in (_feedback_calls(on_meta) + _affine_calls(on_meta)
                 + [c for _, c in _walk_calls(on_meta)]):
        with pytest.raises(ValueError):
            call()


def test_build_without_nvcc_raises(monkeypatch):
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setattr(_build.os.path, "isfile", lambda path: False)
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.nvcc_path()
