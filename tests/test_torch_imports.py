"""The port stands alone and never drifts to the CPU.

- Importing every module of `algodsp_tpu_torch` loads neither `jax` nor
  `algodsp_tpu`, and no file of the port (nor chip_smoke.py) imports them.
- Entry points raise when no CUDA device exists and none is named.
- Kernel wrappers given a CUDA tensor launch the kernel or raise: they
  never fall back to their plain versions. The cascade (zero state),
  envelope, FDL and Moog calls go through their autograd Functions; the
  calls with no backward on the card (the explicit-state cascade, the raw
  envelope kernel) refuse a tensor that requires grad instead of cutting
  the gradient.
"""

import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import algodsp_tpu_torch
from algodsp_tpu_torch import _build, convert
from algodsp_tpu_torch.chain import Chain
from algodsp_tpu_torch.conv import PartitionedConvolver, conv
from algodsp_tpu_torch.effects.dynamics import Compressor
from algodsp_tpu_torch.filters import BiquadChain
from algodsp_tpu_torch.filters.moog import MoogFilter
from algodsp_tpu_torch.ops import biquad_cascade as bq, envscan, fdlconv, moog
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
    assert "algodsp_tpu_torch.diff" in modules
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
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
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
    sos = np.array([[0.5, 0.2, 0.1, -0.3, 0.1]])
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
                    fdlconv.fdl_conv, moog.moog_ladder, moog.moog_zdf):
        assert isinstance(wrapper.launches, int)


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
    refused = [
        lambda: bq.biquad_cascade(g(2, 256), sos, state=_FakeCuda(2, 1, 4)),
        lambda: bq.biquad_cascade(_FakeCuda(2, 256), sos,
                                  state=g(2, 1, 4)),
        lambda: envscan.envelope_scan_kernel(g(2, 256), None, None, None),
        lambda: envscan.envelope_scan_kernel(_FakeCuda(2, 256), None,
                                             g(2), None),
    ]
    for call in refused:
        with pytest.raises(NotImplementedError, match="no backward on the card"):
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


def test_build_without_nvcc_raises(monkeypatch):
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setattr(_build.os.path, "isfile", lambda path: False)
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.nvcc_path()
