"""The port's partitioned convolver, FDL plain path and LTI fold against
the JAX package (its XLA paths on the CPU) and a float64 `np.convolve`.

Tolerance: >= 110 dB SNR against float64 direct convolution, per
channel — the bar the JAX package holds its fused FDL kernel to
(tests/test_fdlconv.py) — and the same against the JAX outputs. The
fold is host float64 NumPy in both packages and must agree to 1e-12.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from algodsp_tpu.conv import PartitionedConvolver as JConv
from algodsp_tpu.conv import ltifold as jfold
from algodsp_tpu.filters import BiquadChain as JChain, design as jd
from algodsp_tpu.filters.weighting import WeightingType as JW, weighting_chain as jwc
from algodsp_tpu_torch import convert
from algodsp_tpu_torch.conv import ltifold as tfold
from algodsp_tpu_torch.ops import fdlconv as fdlmod
from algodsp_tpu_torch.ops.fdlconv import fdl_conv, kernel_spectra
from tests.conftest import snr_db

B = 1024


def _ir(taps, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(taps) * np.exp(-np.arange(taps) / 600.0)
            ).astype(np.float32)


def _x(c, n, seed=1):
    return np.random.default_rng(seed).standard_normal((c, n)).astype(np.float32)


def _oracle(x, ir):
    return np.stack([np.convolve(xi.astype(np.float64), ir.astype(np.float64))
                     [:x.shape[-1]] for xi in x])


@pytest.mark.parametrize("channels", [1, 3, 4])
def test_process_matches_f64_and_jax(channels):
    ir = _ir(3000)
    x = _x(channels, 4 * B, seed=channels)
    conv = convert.convolver_from_numpy(ir, 10)
    y = conv.process(torch.from_numpy(x)).numpy()
    want = _oracle(x, ir)
    for c in range(channels):
        assert snr_db(want[c], y[c]) >= 110
    y_j = np.asarray(JConv(ir, 10).process(jnp.asarray(x)))
    assert snr_db(y_j, y) >= 110


def test_quiet_channel_beside_loud_one():
    ir = _ir(2 * B + 100, seed=2)
    x = _x(3, 4 * B, seed=3)
    x[0] *= 1e-6
    x[2] = 0.0
    y = convert.convolver_from_numpy(ir, 10).process(torch.from_numpy(x)).numpy()
    want = _oracle(x, ir)
    assert snr_db(want[0], y[0]) >= 110
    assert snr_db(want[1], y[1]) >= 110
    assert np.all(y[2] == 0.0)


@pytest.mark.parametrize("order", [10, 11, 12])
def test_any_bulk_partition_is_exact(order):
    ir = _ir(3000, seed=4)
    x = _x(2, 4 * B, seed=5)
    conv = convert.convolver_from_numpy(ir, 10)
    y = conv.process(torch.from_numpy(x), bulk_block_order=order).numpy()
    assert snr_db(_oracle(x, ir), y) >= 110
    hs = torch.from_numpy(kernel_spectra(ir, 1 << order))
    assert torch.equal(fdl_conv(torch.from_numpy(x), hs, 1 << order),
                       conv._process_bulk_fdl(torch.from_numpy(x), order))


def test_process_stream_matches_jax_and_one_shot():
    ir = _ir(3000, seed=6)
    x = _x(2, 4 * B, seed=7)
    conv = convert.convolver_from_numpy(ir, 10)
    jconv = JConv(ir, 10)
    st = conv.init_state((2,), device="cpu")
    st_j = jconv.init_state((2,))
    ys = []
    for half in (x[:, :2 * B], x[:, 2 * B:]):
        st, y = conv.process_stream(st, torch.from_numpy(half))
        st_j, y_j = jconv.process_stream(st_j, jnp.asarray(half))
        assert snr_db(np.asarray(y_j), y.numpy()) >= 110
        ys.append(y.numpy())
    assert snr_db(_oracle(x, ir), np.concatenate(ys, -1)) >= 110
    assert snr_db(np.asarray(st_j["fdl"]), st["fdl"].numpy()) >= 110
    assert np.array_equal(np.asarray(st_j["tail"]), st["tail"].numpy())
    # the re-history form (taken on the card for long IRs) continues the
    # same stream with the same output and state
    st_a, y_a = conv._process_stream_depthwise(st, torch.from_numpy(x))
    st_b, y_b = conv._process_stream_rehistory(st, torch.from_numpy(x))
    assert snr_db(y_a.numpy(), y_b.numpy()) >= 110
    assert snr_db(st_a["fdl"].numpy(), st_b["fdl"].numpy()) >= 110


def test_stream_rehistory_choice_and_short_calls():
    """The card's streaming dispatch takes the re-history form from P = 8
    partitions and 2 blocks up (the smallest sizes timed on the card),
    and that form stays exact for a call far shorter than the IR."""
    conv = convert.convolver_from_numpy(_ir(8 * B - 5, seed=13), 10)
    assert conv.num_parts == 8
    assert conv.stream_rehistory(2 * B) and not conv.stream_rehistory(B)
    assert not convert.convolver_from_numpy(_ir(7 * B), 10).stream_rehistory(64 * B)
    st, _ = conv._process_stream_depthwise(conv.init_state((2,), device="cpu"),
                                           torch.from_numpy(_x(2, 8 * B, seed=14)))
    x = torch.from_numpy(_x(2, 2 * B, seed=15))
    st_a, y_a = conv._process_stream_depthwise(st, x)
    st_b, y_b = conv._process_stream_rehistory(st, x)
    assert snr_db(y_a.numpy(), y_b.numpy()) >= 110
    assert snr_db(st_a["fdl"].numpy(), st_b["fdl"].numpy()) >= 110
    assert torch.equal(st_a["tail"], st_b["tail"])


def test_process_block_and_scan():
    ir = _ir(2500, seed=8)
    x = _x(2, 3 * B, seed=9)
    conv = convert.convolver_from_numpy(ir, 10)
    jconv = JConv(ir, 10)
    st = conv.init_state((2,), device="cpu")
    st_j = jconv.init_state((2,))
    for i in range(3):
        blk = x[:, i * B:(i + 1) * B]
        st, y = conv.process_block(st, torch.from_numpy(blk))
        st_j, y_j = jconv.process_block(st_j, jnp.asarray(blk))
        assert snr_db(np.asarray(y_j), y.numpy()) >= 110
    assert snr_db(_oracle(x, ir), conv.process_scan(torch.from_numpy(x)).numpy()) >= 110
    with pytest.raises(ValueError):
        conv.process_block(st, torch.zeros(2, B // 2))
    with pytest.raises(ValueError):
        conv.process(torch.zeros(2, B + 1))


def test_float64_path_and_block_order_choice():
    ir = _ir(3000, seed=10)
    x = np.random.default_rng(11).standard_normal((2, 2 * B))
    conv = convert.convolver_from_numpy(ir, 10)
    y = conv.process(torch.from_numpy(x))
    assert y.dtype == torch.float64
    assert snr_db(_oracle(x, ir), y.numpy()) >= 250
    assert conv.bulk_block_order(48128) == 10
    assert conv.bulk_block_order(1 << 16) == 12        # IR rounds up to 2^12
    big = convert.convolver_from_numpy(np.ones(1 << 15), 10)
    assert big.bulk_block_order(48128) == 10
    assert big.bulk_block_order(1 << 24) == 13
    assert convert.convolver_from_numpy(np.ones(8), 14).bulk_block_order(1 << 15) == 0


def test_fold_matches_jax():
    sr = 48000.0
    jchain = JChain(np.concatenate([
        JChain(jd.butterworth_lp(2000.0, 10, sr)).runtime_sos,
        jwc(JW.A, sr).runtime_sos]), gain=0.7, condition=False)
    tchain = convert.biquad_chain_from_numpy(jchain.sos, jchain.gain,
                                             condition=False)
    ir = _ir(4096, seed=12)
    assert tfold.iir_tail_length(tchain.sos) == jfold.iir_tail_length(jchain.sos)
    np.testing.assert_allclose(tfold.chain_impulse_response(tchain, 500),
                               jfold.chain_impulse_response(jchain, 500),
                               rtol=0, atol=1e-15)
    k_t = tfold.fold_chain_into_kernel(tchain, ir)
    k_j = jfold.fold_chain_into_kernel(jchain, ir)
    assert k_t.shape == k_j.shape
    np.testing.assert_allclose(k_t, k_j, rtol=0, atol=1e-12)
    conv = tfold.folded_convolver(tchain, ir, 10)
    assert conv.kernel_len == k_t.size and conv.latency == B
    with pytest.raises(ValueError):
        tfold.iir_tail_length([[1.0, 0.0, 0.0, -1.0, 0.0]])


def _plan_fft(z, tw, inverse):
    """numpy model of csrc/fdlconv.cu's Stockham FFT with the wrapper's
    radix plan and twiddle table: stage radices, butterfly -> thread
    map, each stage's table offset and layout, output permutation."""
    M = z.size
    n16, rem, threads, _ = fdlmod.fft_plan(M)
    radices = [16] * n16 + ([rem] if rem > 1 else [])
    ns, off = 1, M
    for r in radices:
        j = np.arange(M // r)
        assert (M // r) % threads == 0   # each thread owns (M/r)/T butterflies
        jj = j % ns
        i = np.arange(r)
        v = z[j[:, None] + i[None, :] * (M // r)]
        if ns > 1:
            w = np.ones((M // r, r), complex)
            w[:, 1:] = tw[off + (i[None, 1:] - 1) * ns + jj[:, None]]
            off += (r - 1) * ns
            v = v * (np.conj(w) if inverse else w)
        v = np.fft.ifft(v, axis=1) * r if inverse else np.fft.fft(v, axis=1)
        out = np.empty_like(z)
        out[((j - jj) * r + jj)[:, None] + i[None, :] * ns] = v
        z, ns = out, ns * r
    assert off == tw.size
    return z


def test_fdl_launch_plan_every_block():
    """The kernel's launch plan for every B from 2 to 8192: the radix
    plan multiplies out to B, one FFT's threads and an FFT block fit
    the card, its exchange buffer fits shared memory, the MAC grid
    covers every frame and bin within the grid's limits; and the plan's
    index maps give numpy's rfft of a 2B-sample frame (as the B-point
    complex FFT of its sample pairs, then the split) and back."""
    rng = np.random.default_rng(9)
    for e in range(1, 14):
        M = 1 << e
        n16, rem, threads, fpb = fdlmod.fft_plan(M)
        assert 16 ** n16 * rem == M and rem in (1, 2, 4, 8) or M < 16
        assert threads == max(1, M // 16)
        assert fpb * threads <= fdlmod.MAX_BLOCK // fdlmod.FFT_RADIX
        assert fpb * (M + M // 16) * 8 <= 232448
        for C, nf in ((1, 1), (8, 47), (64, 6), (8, 2048), (65535, 3)):
            G, (groups, slices, ch) = fdlmod.mac_plan(C, nf, M)
            assert G in (1, 2, 4, 8, 16) and groups * G >= nf > (groups - 1) * G
            assert slices * fdlmod.MAC_THREADS >= M + 1 and ch == C
            assert groups < 2 ** 31 and slices < 65536 and ch < 65536
        tw = fdlmod.twiddle_table(M).astype(np.float64)
        tw = tw[:, 0] + 1j * tw[:, 1]
        x = rng.standard_normal(2 * M)
        Z = _plan_fft(x[0::2] + 1j * x[1::2], tw, inverse=False)
        k = np.arange(M + 1)
        zk, zm = Z[k % M], np.conj(Z[(M - k) % M])
        X = (zk + zm) / 2 + np.append(tw[:M], -1.0) * (-0.5j) * (zk - zm)
        # the table is float32: the maps are right to its rounding
        ref = np.fft.rfft(x)
        assert np.linalg.norm(X - ref) <= 1e-6 * np.linalg.norm(ref)
        n = np.arange(M)
        Zi = (X[n] + np.conj(X[M - n])) + 1j * (X[n] - np.conj(X[M - n])) * np.conj(tw[:M])
        z = _plan_fft(Zi, tw, inverse=True) / (2 * M)
        x_back = np.stack([z.real, z.imag], -1).reshape(-1)
        assert np.linalg.norm(x_back - x) <= 1e-6 * np.linalg.norm(x)
