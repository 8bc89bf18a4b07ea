"""The plans and summation orders of the two adjoint kernels, modelled in
numpy on the CPU (the kernels themselves run only on the card, where
chip_smoke.py holds them to their plain versions).

- `envscan.adjoint_plan` (csrc/envelope.cu, `envelope_adjoint`): every
  sample of a channel falls in exactly one (block, segment, chunk), the
  segment fits shared memory, a cluster only where 2 C <= SMs. A numpy
  model of the kernel's composition (chunk maps, the exclusive scan over
  the later chunks, part maps composed in reverse rank order from
  g_final, the walk from each chunk's carry) matches
  `envelope_adjoint_plain` in float64 (>= 200 dB).
- `fdlconv.spectra_adjoint_plan` (csrc/fdlconv.cu,
  `fdl_spectra_adjoint`): every lag falls in one group of G, the grid
  fills the card where the lags allow. A numpy model of the kernel's
  lag-group walk with its register window, in the kernel's summation
  order (four roundings a term, terms in (c, f) order), matches
  `fdl_spectra_adjoint_plain` in float64 (>= 250 dB) and gives the same
  bits for every G, so the sums do not depend on G.

No JAX here: the plain versions are the references, and
tests/test_torch_grad.py holds those to `jax.grad`.
"""

import tests.torch_port_setup  # noqa: F401  (first: one PyTorch thread)

import numpy as np
import pytest
import torch

from algodsp_tpu_torch.ops import envscan, fdlconv
from tests.conftest import snr_db

SMS = 132  # H100 SXM


# -- A3: envelope_adjoint ---------------------------------------------------

def _segments(t, plan):
    """(rank, segment start, segment length) of every segment of a
    channel, as the kernel walks them (ranks in order, segments first to
    last)."""
    seg, _, _, blocks = plan
    part = -(-t // blocks)
    out = []
    for rank in range(blocks):
        pbase = rank * part
        plen = min(part, t - pbase)
        for j in range(-(-plen // seg)):
            out.append((rank, pbase + j * seg, min(seg, plen - j * seg)))
    return out


ENV_SHAPES = {
    # (t, channels, itemsize)
    "flagship": [(48128, 8, 4), (48128, 8, 8), (48131, 8, 4)],
    "chain": [(512, 64, 4), (512, 64, 8)],
    "one block": [(48128, SMS // 2 + 1, 4), (1 << 16, 128, 4), (333, 65, 4)],
    "long": [(1 << 20, 2, 4), (1 << 20, 2, 8), (1 << 22, 1, 4)],
    "edge": [(1, 8, 4), (2, 1, 8), (15, 3, 4), (2047, 8, 4), (2048, 8, 4),
             (15361, 4, 4), (4096 * 8 + 1, 8, 8)],
}


@pytest.mark.parametrize("group", list(ENV_SHAPES))
def test_envelope_adjoint_plan_covers_every_sample_once(group):
    """Each sample lies in one (block, segment, chunk); a segment's x,
    env_prev and cotangent fit ENV_SMEM_BYTES, each array with a
    16-byte unit of slack for its alignment shift; threads are whole
    warps, at most 1024, enough for the segment's chunks of L (odd, at
    least ENV_MIN_CHUNK); clusters of at most 8 blocks, each with
    samples, only where 2 C <= SMs."""
    for t, c, itemsize in ENV_SHAPES[group]:
        seg, length, threads, blocks = envscan.adjoint_plan(t, c, SMS, itemsize)
        vec = 16 // itemsize
        assert 3 * (-(-seg // vec) + 1) * vec * itemsize <= envscan.ENV_SMEM_BYTES
        assert length % 2 == 1 and length >= envscan.ENV_MIN_CHUNK
        assert threads % 32 == 0 and 32 <= threads <= envscan.ENV_MAX_THREADS
        assert threads * length >= seg
        assert 1 <= blocks <= envscan.ADJ_MAX_CLUSTER
        assert blocks == 1 or 2 * c <= SMS
        part = -(-t // blocks)
        assert (blocks - 1) * part < t and seg <= part
        hits = np.zeros(t, np.int64)
        for _, start, n in _segments(t, (seg, length, threads, blocks)):
            # the segment's chunks of L tile it: the last one holds 1 .. L
            assert 1 <= n <= seg and -(-n // length) <= threads
            hits[start:start + n] += 1
        assert np.all(hits == 1), (t, c, itemsize)


def test_envelope_adjoint_plan_spreads_the_flagship():
    """The flagship's 8 channels run on clusters of 8 blocks (64 SMs),
    each block one 6016-sample segment (72 KB in float32) in chunks of
    15; C = SMs / 2 + 1 takes one block a channel; 2^20 samples at C = 2
    span several segments a block."""
    assert envscan.adjoint_plan(48128, 8, SMS, 4) == (6016, 15, 416, 8)
    assert envscan.adjoint_plan(48128, SMS // 2 + 1, SMS, 4)[3] == 1
    seg, _, _, blocks = envscan.adjoint_plan(1 << 20, 2, SMS, 4)
    assert blocks == 8 and -(-(1 << 20) // blocks) > seg


def _env_adjoint_model(x, traj, env0, att, rel, g, gf, plan):
    """The kernel's composition in float64: per segment the chunks' maps
    (carry_out = A carry_in + W, walked backward) and the exclusive
    composition over the later chunks; in a cluster each part's map
    composed from its segments first to last, and the carry entering
    part b from g_final through parts B-1 .. b+1; then each segment,
    last to first, walked chunk by chunk from its carry."""
    seg, length, threads, blocks = plan
    c_n, t = x.shape
    dx = np.empty_like(x)
    denv0, datt, drel = (np.empty(c_n) for _ in range(3))
    for c in range(c_n):
        ep = np.concatenate([[env0[c]], traj[c, :-1]])
        sel = x[c] > ep
        coef = np.where(sel, att[c], rel[c])
        delta = x[c] - ep

        def chunks(base, n):
            k = -(-n // length)
            assert k <= threads
            pad = lambda v: np.concatenate([v[base:base + n],
                                            np.zeros(k * length - n)]).reshape(k, length)
            return k, pad(coef), pad(g[c]), pad(delta), pad(sel.astype(float))

        def maps(base, n):
            k, cf, gg, _, _ = chunks(base, n)
            a_, w_ = np.ones(k), np.zeros(k)
            for i in range(length - 1, -1, -1):
                s = gg[:, i] + w_
                w_ = s - cf[:, i] * s
                a_ = a_ * (1.0 - cf[:, i])
            ea, ew = np.empty(k), np.empty(k)
            ta, tw = 1.0, 0.0
            for q in range(k - 1, -1, -1):
                ea[q], ew[q] = ta, tw
                ta, tw = a_[q] * ta, a_[q] * tw + w_[q]
            return ea, ew, (ta, tw)

        segs = _segments(t, plan)
        carry_in = [gf[c]] * blocks
        if blocks > 1:
            part_maps = []
            for rank in range(blocks):
                pa, pw = 1.0, 0.0
                for _, base, n in (s for s in segs if s[0] == rank):
                    ta, tw = maps(base, n)[2]
                    pa, pw = pa * ta, pa * tw + pw
                part_maps.append((pa, pw))
            for rank in range(blocks):
                v = gf[c]
                for q in range(blocks - 1, rank, -1):
                    v = part_maps[q][0] * v + part_maps[q][1]
                carry_in[rank] = v
        sums = [0.0, 0.0]
        for rank in range(blocks):
            cin = carry_in[rank]
            for _, base, n in reversed([s for s in segs if s[0] == rank]):
                ea, ew, _ = maps(base, n)
                k, cf, gg, dl, sl = chunks(base, n)
                carry = ea * cin + ew
                out = np.zeros((k, length))
                for i in range(length - 1, -1, -1):
                    valid = np.arange(k) * length + i < n
                    s = gg[:, i] + carry
                    out[:, i] = cf[:, i] * s
                    sd = np.where(valid, s * dl[:, i], 0.0)
                    sums[0] += float(np.sum(np.where(sl[:, i] > 0, sd, 0.0)))
                    sums[1] += float(np.sum(np.where(sl[:, i] > 0, 0.0, sd)))
                    carry = np.where(valid, s - cf[:, i] * s, carry)
                dx[c, base:base + n] = out.reshape(-1)[:n]
                cin = carry[0]
            if rank == 0:
                denv0[c] = cin
        datt[c], drel[c] = sums
    return dx, denv0, datt, drel


@pytest.mark.parametrize("case", ["cluster", "cluster in segments", "one block"])
def test_envelope_adjoint_cluster_model_matches_plain(case, rng):
    """The model of the kernel's composition against
    `envelope_adjoint_plain` in float64, >= 200 dB on every output: a
    cluster of 8 from the plan (T no multiple of the part or of L), a
    cluster of 3 whose parts span three segments each, and one block in
    segments."""
    c, t = {"cluster": (1, 16411), "cluster in segments": (2, 6301),
            "one block": (3, 5003)}[case]
    plan = {"cluster": envscan.adjoint_plan(t, c, SMS, 8),
            "cluster in segments": (701, 15, 64, 3),
            "one block": (1668, 15, 128, 1)}[case]
    if case == "cluster":
        assert plan[3] == 8 and t % -(-t // 8) and t % plan[1]
    x = np.abs(rng.standard_normal((c, t)))
    env0 = rng.uniform(0.0, 0.5, c)
    att, rel = rng.uniform(0.05, 0.5, c), rng.uniform(1e-4, 0.02, c)
    _, traj = envscan.envelope_scan_plain(*(torch.as_tensor(v) for v in (x, env0, att, rel)))
    traj = traj.numpy()
    g, gf = rng.standard_normal((c, t)), rng.standard_normal(c)
    ref = envscan.envelope_adjoint_plain(
        *(torch.as_tensor(v) for v in (x, traj, env0, att, rel, g, gf)))
    got = _env_adjoint_model(x, traj, env0, att, rel, g, gf, plan)
    for r, m in zip(ref, got):
        assert snr_db(r.numpy(), m) >= 200, case


# -- A1 dH: fdl_spectra_adjoint -----------------------------------------------

SPEC_SHAPES = {
    # (C, nf, B, P)
    "IR learning": [(8, 47, 1024, 32)],
    "folded": [(8, 2048, 8192, 17)],
    "edge": [(1, 1, 1024, 3), (3, 6, 1024, 5), (5, 4, 256, 10), (2, 40, 8192, 13),
             (1, 8, 2, 1), (7, 3, 16, 2)],
}


@pytest.mark.parametrize("group", list(SPEC_SHAPES))
def test_spectra_adjoint_plan_groups_every_lag_once(group):
    """G is a power of two up to SPEC_ADJ_MAX_G; the lag groups cover
    every lag 0 .. P-1 once and the bin slices every bin; the grid gives
    every SM a block wherever a smaller G could; a frame spectrum is read
    ceil(P / G) times (once a group), against P before."""
    bins = fdlconv.SPEC_ADJ_THREADS
    for c, nf, b, p in SPEC_SHAPES[group]:
        G, (slices, groups) = fdlconv.spectra_adjoint_plan(nf, b, p, SMS)
        assert G in (1, 2, 4, 8) and G <= fdlconv.SPEC_ADJ_MAX_G
        assert slices * bins >= b + 1 > (slices - 1) * bins
        lags = np.concatenate([np.arange(q * G, min((q + 1) * G, p))
                               for q in range(groups)])
        assert np.array_equal(lags, np.arange(p))
        useful = -(-min(p, nf) // G)
        assert G == 1 or slices * useful >= SMS
    assert fdlconv.spectra_adjoint_plan(47, 1024, 32, SMS) == (4, (17, 8))
    assert fdlconv.spectra_adjoint_plan(2048, 8192, 17, SMS)[0] == 8


def _spectra_model(X, dV, P, G):
    """The kernel's lag-group walk in float64, vectorised over bins: for
    each group of G lags and each channel, steps u = f - p0 in groups of
    G; X[c, u] enters slot u mod G of the window; lag j adds
    dV[c, p0 + u] conj(X[c, u - j]) for u >= j as four roundings
    (re + vr xr, + vi xi; im + vi xr, - vr xi; float32 products are exact
    in float64). Returns the sums (P, B+1) complex before the weight."""
    xr, xi = X[..., 0].astype(np.float64), X[..., 1].astype(np.float64)
    vr, vi = dV[..., 0].astype(np.float64), dV[..., 1].astype(np.float64)
    c_n, nf, k = xr.shape
    out = np.zeros((P, k), np.complex128)
    for p0 in range(0, P, G):
        re, im = np.zeros((G, k)), np.zeros((G, k))
        steps = nf - p0
        wr, wi = np.zeros((G, k)), np.zeros((G, k))
        for c in range(c_n):
            for u0 in range(0, max(steps, 0), G):
                for q in range(G):
                    u = u0 + q
                    if u >= steps:
                        break
                    wr[q], wi[q] = xr[c, u], xi[c, u]
                    a, b = vr[c, p0 + u], vi[c, p0 + u]
                    for j in range(G):
                        if u0 == 0 and q < j:
                            continue
                        s = (q - j) % G
                        re[j] = re[j] + a * wr[s]
                        re[j] = re[j] + b * wi[s]
                        im[j] = im[j] + b * wr[s]
                        im[j] = im[j] - a * wi[s]
        for j in range(G):
            if p0 + j < P:
                out[p0 + j] = re[j] + 1j * im[j]
    return out


@pytest.mark.parametrize("shape", [(3, 11, 16, 6), (1, 1, 8, 3), (2, 9, 32, 13)],
                         ids=["odd C, G not dividing P", "nf = 1", "P > nf"])
def test_spectra_adjoint_model_matches_plain_for_every_G(shape, rng):
    """The model against `fdl_spectra_adjoint_plain` in float64 on float32
    inputs (>= 250 dB after the weight w_k; rows p >= nf zero), and the
    same bits for every G the plan can choose: the sums' order does not
    depend on G."""
    c, nf, b, p = shape
    X = rng.standard_normal((c, nf, b + 1, 2)).astype(np.float32)
    dV = rng.standard_normal((c, nf, b + 1, 2)).astype(np.float32)
    ref = fdlconv.fdl_spectra_adjoint_plain(torch.as_tensor(X).double(),
                                            torch.as_tensor(dV).double(), p).numpy()
    w = np.full(b + 1, 1.0 / b)
    w[0] = w[b] = 0.5 / b
    sums = {G: _spectra_model(X, dV, p, G) for G in (1, 2, 4, 8)}
    for G, s in sums.items():
        assert np.array_equal(s.view(np.int64), sums[1].view(np.int64)), G
    got = sums[1] * w
    got = np.stack([got.real, got.imag], -1)
    got[:, [0, b], 1] = 0.0
    assert snr_db(ref, got) >= 250
    assert not np.any(got[nf:])
