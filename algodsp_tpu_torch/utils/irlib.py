"""Built-in synthetic impulse responses (counterpart of `builtin_irs` and
`hrtf_ir_set` in `algodsp_tpu/utils/irlib.py`; host-side float64 NumPy,
identical to them).

The `.irlib` container's reader and writer and the HRTF file helpers
are queued in ROADMAP.md; `hrtf_ir_set` is here because the built-in set
includes its two crossfeed paths.
"""

from __future__ import annotations

from functools import lru_cache as _lru_cache

import numpy as np


@_lru_cache(maxsize=8)
def builtin_irs(sample_rate: float = 48000.0,
                seed: int = 20260816) -> dict[str, tuple[float, np.ndarray]]:
    """Synthetic IR set (the analog of the embedded .irlib data):
    exponentially decaying noise with per-band decay shaping.

    Cached per (sample_rate, seed) — the synthesis includes a
    per-sample Python one-pole over ~400k samples, and the demo's IR
    endpoints hit this on every request. Callers must treat the
    returned dict and arrays as read-only."""
    rng = np.random.default_rng(seed)
    out = {}
    specs = {
        "small-room": (0.25, 6000.0),
        "medium-hall": (1.2, 4000.0),
        "large-hall": (2.5, 3000.0),
        "plate": (1.8, 10000.0),
        "spring": (0.9, 2500.0),
    }
    for name, (rt60, damp_hz) in specs.items():
        n = int(rt60 * 1.2 * sample_rate)
        t = np.arange(n) / sample_rate
        noise = rng.standard_normal(n)
        env = 10.0 ** (-3.0 * t / rt60)
        # crude HF damping: one-pole lowpass whose cutoff tracks damp_hz
        a = np.exp(-2 * np.pi * damp_hz / sample_rate)
        ir = np.empty(n)
        acc = 0.0
        for i in range(n):
            acc = (1 - a) * noise[i] + a * acc
            ir[i] = acc
        ir *= env
        ir[0] = 1.0  # direct path
        out[name] = (sample_rate, (ir / np.abs(ir).max()).astype(np.float32))
    # HRTF crossfeed paths (spherical-head model, `hrtf_ir_set`) so the
    # demo catalog can audition speaker-style crossfeed as a conv IR
    hrtf = hrtf_ir_set(sample_rate)
    for name, key in (("hrtf-direct-30deg", "left_direct"),
                      ("hrtf-crossfeed-30deg", "left_cross")):
        out[name] = (sample_rate, hrtf[key].astype(np.float32))
    return out


def hrtf_ir_set(sample_rate: float = 48000.0, *,
                speaker_angle_deg: float = 30.0,
                head_radius_m: float = 0.0875,
                n_taps: int = 256) -> dict[str, np.ndarray]:
    """Deterministic spherical-head HRTF IR set for stereo-speaker
    crosstalk simulation — a default implementation of the reference's
    `HRTFProvider` interface (`crosstalk_simulator_hrtf.go:20-30`).
    Note the reference ships NO measured HRTF data: its provider is an
    interface the caller must implement, and its own tests feed tiny
    synthetic sets (`crosstalk_simulator_hrtf_test.go:9-39`
    fixedHRTFProvider). This physical model therefore EXCEEDS reference
    parity; users with measured data (e.g. MIT KEMAR, which cannot be
    bundled in this zero-egress build) load it through the `.irlib`
    container via `hrtf_ir_set_from_irlib`.

    Model (Brown & Duda 1998 structural HRTF, public formulation):

      * head shadow: the one-pole/one-zero sphere approximation
        H(w, th) = (1 + j a(th) w / (2 w0)) / (1 + j w / (2 w0)) with
        w0 = c / r_head and a(th) = 1.05 + 0.95 cos(th * 180/150 deg),
        th the incidence angle between the source ray and the ear axis
        (ipsilateral boost ~+6 dB HF, contralateral shadow ~ -20 dB HF);
      * ITD: Woodworth ray model, T(th) = -(r/c) cos th on the lit side
        and (r/c)(th - pi/2) in the shadow zone, applied as a linear
        phase ramp (sub-sample accurate);
      * ears on the +-90 deg axis; speakers at +-speaker_angle_deg, so
        the direct path hits at |90 - angle| and the cross path at
        |90 + angle| incidence.

    Returns the reference's `HRTFImpulseResponseSet` fields as a dict:
    {"left_direct", "left_cross", "right_direct", "right_cross"},
    float64 arrays of n_taps samples each. By symmetry left_direct ==
    right_direct and left_cross == right_cross for a centered head;
    both are still emitted so asymmetric sets can drop in unchanged.
    """
    if sample_rate <= 0 or not np.isfinite(sample_rate):
        raise ValueError(f"hrtf: sample rate must be > 0: {sample_rate}")
    c = 343.0                      # speed of sound, m/s
    r = head_radius_m
    w0 = c / r
    # causality headroom: the Woodworth ITD on the lit side is an
    # ADVANCE of up to r/c seconds (th -> 0), so the base delay must
    # cover it at any sample rate / speaker angle or the main impulse
    # wraps out of the irfft window and is truncated
    base_delay = r / c + 4.0 / sample_rate

    freqs = np.fft.rfftfreq(2 * n_taps, 1.0 / sample_rate)
    w = 2.0 * np.pi * freqs

    def path_ir(incidence_deg: float) -> np.ndarray:
        th = np.radians(incidence_deg)
        alpha = 1.05 + 0.95 * np.cos(th * 180.0 / 150.0)
        shadow = (1.0 + 1j * alpha * w / (2.0 * w0)) / \
                 (1.0 + 1j * w / (2.0 * w0))
        if th < np.pi / 2.0:
            itd = -(r / c) * np.cos(th)
        else:
            itd = (r / c) * (th - np.pi / 2.0)
        phase = np.exp(-1j * w * (base_delay + itd))
        h = np.fft.irfft(shadow * phase, 2 * n_taps)[:n_taps]
        # cosine fade over the last 16 taps kills wrap-around ripple
        fade = np.ones(n_taps)
        fade[-16:] = 0.5 * (1.0 + np.cos(np.linspace(0, np.pi, 16)))
        return h * fade

    direct = path_ir(abs(90.0 - speaker_angle_deg))
    cross = path_ir(abs(90.0 + speaker_angle_deg))
    return {"left_direct": direct.copy(), "left_cross": cross.copy(),
            "right_direct": direct, "right_cross": cross}
