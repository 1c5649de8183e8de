"""Second, independent keyword-audio family: source-filter LPC synthesis.

VERDICT r4 item 3: the voice robustness evals held out PARAMETERS of the
same formant-additive synthesizer that built the spotter's templates
(`voice_frontend.synthesize_word`).  This module is a generator from a
DIFFERENT production model, so `scripts/voice_crossfam_eval.py` can test
the untouched spotter on audio whose generative family it never saw —
the in-repo analog of the reference feeding real Whisper real microphone
audio (examples/voice_detect.py:17-33).

Structural differences from the template family (voice_frontend.py):

  family 1 (templates)              family 2 (this module)
  -------------------------------   --------------------------------------
  additive harmonic bank per        time-domain source-filter: excitation
  steady-state segment, formant     signal filtered through a CASCADE of
  envelope sampled at harmonics     2nd-order all-pole resonators (IIR)
  two formants (F1, F2), fixed      four formants + bandwidths, targets
  per phone, no transitions         COARTICULATED (linear glide between
                                    phone targets over ~35 ms)
  flat f0 per word                  declination + penultimate-syllable
                                    stress prosody (Spanish default)
  sinusoid phases randomized,       glottal-pulse train (lowpassed
  no glottal model                  impulse source) + radiation (first
                                    difference)
  fricatives/bursts = FFT-masked    fricatives/bursts = white noise
  white noise (freq domain)         through the SAME IIR cascade
  reverb = exponential-decay        room = sparse discrete-echo impulse
  noise impulse response            response (image-method style)

Phone durations, formant tables, stop loci and trill rates are also set
independently (values from standard acoustic-phonetics ranges, not copied
from voice_frontend's tables).

A copy of the JAX package's ``apps/voice_synth2.py`` (which imports no
JAX): numpy and scipy's ``lfilter``.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
from scipy.signal import lfilter

from .voice import _normalize

SR = 16000
FRAME_S = 0.005          # coefficient update interval (5 ms)

# vowel targets: (F1, F2, F3) Hz — four-formant cascade with F4 fixed
_VOWELS: Dict[str, Tuple[float, float, float]] = {
    "a": (730.0, 1330.0, 2400.0),
    "e": (460.0, 1990.0, 2500.0),
    "i": (300.0, 2300.0, 2800.0),
    "o": (470.0, 1030.0, 2400.0),
    "u": (330.0, 800.0, 2300.0),
}
_F4 = 3350.0
_BW = (90.0, 120.0, 160.0, 200.0)   # formant bandwidths

# consonant spec: kind, (F1,F2,F3) tract target (the coarticulation
# locus), duration [s], voiced fraction
_CONS: Dict[str, Tuple[str, Tuple[float, float, float], float, float]] = {
    "p": ("stop", (300.0, 800.0, 2100.0), 0.055, 0.0),
    "t": ("stop", (300.0, 1800.0, 2600.0), 0.055, 0.0),
    "k": ("stop", (300.0, 2100.0, 2400.0), 0.060, 0.0),
    "d": ("stop", (250.0, 1700.0, 2550.0), 0.045, 1.0),
    "g": ("stop", (250.0, 1900.0, 2350.0), 0.050, 1.0),
    "s": ("fric", (320.0, 1600.0, 5600.0), 0.095, 0.0),
    "z": ("fric", (320.0, 1500.0, 5200.0), 0.090, 0.0),
    "c": ("affr", (320.0, 1900.0, 2900.0), 0.095, 0.0),   # "ch"
    "m": ("nasal", (260.0, 1150.0, 2450.0), 0.075, 1.0),
    "n": ("nasal", (290.0, 1450.0, 2600.0), 0.075, 1.0),
    "r": ("tap", (490.0, 1350.0, 2200.0), 0.060, 1.0),
    "l": ("lat", (380.0, 1500.0, 2600.0), 0.070, 1.0),
    "q": ("stop", (300.0, 2100.0, 2400.0), 0.060, 0.0),
}

_VOWEL_DUR = 0.115
_TRANS_S = 0.035          # coarticulation glide length


def _syllable_starts(phones: List[str]) -> List[int]:
    """Indices of phones that begin a (vowel-cored) syllable — enough to
    place penultimate stress."""
    vowel_pos = [i for i, p in enumerate(phones) if p in _VOWELS]
    return vowel_pos


def _resonator(f_hz: float, bw_hz: float):
    """2nd-order all-pole section (b, a) at SR."""
    r = np.exp(-np.pi * bw_hz / SR)
    th = 2.0 * np.pi * f_hz / SR
    a = np.array([1.0, -2.0 * r * np.cos(th), r * r])
    # unity gain at the resonance
    b = np.array([1.0 - 2.0 * r * np.cos(th) + r * r + 1e-6])
    return b, a


def _glottal_train(n: int, f0_traj: np.ndarray,
                   rng: np.random.Generator) -> np.ndarray:
    """Lowpassed impulse train following a per-sample f0 trajectory, with
    ~0.6% period jitter — a time-domain glottal source (no sinusoids)."""
    phase = np.cumsum(f0_traj) / SR
    pulses = np.zeros(n)
    marks = np.flatnonzero(np.diff(np.floor(
        phase * (1.0 + 0.006 * rng.standard_normal(n)[0])
    )) > 0)
    # re-jitter each mark by up to half a ms
    jit = (rng.uniform(-0.5e-3, 0.5e-3, marks.shape) * SR).astype(int)
    marks = np.clip(marks + jit, 0, n - 1)
    pulses[marks] = 1.0
    # glottal flow shaping: two cascaded one-pole lowpasses (-12 dB/oct)
    gp = np.exp(-2.0 * np.pi * 250.0 / SR)
    b, a = np.array([1.0 - gp]), np.array([1.0, -gp])
    return lfilter(b, a, lfilter(b, a, pulses))


def lpc_synthesize_word(word: str, f0: float = 120.0, rate: float = 1.0,
                        noise: float = 0.0, seed: int = 0,
                        formant_scale: float = 1.0,
                        room: float = 0.0) -> np.ndarray:
    """Synthesize one vocabulary word with the source-filter family.

    Same knob vocabulary as family 1 (`f0`, `rate`, `noise`,
    `formant_scale`) so the cross-family eval can sweep matched speaker
    axes; ``room`` > 0 convolves a sparse discrete-echo impulse response
    of that length [s]."""
    word = _normalize(word)
    from .voice_frontend import _PHONEMES  # shared spelling->phones map

    phones = list(_PHONEMES[word])
    rng = np.random.default_rng(seed)

    # --- frame-level target tracks (coarticulated) -----------------------
    # Each phone contributes a (targets, dur, voiced, kind) block; formant
    # tracks glide linearly between consecutive blocks over _TRANS_S.
    blocks = []
    i = 0
    while i < len(phones):
        ph = phones[i]
        if ph in _VOWELS:
            blocks.append((np.array(_VOWELS[ph]), _VOWEL_DUR / rate,
                           1.0, "vowel", ph))
        else:
            kind, tgt, dur, voiced = _CONS[ph]
            if ph == "r" and i + 1 < len(phones) and phones[i + 1] == "r":
                i += 1
                blocks.append((np.array(tgt), 2.3 * dur / rate, voiced,
                               "trill", "rr"))
            else:
                blocks.append((np.array(tgt), dur / rate, voiced,
                               kind, ph))
        i += 1

    n_fr_blocks = [max(2, int(round(d / FRAME_S))) for _, d, _, _, _ in
                   blocks]
    total_fr = sum(n_fr_blocks)
    F = np.zeros((total_fr, 3))
    voiced_fr = np.zeros(total_fr)
    kind_fr: List[str] = []
    k = 0
    for (tgt, _, v, kind, _), nf in zip(blocks, n_fr_blocks):
        F[k:k + nf] = tgt
        voiced_fr[k:k + nf] = v
        kind_fr += [kind] * nf
        k += nf
    # coarticulation: glide each block boundary over the transition window
    gl = max(1, int(_TRANS_S / FRAME_S))
    edges = np.cumsum(n_fr_blocks)[:-1]
    for e in edges:
        lo, hi = max(0, e - gl // 2), min(total_fr, e + gl // 2 + 1)
        w = np.linspace(0.0, 1.0, hi - lo)[:, None]
        F[lo:hi] = F[max(0, lo - 1)] * (1 - w) + F[min(total_fr - 1, hi)] * w
    F *= formant_scale

    # --- prosody: declination + penultimate stress ------------------------
    syl = _syllable_starts(phones)
    stress_vowel = syl[-2] if len(syl) >= 2 else syl[-1]
    # which frames belong to the stressed vowel's block
    blk_of_phone = []
    bi = 0
    for j in range(len(phones)):
        if phones[j] == "r" and j > 0 and phones[j - 1] == "r":
            blk_of_phone.append(bi - 1)  # merged trill block
            continue
        blk_of_phone.append(bi)
        bi += 1
    sb = blk_of_phone[stress_vowel]
    fr0 = sum(n_fr_blocks[:sb])
    fr1 = fr0 + n_fr_blocks[sb]
    t_fr = np.linspace(0.0, 1.0, total_fr)
    f0_fr = f0 * (1.08 - 0.22 * t_fr)            # declination
    f0_fr[fr0:fr1] *= 1.14                        # stress accent
    dur_fr = np.full(total_fr, FRAME_S)
    n_per_fr = (dur_fr * SR).astype(int)
    n = int(n_per_fr.sum())

    # --- sources ----------------------------------------------------------
    f0_samp = np.repeat(f0_fr, n_per_fr)
    voiced_samp = np.repeat(voiced_fr, n_per_fr)
    voice_src = _glottal_train(n, f0_samp, rng) * voiced_samp
    noise_src = rng.standard_normal(n) * 0.05

    # per-frame source gains by phone kind
    av = np.ones(total_fr)
    an = np.zeros(total_fr)
    for j, kind in enumerate(kind_fr):
        if kind == "fric":
            av[j], an[j] = 0.0, 1.0
        elif kind == "affr":
            av[j], an[j] = 0.0, 0.8
        elif kind == "nasal":
            av[j] = 0.55
        elif kind == "lat":
            av[j] = 0.8
    # stops need frame-position context: rebuild per block
    k = 0
    for (tgt, _, v, kind, ph), nf in zip(blocks, n_fr_blocks):
        if kind in ("stop", "affr"):
            nclo = int(0.6 * nf)
            av[k:k + nclo] = 0.12 * v       # voice bar if voiced
            an[k:k + nclo] = 0.0
            an[k + nclo:k + nf] = 1.0       # release burst / frication
            av[k + nclo:k + nf] = 0.3 * v
        if kind == "trill":
            # 26 Hz contact interruptions carved into the voicing gain
            tt = np.arange(nf) * FRAME_S
            av[k:k + nf] = np.where(np.sin(2 * np.pi * 26.0 * tt) > 0.1,
                                    1.0, 0.15)
        if kind == "tap":
            av[k + nf // 3:k + max(nf // 3 + 1, 2 * nf // 3)] = 0.15
        k += nf

    # --- time-varying cascade filter --------------------------------------
    out = np.zeros(n)
    zis = [np.zeros(2) for _ in range(4)]
    pos = 0
    for j in range(total_fr):
        m = n_per_fr[j]
        seg = (av[j] * voice_src[pos:pos + m]
               + an[j] * noise_src[pos:pos + m])
        freqs = list(F[j]) + [_F4]
        for sec, (fc, bw) in enumerate(zip(freqs, _BW)):
            fc = min(fc, 0.45 * SR)
            b, a = _resonator(fc, bw)
            seg, zis[sec] = lfilter(b, a, seg, zi=zis[sec])
        out[pos:pos + m] = seg
        pos += m
    # radiation characteristic (+6 dB/oct): first difference
    out = np.diff(out, prepend=0.0)

    if room > 0.0:
        # sparse discrete echoes (image-method flavor), not noise decay
        ir = np.zeros(int(room * SR) + 1)
        ir[0] = 1.0
        for _ in range(6):
            d = rng.integers(int(0.008 * SR), len(ir))
            ir[d] += rng.uniform(0.15, 0.45) * np.exp(-3.0 * d / len(ir))
        out = np.convolve(out, ir)[:n]

    out = out / (np.abs(out).max() + 1e-9)
    if noise > 0:
        out = out + rng.normal(0.0, noise, out.shape)
    return out.astype(np.float32)


def lpc_synthesize_phrase(words: Sequence[str], gap_s: float = 0.25,
                          **kw) -> np.ndarray:
    """Concatenate family-2 keywords with silence gaps."""
    gap = np.zeros(int(gap_s * SR), np.float32)
    out = [gap]
    seed = int(kw.pop("seed", 0))
    for k, w in enumerate(words):
        out.append(lpc_synthesize_word(w, seed=seed + 31 * k, **kw))
        out.append(gap)
    return np.concatenate(out)
