"""Network-free speech front-end: audio → keyword text for the voice FSM.

The reference runs streaming Whisper ASR with a Spanish wake word and an
8-command vocabulary (``examples/voice_detect.py:17-33``,
``udp_voice.py:248-325``).  Whisper needs a model download this image can't
make, so this module implements the capability self-contained:

  * ``synthesize_word`` — formant-based Spanish keyword synthesis (glottal
    harmonic source shaped by vowel formants, plus burst/fricative/trill
    consonant models).  Generates both the matcher's templates and,
    perturbed in pitch/rate/noise, independent test clips.
  * ``log_mel`` — the feature extractor on a torch device: 25 ms Hann
    frames, rFFT, 64-band mel filterbank (one matmul), log compression,
    per-clip normalization.
  * ``KeywordSpotter`` — DTW template matching over the log-mel sequences:
    energy-based segmentation of the stream, then per-segment dynamic time
    warping against a few synthesized templates per vocabulary word.  The
    DTW recurrence itself is a tiny (≤70×70) sequential host-side loop;
    the compute-heavy part (feature extraction) is the device path.
  * ``make_dtw_transcriber`` — drop-in for ``voice.make_transcriber``:
    audio → "perrito camina" → ``voice.parse_command`` → gait machine.

Port of the JAX package's ``apps/voice_frontend.py``.  The synthesis, DTW,
segmentation and ``KeywordSpotter`` are its numpy, copied unchanged; the
jitted ``_log_mel_fixed`` is torch on the caller's device (CUDA unless
``device="cpu"``): the frame gather, the symmetric Hann window of
``jnp.hanning`` (``_WINDOW``), ``torch.fft.rfft`` and the two products in
full float32.  The transform alone runs in float64, its power rounded to
float32.  In a nearly silent frame (the zero closure of a stop consonant)
the log of a tiny mel energy magnifies rounding: there JAX's float32 FFT
reads up to ~5e-4 from a float64 one in an MFCC, and PyTorch's float32 FFT
up to ~7e-4 from JAX's (on the CPU).  In float64 the transform's rounding
no longer shows, on any device; on frames above that floor the port reads
~1e-5 from JAX.  ``log_mel``'s normalisation stays on the host, as in the
JAX package.
"""
from __future__ import annotations

from functools import lru_cache
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import resolve_device, use_full_fp32
from .voice import ACTIVATION_WORD, RobotCommand, _normalize

SR = 16000
FRAME = 400           # 25 ms
HOP = 160             # 10 ms
N_MELS = 64
SEG_PAD_S = 1.2       # fixed per-segment feature length (one shape)

VOCABULARY: Tuple[str, ...] = (ACTIVATION_WORD,) + tuple(
    c.value for c in RobotCommand
)

# ---------------------------------------------------------------------------
# Keyword synthesis (formant model)
# ---------------------------------------------------------------------------

# Spanish vowel formants (F1, F2) in Hz — standard phonetics tables.
_VOWELS: Dict[str, Tuple[float, float]] = {
    "a": (700.0, 1300.0),
    "e": (450.0, 1900.0),
    "i": (280.0, 2250.0),
    "o": (450.0, 900.0),
    "u": (310.0, 750.0),
}

# Consonant models: (kind, param).  kinds: burst (center freq), fric
# (noise band), nasal (murmur freq), trill (AM rate on voicing), lat
# (vowel-like with fixed formants), approx (soft voiced transition)
_CONSONANTS: Dict[str, Tuple[str, float]] = {
    "p": ("burst", 800.0),
    "t": ("burst", 3500.0),
    "k": ("burst", 2000.0),
    "d": ("burst", 1200.0),
    "g": ("burst", 1500.0),
    "s": ("fric", 6000.0),
    "c": ("fric", 3000.0),   # "ch" mapped to c
    "m": ("nasal", 250.0),
    "n": ("nasal", 300.0),
    "r": ("trill", 28.0),
    "l": ("lat", 0.0),
    "z": ("fric", 5500.0),
    "q": ("burst", 2000.0),
}

# keyword → phoneme list (normalized spelling; "ch" → "c", "rr" → "R"
# handled as a longer trill, silent "u" in "qu" dropped)
_PHONEMES: Dict[str, List[str]] = {
    "perrito": ["p", "e", "r", "r", "i", "t", "o"],
    "camina": ["k", "a", "m", "i", "n", "a"],
    "para": ["p", "a", "r", "a"],
    "derecha": ["d", "e", "r", "e", "c", "a"],
    "izquierda": ["i", "z", "k", "i", "e", "r", "d", "a"],
    "parate": ["p", "a", "r", "a", "t", "e"],
    "sientate": ["s", "i", "e", "n", "t", "a", "t", "e"],
    "agachate": ["a", "g", "a", "c", "a", "t", "e"],
    "apagate": ["a", "p", "a", "g", "a", "t", "e"],
}


def _vowel(f1: float, f2: float, dur_s: float, f0: float,
           rng: np.random.Generator, formant_scale: float = 1.0,
           vibrato: float = 0.0) -> np.ndarray:
    """Voiced segment: harmonic series of f0 with formant-shaped
    amplitudes (two Gaussian resonances).  ``formant_scale`` shifts the
    resonances (vocal-tract length change); ``vibrato`` is a 5 Hz pitch
    modulation depth in semitones — both are OFF-DISTRIBUTION knobs the
    keyword templates are never built with (held-out speaker eval,
    scripts/voice_offdist_eval.py)."""
    f1, f2 = f1 * formant_scale, f2 * formant_scale
    n = int(dur_s * SR)
    t = np.arange(n) / SR
    sig = np.zeros(n)
    if vibrato > 0.0:
        # phase-integrated FM: f0(t) = f0 * 2^(vibrato/12 * sin(2pi 5 t))
        ratio = 2.0 ** (vibrato / 12.0 * np.sin(2 * np.pi * 5.0 * t))
        base_phase = 2 * np.pi * np.cumsum(f0 * ratio) / SR
    else:
        base_phase = 2 * np.pi * f0 * t
    for k in range(1, int(4000 / f0)):
        f = k * f0
        amp = (np.exp(-0.5 * ((f - f1) / 120.0) ** 2)
               + 0.7 * np.exp(-0.5 * ((f - f2) / 180.0) ** 2)
               + 0.02)
        sig += amp * np.sin(k * base_phase + rng.uniform(0, 2 * np.pi))
    # gentle onset/offset to avoid clicks
    env = np.minimum(1.0, np.minimum(np.arange(n), n - np.arange(n)) / 160.0)
    return sig * env


def _noise_band(center: float, dur_s: float,
                rng: np.random.Generator) -> np.ndarray:
    """Band-limited noise via FFT masking (fricatives/bursts)."""
    n = int(dur_s * SR)
    spec = np.fft.rfft(rng.normal(0, 1, n))
    freqs = np.fft.rfftfreq(n, 1 / SR)
    mask = np.exp(-0.5 * ((freqs - center) / (0.25 * center + 200)) ** 2)
    return np.fft.irfft(spec * mask, n)


def synthesize_word(word: str, f0: float = 120.0, rate: float = 1.0,
                    noise: float = 0.0, seed: int = 0,
                    formant_scale: float = 1.0, vibrato: float = 0.0,
                    reverb_s: float = 0.0) -> np.ndarray:
    """Synthesize one vocabulary word at SR=16 kHz.  ``f0``/``rate`` vary
    the speaker; ``noise`` adds white noise (SNR control for tests).

    ``formant_scale``/``vibrato``/``reverb_s`` are OFF-DISTRIBUTION
    perturbations (vocal-tract shift, pitch modulation, exponential-decay
    room reverb) never used when building the spotter's templates — the
    held-out speaker axes of scripts/voice_offdist_eval.py."""
    word = _normalize(word)
    phones = _PHONEMES[word]
    rng = np.random.default_rng(seed)
    pieces: List[np.ndarray] = []
    i = 0
    while i < len(phones):
        ph = phones[i]
        # double-r → long trill
        if ph == "r" and i + 1 < len(phones) and phones[i + 1] == "r":
            i += 1
            trill_dur = 0.14 / rate
        else:
            trill_dur = 0.07 / rate
        if ph in _VOWELS:
            f1, f2 = _VOWELS[ph]
            pieces.append(_vowel(f1, f2, 0.12 / rate, f0, rng,
                                 formant_scale, vibrato))
        else:
            kind, prm = _CONSONANTS[ph]
            if kind == "burst":
                pieces.append(np.zeros(int(0.03 / rate * SR)))  # closure
                pieces.append(0.8 * _noise_band(prm, 0.025 / rate, rng))
            elif kind == "fric":
                pieces.append(0.5 * _noise_band(prm, 0.09 / rate, rng))
            elif kind == "nasal":
                pieces.append(0.6 * _vowel(prm, 2.5 * prm, 0.08 / rate,
                                           f0, rng, formant_scale,
                                           vibrato))
            elif kind == "trill":
                v = _vowel(500.0, 1400.0, trill_dur, f0, rng,
                           formant_scale, vibrato)
                am = 0.5 * (1 + np.sign(np.sin(
                    2 * np.pi * prm * np.arange(len(v)) / SR)))
                pieces.append(v * am)
            elif kind == "lat":
                pieces.append(_vowel(360.0, 1600.0, 0.07 / rate, f0, rng,
                                     formant_scale, vibrato))
        i += 1
    sig = np.concatenate(pieces)
    if reverb_s > 0.0:
        # exponential-decay impulse response (simple room model)
        ir_n = int(reverb_s * SR)
        ir = (rng.normal(0, 1, ir_n)
              * np.exp(-np.arange(ir_n) / (0.25 * ir_n)))
        ir[0] = 3.0  # direct path dominates
        sig = np.convolve(sig, ir / np.abs(ir).sum() * 3.0)[:len(sig)]
    sig = sig / (np.abs(sig).max() + 1e-9)
    if noise > 0:
        sig = sig + rng.normal(0, noise, sig.shape)
    return sig.astype(np.float32)


def synthesize_phrase(words: Sequence[str], gap_s: float = 0.25,
                      f0: float = 120.0, rate: float = 1.0,
                      noise: float = 0.0, seed: int = 0) -> np.ndarray:
    """Concatenate keywords with silence gaps (a command utterance)."""
    rng = np.random.default_rng(seed + 1)
    gap = np.zeros(int(gap_s * SR), np.float32)
    out = [gap]
    for k, w in enumerate(words):
        out.append(synthesize_word(w, f0=f0, rate=rate, noise=noise,
                                   seed=seed + 13 * k))
        out.append(gap)
    sig = np.concatenate(out)
    if noise > 0:
        sig = sig + rng.normal(0, noise, sig.shape).astype(np.float32)
    return sig


# ---------------------------------------------------------------------------
# log-mel features on a torch device
# ---------------------------------------------------------------------------

def _mel_filterbank(n_fft: int = FRAME, n_mels: int = N_MELS,
                    fmin: float = 60.0, fmax: float = 7600.0) -> np.ndarray:
    def hz_to_mel(f):
        return 2595.0 * np.log10(1.0 + f / 700.0)

    def mel_to_hz(m):
        return 700.0 * (10.0 ** (m / 2595.0) - 1.0)

    mels = np.linspace(hz_to_mel(fmin), hz_to_mel(fmax), n_mels + 2)
    freqs = mel_to_hz(mels)
    bins = np.fft.rfftfreq(n_fft, 1 / SR)
    fb = np.zeros((n_mels, len(bins)), np.float32)
    for i in range(n_mels):
        lo, c, hi = freqs[i], freqs[i + 1], freqs[i + 2]
        up = (bins - lo) / (c - lo)
        down = (hi - bins) / (hi - c)
        fb[i] = np.clip(np.minimum(up, down), 0.0, None)
    return fb


_FB = _mel_filterbank()
N_MFCC = 13


def _dct_matrix(n_out: int, n_in: int) -> np.ndarray:
    """Orthonormal DCT-II rows 1..n_out (c0 dropped: it carries level, and
    dropping it + the DCT smoothing discards pitch harmonics — the reason
    MFCCs, not raw mels, are the DTW feature)."""
    k = np.arange(1, n_out + 1)[:, None]
    n = np.arange(n_in)[None, :]
    return (np.sqrt(2.0 / n_in)
            * np.cos(np.pi * k * (2 * n + 1) / (2 * n_in))).astype(np.float32)


_DCT = _dct_matrix(N_MFCC, N_MELS)
# jnp.hanning's symmetric window, rounded once from float64 on the host so
# that every device multiplies by the same values: near its ends the window
# is ~1e-5, where a float32 cosine (jnp.hanning's, or torch.hann_window's on
# either device) is relatively far off, and a frame whose sound lies there
# carries that error into its log energies
_WINDOW = np.hanning(FRAME).astype(np.float32)


@lru_cache(maxsize=None)
def _tables(device: torch.device):
    """The window, the mel filterbank and the DCT on ``device``, made once
    per device."""
    return (torch.from_numpy(_WINDOW).to(device),
            torch.from_numpy(_FB).to(device),
            torch.from_numpy(_DCT).to(device))


def _log_mel_fixed(audio: torch.Tensor, n_frames: int) -> torch.Tensor:
    """(n_frames*HOP + FRAME,) audio -> (n_frames, N_MFCC) MFCCs, on the
    audio's device."""
    use_full_fp32()
    dev = audio.device
    window, fb, dct = _tables(dev)
    idx = (torch.arange(n_frames, device=dev)[:, None] * HOP
           + torch.arange(FRAME, device=dev)[None, :])
    frames = audio[idx] * window
    # the transform in float64: see the module's docstring
    spec = (torch.abs(torch.fft.rfft(frames.double(), dim=-1)) ** 2).float()
    mel = spec @ fb.T
    logmel = torch.log(mel + 1e-6)
    return logmel @ dct.T                    # (frames, N_MFCC)


def log_mel(audio: np.ndarray, pad_s: float = SEG_PAD_S,
            device=None) -> np.ndarray:
    """MFCC+delta features on a fixed-shape window (pads/truncates to
    ``pad_s`` so every call has one shape).  The MFCCs are computed on
    ``device`` (CUDA unless ``device="cpu"``).  Returns a single
    (live_frames, 2*N_MFCC) numpy array: per-coefficient-normalized MFCCs
    over the frames covering real (unpadded) audio, concatenated with
    their delta features."""
    dev = resolve_device(device)
    n = int(pad_s * SR)
    a = np.zeros(n, np.float32)
    m = min(len(audio), n)
    a[:m] = audio[:m]
    n_frames = 1 + (n - FRAME) // HOP
    feats = _log_mel_fixed(torch.from_numpy(a).to(dev),
                           n_frames).cpu().numpy()
    live = min(n_frames, max(2, 1 + (m - FRAME) // HOP))
    mfcc = feats[:live]
    # per-coefficient normalization over the REAL frames only (padding
    # excluded), then delta features
    mfcc = (mfcc - mfcc.mean(0)) / (mfcc.std(0) + 1e-6)
    delta = np.diff(mfcc, axis=0, prepend=mfcc[:1])
    return np.concatenate([mfcc, delta], axis=-1)


# ---------------------------------------------------------------------------
# DTW keyword matching
# ---------------------------------------------------------------------------

def dtw_distance(a: np.ndarray, b: np.ndarray) -> float:
    """Path-length-normalized DTW over feature sequences (Ta, D), (Tb, D).
    Tiny sequential recurrence (≤70² cells) — deliberately host-side; the
    heavy lifting (features) is the device path."""
    ta, tb = len(a), len(b)
    # local cost: cosine distance (robust to residual level differences)
    an = a / (np.linalg.norm(a, axis=1, keepdims=True) + 1e-9)
    bn = b / (np.linalg.norm(b, axis=1, keepdims=True) + 1e-9)
    cost = 1.0 - an @ bn.T
    D = np.full((ta + 1, tb + 1), np.inf)
    D[0, 0] = 0.0
    for i in range(1, ta + 1):
        for j in range(1, tb + 1):
            D[i, j] = cost[i - 1, j - 1] + min(
                D[i - 1, j], D[i, j - 1], D[i - 1, j - 1])
    return float(D[ta, tb] / (ta + tb))


def segment_stream(audio: np.ndarray, min_gap_s: float = 0.12,
                   min_seg_s: float = 0.12,
                   thresh_ratio: float = 0.08) -> List[Tuple[int, int]]:
    """Energy-based utterance segmentation: frames whose RMS exceeds
    ``thresh_ratio`` x peak RMS are speech; gaps shorter than ``min_gap_s``
    are bridged."""
    n_frames = max(1, 1 + (len(audio) - FRAME) // HOP)
    rms = np.array([
        np.sqrt(np.mean(audio[i * HOP:i * HOP + FRAME] ** 2))
        for i in range(n_frames)
    ])
    # threshold vs BOTH the peak (relative gate) and the noise floor
    # (20th-percentile RMS: silence gaps in a speech stream) so additive
    # noise cannot lift gaps above a purely peak-relative gate
    floor = np.percentile(rms, 20)
    thresh = max(thresh_ratio * (rms.max() + 1e-9), 2.5 * floor)
    active = rms > thresh
    segs: List[Tuple[int, int]] = []
    start = None
    gap = 0
    max_gap = int(min_gap_s * SR / HOP)
    for i, on in enumerate(active):
        if on:
            if start is None:
                start = i
            gap = 0
        elif start is not None:
            gap += 1
            if gap > max_gap:
                segs.append((start, i - gap + 1))
                start, gap = None, 0
    if start is not None:
        segs.append((start, len(active)))
    out = []
    for s, e in segs:
        s0, e0 = s * HOP, min(len(audio), e * HOP + FRAME)
        if (e0 - s0) / SR >= min_seg_s:
            out.append((s0, e0))
    return out


class KeywordSpotter:
    """DTW matcher over the fixed Spanish vocabulary.

    Templates are synthesized at a few (f0, rate) speaker settings; a
    segment is accepted as word w when its best-template distance is below
    ``threshold``, beats the runner-up word by ``margin``, and its
    FILLER-NORMALIZED score ``best / mean(all-word distances)`` is below
    ``reject_ratio``.  The ratio is the classic garbage-model rejection:
    an out-of-vocabulary utterance is roughly equidistant from every
    template (ratio -> 1) while a true keyword is distinctly closer to
    its own (measured on the cross-family eval: in-vocabulary median
    ratio 0.64, speech-like babble median 0.83 — an absolute threshold
    alone cannot separate them, scripts/voice_crossfam_eval.py).  The
    0.82 default is the measured knee: rejects half the babble set at
    zero clean-speech cost; additive noise inflates every distance
    uniformly, so heavy-noise clips trade misclassification for
    no-decision (the safe failure mode on a robot).

    The features of the templates and of every clip are extracted on
    ``device`` (CUDA unless ``device="cpu"``)."""

    def __init__(self, vocabulary: Sequence[str] = VOCABULARY,
                 template_speakers: Sequence[Tuple[float, float]] = (
                     (110.0, 1.0), (150.0, 0.9), (130.0, 1.15)),
                 threshold: float = 0.45, margin: float = 0.0,
                 reject_ratio: float = 0.82, device=None):
        self.device = resolve_device(device)
        self.vocabulary = tuple(vocabulary)
        self.threshold = threshold
        self.margin = margin
        self.reject_ratio = reject_ratio
        self.templates: Dict[str, List[np.ndarray]] = {}
        for w in self.vocabulary:
            self.templates[w] = [
                log_mel(synthesize_word(w, f0=f0, rate=r, seed=17),
                        device=self.device)
                for f0, r in template_speakers
            ]

    def classify(self, clip: np.ndarray,
                 forced: bool = False) -> Tuple[Optional[str], float]:
        """``forced=True`` is grammar-constrained decoding: skip the
        garbage-model rejection (keep only the absolute threshold) when
        context says the segment IS a vocabulary word — used for the
        segment right after the wake word, where the command prior is
        strong (the reference's Whisper pipeline likewise only parses
        the post-wake-word text, udp_voice.py:248-325)."""
        feats = log_mel(clip, device=self.device)
        scores = {
            w: min(dtw_distance(feats, t) for t in temps)
            for w, temps in self.templates.items()
        }
        ranked = sorted(scores.items(), key=lambda kv: kv[1])
        best, second = ranked[0], ranked[1]
        filler = best[1] / (np.mean(list(scores.values())) + 1e-9)
        if (best[1] > self.threshold
                or (not forced and (second[1] - best[1] < self.margin
                                    or filler > self.reject_ratio))):
            return None, best[1]
        return best[0], best[1]

    def transcribe(self, audio: np.ndarray) -> str:
        """Audio stream → space-joined recognized keywords (the text that
        feeds ``voice.parse_command``).  The segment following a
        recognized wake word decodes forced-choice (see classify)."""
        words = []
        awake = False
        for s, e in segment_stream(audio):
            w, _ = self.classify(audio[s:e], forced=awake)
            if w is not None:
                words.append(w)
            awake = w == ACTIVATION_WORD
        return " ".join(words)


def make_dtw_transcriber(**kw):
    """Network-free analog of ``voice.make_transcriber`` (Whisper): returns
    ``transcribe(audio) -> str`` over the fixed command vocabulary
    (``KeywordSpotter``'s arguments, ``device`` among them)."""
    spotter = KeywordSpotter(**kw)
    return spotter.transcribe
