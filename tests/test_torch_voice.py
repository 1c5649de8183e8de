"""The port's voice front end (``opendog_tpu_torch/apps/voice*.py``)
against the JAX package's on the CPU.

* ``_log_mel_fixed``: within 1e-4 (absolute; the MFCCs reach ~50) on
  seeded synthesized words with the noise of the off-template speakers of
  ``tests/test_voice_frontend.py`` (0.02-0.03).  On noise-free words the
  zero closures of stop consonants leave frames nearly silent, where the
  log of a tiny mel energy magnifies FFT rounding: JAX's own float32 FFT
  reads up to ~5e-4 from a float64 one there.  The port transforms in
  float64, so there it is held within 1e-3 of JAX and within 1e-5 of the
  float64 reference.
* ``synthesize_word``, ``lpc_synthesize_word``, ``synthesize_phrase`` and
  ``segment_stream`` are numpy copies: equal bit for bit.
* The spotter's decisions: every vocabulary word at the two off-template
  speakers, and the transcripts of tests/test_voice_frontend.py:83-113's
  phrases, equal the JAX spotter's, scores within 1e-4.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opendog_tpu.apps import voice as jvoice
from opendog_tpu.apps import voice_frontend as jvf
from opendog_tpu.apps import voice_synth2 as js2
from opendog_tpu_torch.apps import voice, voice_frontend as vf, voice_synth2

torch.set_num_threads(1)

SPEAKERS = ((125.0, 1.05, 0.02, 1), (100.0, 0.95, 0.03, 2))
PHRASES = ((["perrito", "camina"], dict(f0=140.0, rate=1.08, noise=0.02,
                                        seed=11)),
           (["perrito", "para"], dict(f0=105.0, rate=0.92, noise=0.03,
                                      seed=12)),
           (["camina"], dict(f0=120.0, seed=13)),
           (["perrito", "izquierda"], dict(f0=130.0, seed=21)),
           (["perrito", "para"], dict(f0=120.0, seed=4)))


def _value(command):
    """A command's word (the two packages have an enum each)."""
    return None if command is None else command.value


def _padded(clip):
    n = int(vf.SEG_PAD_S * vf.SR)
    a = np.zeros(n, np.float32)
    a[:min(len(clip), n)] = clip[:n]
    return a, 1 + (n - vf.FRAME) // vf.HOP


def _float64_mfcc(a, n_frames):
    idx = np.arange(n_frames)[:, None] * vf.HOP + np.arange(vf.FRAME)
    frames = a[idx] * np.hanning(vf.FRAME).astype(np.float32)
    spec = (np.abs(np.fft.rfft(frames.astype(np.float64), axis=-1)) ** 2
            ).astype(np.float32)
    return np.log(spec @ vf._FB.T + 1e-6) @ vf._DCT.T


@pytest.mark.parametrize("word", jvf.VOCABULARY)
def test_log_mel_fixed_matches_jax(word):
    i = jvf.VOCABULARY.index(word)
    for f0, rate, noise, seed in SPEAKERS:
        a, n = _padded(jvf.synthesize_word(word, f0=f0 + 3 * i, rate=rate,
                                           noise=noise, seed=seed + i))
        want = np.asarray(jvf._log_mel_fixed(jnp.asarray(a), n))
        got = vf._log_mel_fixed(torch.from_numpy(a), n).numpy()
        assert got.shape == want.shape == (n, vf.N_MFCC)
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    # noise-free (a template): near-silent frames
    a, n = _padded(jvf.synthesize_word(word, f0=130.0, seed=17))
    got = vf._log_mel_fixed(torch.from_numpy(a), n).numpy()
    np.testing.assert_allclose(got, np.asarray(jvf._log_mel_fixed(
        jnp.asarray(a), n)), atol=1e-3, rtol=0)
    np.testing.assert_allclose(got, _float64_mfcc(a, n), atol=1e-5, rtol=0)


def test_log_mel_normalises_on_the_host_as_jax():
    clip = jvf.synthesize_word("derecha", f0=118.0, noise=0.02, seed=5)
    got, want = vf.log_mel(clip, device="cpu"), jvf.log_mel(clip)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    short = clip[:2000]                  # fewer live frames than the pad
    assert vf.log_mel(short, device="cpu").shape == jvf.log_mel(short).shape


@pytest.mark.parametrize("word", jvf.VOCABULARY)
def test_synthesizers_and_segmentation_are_copies(word):
    for kw in (dict(f0=125.0, rate=1.05, noise=0.02, seed=1),
               dict(formant_scale=1.1, vibrato=0.4, reverb_s=0.08, seed=31)):
        np.testing.assert_array_equal(vf.synthesize_word(word, **kw),
                                      jvf.synthesize_word(word, **kw))
    for kw in (dict(f0=130.0, seed=500), dict(room=0.12, noise=0.05,
                                              formant_scale=0.92, seed=7)):
        np.testing.assert_array_equal(
            voice_synth2.lpc_synthesize_word(word, **kw),
            js2.lpc_synthesize_word(word, **kw))
    audio = vf.synthesize_phrase(["perrito", word], f0=120.0, seed=4)
    np.testing.assert_array_equal(
        audio, jvf.synthesize_phrase(["perrito", word], f0=120.0, seed=4))
    assert vf.segment_stream(audio) == jvf.segment_stream(audio)
    np.testing.assert_array_equal(
        voice_synth2.lpc_synthesize_phrase(["perrito", word], seed=90),
        js2.lpc_synthesize_phrase(["perrito", word], seed=90))


@pytest.fixture(scope="module")
def spotters():
    return jvf.KeywordSpotter(), vf.KeywordSpotter(device="cpu")


def test_spotter_classifies_as_jax(spotters):
    jsp, tsp = spotters
    for w in jvf.VOCABULARY:
        for f0, rate, noise, seed in SPEAKERS:
            clip = jvf.synthesize_word(w, f0=f0, rate=rate, noise=noise,
                                       seed=seed)
            (jw, js), (tw, ts) = jsp.classify(clip), tsp.classify(clip)
            assert tw == jw == w
            assert abs(ts - js) < 1e-4
    rng = np.random.default_rng(0)
    noise = rng.normal(0, 1, 8000).astype(np.float32)
    assert tsp.classify(noise)[0] is jsp.classify(noise)[0] is None


def test_transcripts_and_commands_equal_jax(spotters):
    jsp, tsp = spotters
    for words, kw in PHRASES:
        audio = jvf.synthesize_phrase(words, **kw)
        text = tsp.transcribe(audio)
        assert text == jsp.transcribe(audio), words
        assert _value(voice.parse_command(text)) == _value(
            jvoice.parse_command(text))
    text = vf.make_dtw_transcriber(device="cpu")(
        jvf.synthesize_phrase(["perrito", "izquierda"], f0=130.0, seed=21))
    fsm = voice.VoiceGaitMachine()
    assert fsm.apply(voice.parse_command(text)) == \
        voice.GaitMode.TURNING_LEFT


def test_voice_parser_and_machine_are_copies():
    for t in ("perrito camina", "PERRITO, a la derecha!", "perrito párate",
              "camina", "perrito hola", "perrito siéntate", "perrito para"):
        assert _value(voice.parse_command(t)) == _value(
            jvoice.parse_command(t)), t
    m, jm = voice.VoiceGaitMachine(), jvoice.VoiceGaitMachine()
    for c in jvoice.RobotCommand:
        assert m.apply(voice.RobotCommand(c.value)).value == \
            jm.apply(c).value
        assert m.target_yaw_delta() == jm.target_yaw_delta()
