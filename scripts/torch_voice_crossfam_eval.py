#!/usr/bin/env python
"""Cross-family keyword-spotting evaluation on the port: the counterpart of
scripts/voice_crossfam_eval.py.

The spotter's templates come from the formant-additive synthesizer
(family 1, ``voice_frontend.synthesize_word``).  This eval feeds it clips
from the source-filter LPC family (family 2, ``voice_synth2``): a
different production model (time-domain glottal-pulse + IIR cascade,
coarticulated formant glides, prosody), not a re-parameterization of the
training generator.  The spotter's features are extracted on
``--device``.  Run from the repository root:

    python3 scripts/torch_voice_crossfam_eval.py                # the card
    python3 scripts/torch_voice_crossfam_eval.py --device cpu

Writes ``metrics.json`` under ``--out`` (default
``runs/torch_voice_crossfam``, kept out of git): the JAX script's keys
(speaker matrix, confusions, SNR sweep, discrete-echo rooms, the
false-accept rate on family-2 babble, phrase accuracy through the full
segmentation pipeline), plus ``device`` and ``seconds``.  ``confusions``
lists the wrong words (``word->prediction``); the JAX script's record
holds the names of its tally's fields there instead.  ``--words`` cuts the
vocabulary words per cell for a quick run.
"""
import itertools
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

# the spotter, arguments and output of the held-out eval (this directory
# is the script's first path entry)
from torch_voice_offdist_eval import parse_args, setup, write  # noqa: E402

# nonsense Spanish-like babble (valid phoneme inventory, not in the
# vocabulary) for the false-accept arm
_BABBLE = ["tomale", "pedrina", "casote", "lamito", "rekato", "silupa"]


def main(argv=None):
    from opendog_tpu_torch.apps.voice_frontend import _PHONEMES
    from opendog_tpu_torch.apps.voice_synth2 import (lpc_synthesize_phrase,
                                                     lpc_synthesize_word)

    args = parse_args(argv, "runs/torch_voice_crossfam")
    start = time.perf_counter()
    spotter, words, line = setup(args)   # templates: family 1, untouched

    def accuracy(**kw):
        """Three-outcome tally: the garbage-model rejection makes
        no-decision a distinct (safe) outcome from a wrong word."""
        ok = wrong = rej = n = 0
        misses = []
        for w, seed in itertools.product(words, range(args.seeds)):
            clip = lpc_synthesize_word(w, seed=500 + seed, **kw)
            pred, _ = spotter.classify(clip)
            n += 1
            if pred == w:
                ok += 1
            elif pred is None:
                rej += 1
            else:
                wrong += 1
                misses.append(f"{w}->{pred}")
        return round(ok / n, 3), dict(wrong=round(wrong / n, 3),
                                      rejected=round(rej / n, 3),
                                      misses=misses)

    res = {"vocabulary_size": len(words), "seeds_per_cell": args.seeds,
           "template_family": "formant-additive (voice_frontend)",
           "eval_family": "source-filter LPC (voice_synth2)"}

    # --- cross-family speaker matrix ---
    matrix, all_misses = {}, []
    for fs in (0.92, 1.0, 1.08):
        for f0, rate in ((95.0, 0.85), (130.0, 1.0), (175.0, 1.1),
                         (210.0, 1.0)):
            key = f"formant{fs}_f0{int(f0)}_rate{rate}"
            matrix[key], m = accuracy(formant_scale=fs, f0=f0, rate=rate)
            all_misses += m["misses"]
            print(key, matrix[key], m, flush=True)
    res["speaker_matrix"] = matrix
    res["speaker_matrix_min"] = min(matrix.values())
    res["speaker_matrix_mean"] = round(
        float(np.mean(list(matrix.values()))), 3)
    res["confusions"] = sorted(set(all_misses))

    # --- SNR sweep ---
    snr_rows = []
    for noise in (0.02, 0.05, 0.1, 0.2):
        sig = lpc_synthesize_word(words[min(1, len(words) - 1)], seed=500)
        snr_db = round(float(10 * np.log10(
            np.mean(sig ** 2) / noise ** 2)), 1)
        acc, _ = accuracy(noise=noise, f0=130.0)
        snr_rows.append(dict(noise_sigma=noise, approx_snr_db=snr_db,
                             accuracy=acc))
        print(f"noise {noise} (~{snr_db} dB): {acc}", flush=True)
    res["snr_sweep"] = snr_rows

    # --- discrete-echo room ---
    res["room_120ms"], _ = accuracy(room=0.12, f0=125.0)
    res["room_250ms"], _ = accuracy(room=0.25, f0=140.0, rate=0.95)

    # --- false accepts on family-2 babble (speech-like audio that is NOT
    # a command: the spotter must reject, not nearest-match) ---
    for w in _BABBLE:
        _PHONEMES.setdefault(w, list(w))
    fa = 0
    for w, seed in itertools.product(_BABBLE, range(2)):
        clip = lpc_synthesize_word(w, f0=120.0, seed=700 + seed)
        pred, _ = spotter.classify(clip)
        fa += int(pred is not None)
    res["false_accept_rate_babble"] = round(fa / (2 * len(_BABBLE)), 3)

    # --- phrase-level: full stream segmentation + wake-word grammar ---
    phrases = [(["perrito", "camina"], "perrito camina"),
               (["perrito", "para"], "perrito para"),
               (["perrito", "derecha"], "perrito derecha")]
    ok = 0
    for ws, want in phrases:
        got = spotter.transcribe(lpc_synthesize_phrase(ws, f0=125.0,
                                                       seed=90))
        ok += int(got == want)
        print(f"phrase {want!r} -> {got!r}", flush=True)
    res["phrase_accuracy"] = round(ok / len(phrases), 3)

    res["device"] = line
    res["seconds"] = time.perf_counter() - start
    write(args, res)


if __name__ == "__main__":
    main()
