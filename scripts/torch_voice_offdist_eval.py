#!/usr/bin/env python
"""Off-distribution keyword-spotting evaluation on the port: the
counterpart of scripts/voice_offdist_eval.py.

The KeywordSpotter's templates (opendog_tpu_torch/apps/voice_frontend.py)
are built from the formant synthesizer at three (f0, rate) speaker
settings with NO formant shift, NO vibrato, NO reverb and NO noise.  This
eval measures detection accuracy on audio the template builder never
produces, with the spotter's features extracted on ``--device``:

  * held-out speaker axes: formant scale (vocal-tract length) x pitch x
    rate x vibrato x room reverb — parameters outside the template set;
  * additive-noise SNR sweep (accuracy vs SNR dB);
  * false-accept check on pure noise bursts.

The synthesizer family is shared (same phoneme model); the cross-family
eval (scripts/torch_voice_crossfam_eval.py) changes it.  Run from the
repository root:

    python3 scripts/torch_voice_offdist_eval.py                 # the card
    python3 scripts/torch_voice_offdist_eval.py --device cpu

Writes ``metrics.json`` under ``--out`` (default
``runs/torch_voice_offdist``, kept out of git): the JAX script's keys, plus
``device`` (the card's name and power limit, or ``cpu``) and ``seconds``
(host, the whole run).  ``--words`` / ``--noise_bursts`` cut the
vocabulary words per cell and the noise bursts (defaults: all 9, 20) for a
quick run; the spotter keeps every template.
"""
import argparse
import itertools
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def parse_args(argv, out):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=out)
    ap.add_argument("--seeds", type=int, default=2)
    ap.add_argument("--words", type=int, default=None,
                    help="vocabulary words per cell (default: all)")
    ap.add_argument("--noise_bursts", type=int, default=20)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    return ap.parse_args(argv)


def setup(args):
    """(spotter, the words of each cell, the device's line) on
    ``args.device``."""
    from opendog_tpu_torch.apps.voice_frontend import (VOCABULARY,
                                                       KeywordSpotter)
    from opendog_tpu_torch.device import card_line, resolve_device

    dev = resolve_device(args.device)
    spotter = KeywordSpotter(device=dev)
    words = list(VOCABULARY)[:args.words]
    line = card_line() if dev.type == "cuda" else "cpu"
    return spotter, words, line


def write(args, res):
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "metrics.json"), "w") as f:
        json.dump(res, f, indent=2)
    print(json.dumps({k: v for k, v in res.items()
                      if k not in ("speaker_matrix", "confusions")}),
          flush=True)


def main(argv=None):
    from opendog_tpu_torch.apps.voice_frontend import (_noise_band,
                                                       synthesize_word)

    args = parse_args(argv, "runs/torch_voice_offdist")
    start = time.perf_counter()
    spotter, words, line = setup(args)

    def accuracy(**synth_kw):
        ok = n = 0
        for w, seed in itertools.product(words, range(args.seeds)):
            clip = synthesize_word(w, seed=100 + seed, **synth_kw)
            pred, _ = spotter.classify(clip)
            ok += int(pred == w)
            n += 1
        return round(ok / n, 3)

    res = {"vocabulary_size": len(words), "seeds_per_cell": args.seeds}

    # --- held-out speaker matrix: formant scale x (f0, rate) ---
    matrix = {}
    for fs in (0.88, 0.94, 1.06, 1.12):
        for f0, rate in ((90.0, 0.85), (170.0, 1.2), (210.0, 1.0)):
            key = f"formant{fs}_f0{int(f0)}_rate{rate}"
            matrix[key] = accuracy(formant_scale=fs, f0=f0, rate=rate)
            print(key, matrix[key], flush=True)
    res["speaker_matrix"] = matrix
    res["speaker_matrix_min"] = min(matrix.values())
    res["speaker_matrix_mean"] = round(
        float(np.mean(list(matrix.values()))), 3)

    # --- vibrato + reverb arms (never in templates) ---
    res["vibrato_0.5st"] = accuracy(vibrato=0.5, f0=140.0)
    res["reverb_120ms"] = accuracy(reverb_s=0.12, f0=125.0, rate=1.05)
    res["vibrato_and_reverb"] = accuracy(vibrato=0.4, reverb_s=0.08,
                                         f0=160.0, rate=0.9,
                                         formant_scale=1.06)

    # --- SNR sweep (white noise; signal is peak-normalized to 1) ---
    snr_rows = []
    for noise in (0.02, 0.05, 0.1, 0.2, 0.3):
        sig = synthesize_word(words[0], seed=100)
        snr_db = round(float(10 * np.log10(
            np.mean(sig ** 2) / noise ** 2)), 1)
        acc = accuracy(noise=noise, f0=135.0, rate=1.1)
        snr_rows.append(dict(noise_sigma=noise, approx_snr_db=snr_db,
                             accuracy=acc))
        print(f"noise {noise} (~{snr_db} dB): {acc}", flush=True)
    res["snr_sweep"] = snr_rows

    # --- stress: push until it degrades ---
    stress = {}
    for fs in (0.8, 1.25, 1.4):
        stress[f"formant{fs}"] = accuracy(formant_scale=fs, f0=140.0)
    for noise in (0.5, 0.8, 1.2):
        sig = synthesize_word(words[0], seed=100)
        snr_db = round(float(10 * np.log10(
            np.mean(sig ** 2) / noise ** 2)), 1)
        stress[f"noise{noise}_snr{snr_db}dB"] = accuracy(
            noise=noise, f0=135.0)
    stress["worst_combo"] = accuracy(formant_scale=1.2, vibrato=0.6,
                                     reverb_s=0.15, noise=0.3,
                                     f0=185.0, rate=1.25)
    res["stress"] = stress

    # --- false accepts on non-speech noise bursts ---
    rng = np.random.default_rng(0)
    fa = 0
    for _ in range(args.noise_bursts):
        center = rng.uniform(300, 3000)
        clip = _noise_band(center, rng.uniform(0.2, 0.5), rng)
        clip = clip / (np.abs(clip).max() + 1e-9)
        pred, _ = spotter.classify(clip.astype(np.float32))
        fa += int(pred is not None)
    res["false_accept_rate_noise"] = round(fa / max(1, args.noise_bursts), 3)

    res["device"] = line
    res["seconds"] = time.perf_counter() - start
    write(args, res)


if __name__ == "__main__":
    main()
