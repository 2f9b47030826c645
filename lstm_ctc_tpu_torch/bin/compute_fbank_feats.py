"""Compute log-mel filterbank features from WAVs (Kaldi compute-fbank-feats).

Port of ``bin/compute-fbank-feats.py``, with the same flags and
specifiers:

    python -m lstm_ctc_tpu_torch.bin.compute_fbank_feats \\
        [--config=conf/fbank.conf] [--num-mel-bins=23] ... \\
        scp:wav.scp <out-wspecifier>

wav.scp entries are rxfilenames: plain .wav paths or pipes
("sph2pipe -f wav x.sph |").
"""

from __future__ import annotations

import sys

from ..host import kaldi
from ..host import logging_util as log
from ..host.data.features import compute_fbank
from ..host.featbin import load_config_file, parse_kaldi_flags, read_wave

SPEC = {
    "config": (str, ""),
    "num_mel_bins": (int, 23),
    "sample_frequency": (float, 16000.0),
    "frame_length": (float, 25.0),
    "frame_shift": (float, 10.0),
    "dither": (float, 1.0),
    "preemphasis_coefficient": (float, 0.97),
    "window_type": (str, "povey"),
    "low_freq": (float, 20.0),
    "high_freq": (float, 0.0),
    "use_energy": (bool, False),
    "snip_edges": (bool, True),
    "seed": (int, 0),
}


def main(argv=None) -> None:
    opts, args = parse_kaldi_flags(sys.argv[1:] if argv is None else argv,
                                   SPEC)
    if opts["config"]:
        load_config_file(opts, SPEC, opts["config"])
    if len(args) != 2:
        log.die("usage: compute-fbank-feats.py [opts] scp:wav.scp <wspec>")
    wav_src, out_wspec = args
    if not wav_src.startswith("scp:"):
        log.die("wav input must be an scp: rspecifier, got %r" % wav_src)

    done = 0
    with kaldi.TableWriter(out_wspec, "matrix") as writer:
        with open(wav_src[4:]) as fh:
            for line in fh:
                parts = line.strip().split(None, 1)
                if len(parts) != 2:
                    continue
                key, rxfilename = parts
                wave, rate = read_wave(rxfilename)
                if abs(rate - opts["sample_frequency"]) > 1.0:
                    log.die("sample rate %.0f != expected %.0f for %s"
                            % (rate, opts["sample_frequency"], key))
                feats = compute_fbank(
                    wave,
                    sample_freq=opts["sample_frequency"],
                    num_mel_bins=opts["num_mel_bins"],
                    frame_length_ms=opts["frame_length"],
                    frame_shift_ms=opts["frame_shift"],
                    dither=opts["dither"],
                    preemph_coeff=opts["preemphasis_coefficient"],
                    window_type=opts["window_type"],
                    low_freq=opts["low_freq"],
                    high_freq=opts["high_freq"],
                    use_energy=opts["use_energy"],
                    snip_edges=opts["snip_edges"],
                    seed=opts["seed"] or None,
                )
                writer.Write(key, feats)
                done += 1
                if done % 500 == 0:
                    log.info("processed %d utterances" % done)
    log.info("computed fbank features for %d utterances" % done)


if __name__ == "__main__":
    main()
