"""Kaldi conf-file compatibility: parse ``conf/mfcc.conf`` /
``conf/vad.conf`` flag files into the port's typed configs (counterpart of
``xvector_tpu/utils/kaldi_conf.py``).

The reference passes these files verbatim to Kaldi binaries
(``run.sh:97-101``, ``conf/mfcc.conf:1-6``, ``conf/vad.conf:1-4``); parsing
them here lets an existing recipe checkout drive the front end unedited.
"""

from __future__ import annotations

from typing import Dict

from ..ops.features import MfccConfig, VadConfig

__all__ = ["parse_conf", "mfcc_config_from_conf", "vad_config_from_conf"]


def parse_conf(path: str) -> Dict[str, str]:
    """``--key=value  # comment`` lines → {key: value}."""
    out: Dict[str, str] = {}
    with open(path) as f:
        for line in f:
            line = line.split("#", 1)[0].strip()
            if not line.startswith("--"):
                continue
            key, _, value = line[2:].partition("=")
            out[key.strip()] = value.strip()
    return out


def _get(conf, key, cast, default):
    if key not in conf:
        return default
    v = conf[key]
    if cast is bool:
        return v.lower() in ("true", "yes", "1")
    return cast(v)


def mfcc_config_from_conf(path: str) -> MfccConfig:
    c = parse_conf(path)
    d = MfccConfig()
    return MfccConfig(
        sample_rate=_get(c, "sample-frequency", int, d.sample_rate),
        frame_length_ms=_get(c, "frame-length", float, d.frame_length_ms),
        frame_shift_ms=_get(c, "frame-shift", float, d.frame_shift_ms),
        num_ceps=_get(c, "num-ceps", int, d.num_ceps),
        num_mel_bins=_get(c, "num-mel-bins", int, d.num_mel_bins),
        low_freq=_get(c, "low-freq", float, d.low_freq),
        high_freq=_get(c, "high-freq", float, d.high_freq),
        preemph=_get(c, "preemphasis-coefficient", float, d.preemph),
        dither=_get(c, "dither", float, d.dither),
        remove_dc_offset=_get(c, "remove-dc-offset", bool,
                              d.remove_dc_offset),
        window_type=_get(c, "window-type", str, d.window_type),
        raw_energy=_get(c, "raw-energy", bool, d.raw_energy),
        use_energy=_get(c, "use-energy", bool, d.use_energy),
        energy_floor=_get(c, "energy-floor", float, d.energy_floor),
        cepstral_lifter=_get(c, "cepstral-lifter", float,
                             d.cepstral_lifter),
        snip_edges=_get(c, "snip-edges", bool, d.snip_edges),
    )


def vad_config_from_conf(path: str) -> VadConfig:
    c = parse_conf(path)
    d = VadConfig()
    return VadConfig(
        energy_threshold=_get(c, "vad-energy-threshold", float,
                              d.energy_threshold),
        energy_mean_scale=_get(c, "vad-energy-mean-scale", float,
                               d.energy_mean_scale),
        proportion_threshold=_get(c, "vad-proportion-threshold", float,
                                  d.proportion_threshold),
        frames_context=_get(c, "vad-frames-context", int,
                            d.frames_context),
    )
