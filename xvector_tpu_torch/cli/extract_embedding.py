"""Extraction CLI: features or waveforms → x-vector ark+scp.

Counterpart of ``xvector_tpu/cli/extract_embedding.py`` (the reference's
``extract_embedding.py:94-150`` + ``extract_xvectors.sh``).  It takes
exactly one input:

* ``--feats-rspecifier``: a feature ark/scp/pipe (pass ``--apply-cmvn`` /
  ``--vad-scp`` to run the preprocessing here), extracted in
  chunk-and-averaged batches;
* ``--wav-rspecifier``: a Kaldi wav.scp (``scp:`` or ``scp,p:`` prefix
  optional; WAV, SPHERE incl. embedded shorten, ``#chN``, ``cmd |``
  pipes), run through the wave front end (MFCC, energy VAD, sliding CMVN,
  voiced-frame selection) and the model on the device, one batch per
  length bucket.

It writes a Kaldi ark+scp.  Idempotent: skips when the output's ``.done``
marker exists.  The model comes from ``--model-dir``'s ``model_final``,
else from its newest complete checkpoint (``model_0`` included).  In
bf16, stats-pooling topologies run their frame stack through the fused
kernel (``ops/tdnn_kernel``); attention pooling and f32 extraction take
the unfused path.  ``--device`` (default ``cuda``) picks the device.

Instead of ``--model-dir``, ``--reference-h5`` takes a ``model.h5``
exported by the reference's TF1 trainer (``--model`` takes the TF1 class
name or a preset); it needs ``h5py``.

    python -m xvector_tpu_torch.cli.extract_embedding --model-dir=EXP \\
        --model=no_dropout --num-targets=7185 \\
        --wav-rspecifier=scp:wav.scp --output-ark=xvector.ark
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile

from ..extract.extractor import (ExtractorConfig, WaveExtractor,
                                 WaveExtractorConfig, XvectorExtractor,
                                 preprocess, read_wav_scp, speaker_means)
from ..io import kaldi_ark as kio
from ..models import tdnn
from ..ops import tdnn_kernel
from ..train import checkpoints
from ..train.trainer import TrainConfig, Trainer
from ..utils.export import import_reference_h5


def get_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--model-dir", default="",
                   help="trainer work dir (uses model_final)")
    p.add_argument("--reference-h5", default="",
                   help="instead of --model-dir: a model.h5 exported by "
                        "the reference trainer (models.py:180-214), so a "
                        "trained TF1 model migrates without retraining; "
                        "needs h5py")
    p.add_argument("--model", default="ModelWithoutDropout")
    p.add_argument("--num-targets", type=int, required=True)
    p.add_argument("--feats-rspecifier", default="",
                   help="feature ark/scp/pipe input (exclusive with "
                        "--wav-rspecifier)")
    p.add_argument("--wav-rspecifier", default="",
                   help="wav.scp input: MFCC, VAD, CMVN, voiced-frame "
                        "selection and the model run on the device, one "
                        "batch per length bucket")
    p.add_argument("--vad-scp", default="",
                   help="optional vad.scp for voiced-frame selection")
    p.add_argument("--apply-cmvn", action="store_true",
                   help="apply sliding CMVN (win 300) here")
    p.add_argument("--min-chunk-size", type=int, default=25)
    p.add_argument("--chunk-size", type=int, default=10000)
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--feat-dim", type=int, default=23)
    p.add_argument("--output-ark", required=True)
    p.add_argument("--output-scp", default="")
    p.add_argument("--spk2utt", default="",
                   help="optional spk2utt file; also writes speaker-mean "
                        "x-vectors + num_utts (ivector-mean parity, "
                        "extract_xvectors.sh:100-102)")
    p.add_argument("--num-shards", type=int, default=1,
                   help="utterance-level sharding for multi-process "
                        "extraction (extract_xvectors.sh's nj-way split)")
    p.add_argument("--shard", type=int, default=0)
    p.add_argument("--compute-dtype", default="bfloat16",
                   choices=["bfloat16", "float32"])
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def main(argv=None):
    args = get_args(argv)
    scp = args.output_scp or args.output_ark.replace(".ark", ".scp")
    if os.path.exists(scp + ".done"):
        print(f"{scp} already complete; skipping (idempotent restart)")
        return
    if bool(args.model_dir) == bool(args.reference_h5):
        sys.exit("pass exactly one of --model-dir/--reference-h5")
    if bool(args.feats_rspecifier) == bool(args.wav_rspecifier):
        sys.exit("pass exactly one of --feats-rspecifier/--wav-rspecifier")
    preset = tdnn.REFERENCE_CLASS_TO_PRESET.get(args.model, args.model)
    if preset not in tdnn.MODEL_ZOO:
        sys.exit(f"unknown model {args.model!r}")
    cfg = TrainConfig(model=preset, num_targets=args.num_targets,
                      compute_dtype="bfloat16")
    if args.reference_h5:
        # a scratch work dir (no checkpoint is read or written); it rides
        # on the trainer, so it is removed with it instead of leaking
        tmp = tempfile.TemporaryDirectory(prefix="xv_ref_h5_")
        trainer = Trainer(cfg, tmp.name, feat_dim=args.feat_dim,
                          device=args.device)
        trainer._scratch_dir = tmp
        trainer.set_params(*import_reference_h5(
            args.reference_h5, trainer.model_cfg, args.num_targets,
            device=trainer.device))
    else:
        final = os.path.join(args.model_dir, "model_final")
        if not os.path.exists(final) \
                and checkpoints.latest_complete(args.model_dir) is None:
            sys.exit(f"no checkpoint under {args.model_dir}")
        trainer = Trainer(cfg, args.model_dir, feat_dim=args.feat_dim,
                          device=args.device)
        if os.path.exists(final):
            checkpoints.restore_into(trainer, os.path.realpath(final))
        else:
            # model_0 (the initial-parameters save) counts: a run that
            # crashed in iteration 0 still extracts
            checkpoints.restore_latest(trainer)

    common = dict(min_chunk=args.min_chunk_size, max_chunk=args.chunk_size,
                  batch_size=args.batch_size,
                  compute_dtype=args.compute_dtype,
                  # K1 takes bf16 operands; an f32 run stays unfused
                  use_fused=(args.compute_dtype == "bfloat16"
                             and tdnn_kernel.supports(trainer.model_cfg)))

    def shard(reader):
        for i, item in enumerate(reader):
            if args.num_shards == 1 or i % args.num_shards == args.shard:
                yield item

    if args.wav_rspecifier:
        ex = WaveExtractor(trainer.model_cfg, trainer.params, trainer.state,
                           WaveExtractorConfig(**common), device=args.device)
        wav_scp = args.wav_rspecifier
        for prefix in ("scp:", "scp,p:"):
            wav_scp = wav_scp.removeprefix(prefix)

        def stream():
            yield from shard(read_wav_scp(wav_scp))
    else:
        vad = (dict(kio.read_vec_flt_scp(args.vad_scp)) if args.vad_scp
               else {})
        ex = XvectorExtractor(trainer.model_cfg, trainer.params,
                              trainer.state, ExtractorConfig(**common),
                              device=args.device)

        def stream():
            reader = (kio.read_mat_scp(args.feats_rspecifier)
                      if args.feats_rspecifier.startswith("scp")
                      else kio.read_mat_ark_fast(args.feats_rspecifier))
            for utt, feats in shard(reader):
                if args.apply_cmvn or utt in vad:
                    feats = preprocess(feats, vad=vad.get(utt),
                                       device=args.device)
                yield utt, feats

    n = 0
    xvectors = {}
    with kio.ArkWriter(args.output_ark, scp) as w:
        for utt, xv in ex.extract_iter(stream()):
            w.write(utt, xv)
            if args.spk2utt:
                xvectors[utt] = xv
            n += 1
    if args.spk2utt:
        utt2spk = {}
        with open(args.spk2utt) as f:
            for line in f:
                parts = line.split()
                for u in parts[1:]:
                    utt2spk[u] = parts[0]
        means, counts = speaker_means(
            {u: v for u, v in xvectors.items() if u in utt2spk}, utt2spk)
        base = args.output_ark.replace(".ark", "")
        with kio.ArkWriter(base + "_spk.ark", base + "_spk.scp") as w:
            for spk in sorted(means):
                w.write(spk, means[spk])
        with open(base + "_num_utts.ark", "w") as f:
            for spk in sorted(counts):
                f.write(f"{spk} {counts[spk]}\n")
    open(scp + ".done", "w").close()
    print(f"wrote {n} x-vectors -> {args.output_ark}")


if __name__ == "__main__":
    main()
