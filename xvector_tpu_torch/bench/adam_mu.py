"""Adam's first moment in float32 against bfloat16
(``TrainConfig.adam_moments_dtype``) on the dense block step at the
bench's working point on one NVIDIA GPU.

    python -m xvector_tpu_torch.bench.adam_mu

The twin of the JAX package's ``tools/bench_adam_mu.py``.  It calls
``headline.measure_train_step`` (``no_dropout``, 7,185 classes, bf16, the
dense twin that the trainer runs for full blocks) with each moment dtype
and prints one JSON line: each run's ms per minibatch (the median round,
and its spread), its first block's seconds and last loss, and the gain
in percent (positive: bfloat16 is faster); each run is checked as the
headline's training runs are.  Without a card it exits 1."""

from __future__ import annotations

import argparse
import json
import sys
from functools import partial

from . import headline as H
from .common import card, card_line, require_card

# (rounds, blocks, ...): float32, then bfloat16 first moments
# (headline.compare_kw)
compare = partial(H.compare_kw, "adam_moments_dtype",
                  {"mu_float32": "float32", "mu_bfloat16": "bfloat16"})


def main(argv=None) -> int:
    argparse.ArgumentParser(description=__doc__.splitlines()[0]).parse_args(
        argv)
    require_card("bench.adam_mu")
    try:
        out = compare(tag=card_line())
    except H.CheckFailed as exc:
        print(f"bench.adam_mu: check failed: {exc}", file=sys.stderr)
        return 1
    print(json.dumps({**out, "device": card()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
