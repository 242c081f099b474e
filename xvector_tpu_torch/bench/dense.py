"""The dense (mask-free) block step against the masked one at the bench's
working point on one NVIDIA GPU.

    python -m xvector_tpu_torch.bench.dense

The twin of the JAX package's ``tools/bench_dense.py``.  Both runs take
full blocks, where the two steps compute the same updates, so the
difference is the cost of the mask machinery itself.  It calls
``headline.measure_train_step`` (``no_dropout``, 7,185 classes, bf16,
Adam) with ``dense=False`` and then ``dense=True`` and prints one JSON
line: each step's ms per minibatch (the median round, and its spread),
the first block's seconds, the last block's loss and the gain of the
dense step in percent; each run is checked as the headline's training
runs are.  Without a card it exits 1."""

from __future__ import annotations

import argparse
import json
import sys
from functools import partial

from . import headline as H
from .common import card, card_line, require_card

# (rounds, blocks, ...): masked, then dense (headline.compare_kw)
compare = partial(H.compare_kw, "dense", {"masked": False, "dense": True})


def main(argv=None) -> int:
    argparse.ArgumentParser(description=__doc__.splitlines()[0]).parse_args(
        argv)
    require_card("bench.dense")
    try:
        out = compare(tag=card_line())
    except H.CheckFailed as exc:
        print(f"bench.dense: check failed: {exc}", file=sys.stderr)
        return 1
    print(json.dumps({**out, "device": card()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
