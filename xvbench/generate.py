"""Inputs of the benchmark, made from ``--seed``: weights, training
archives' contents and the extraction pool.

The seed permutes and fills; it never changes how much work there is.
Lengths are stratified (fixed quantiles of the traffic's range), so every
seed gives the same set of sizes in another order, and the VAD decisions of
the extraction pool belong to the length, not to the seed.  Random numbers
come from ``torch.Generator`` objects on the run's device, in a few large
calls; each purpose has its own stream, derived from the seed and a tag, so
that one part can be made again without the rest.
"""

from __future__ import annotations

import math
import zlib
from typing import Dict, List, Mapping, Tuple

import numpy as np
import torch


def derive(seed: int, tag: str) -> int:
    """A 63-bit seed for one purpose of run ``seed``."""
    state = np.random.SeedSequence([int(seed) & (2**64 - 1), seed >> 64,
                                    zlib.crc32(tag.encode())]
                                   ).generate_state(2, dtype=np.uint32)
    return (int(state[0]) << 31) ^ int(state[1])


def generator(seed: int, tag: str, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(derive(seed, tag))


def param_shapes(cfg: Mapping) -> Tuple[List[tuple], List[tuple]]:
    """(path, shape, kind) of every parameter and population statistic,
    in the program's tree layout."""
    params, stats = [], []
    cin = cfg["feat_dim"]
    for i, (k, c) in enumerate(zip(cfg["kernel_sizes"], cfg["channels"])):
        params += [(("frame", i, "w"), (k, cin, c), ("he", k * cin)),
                   (("frame", i, "b"), (c,), ("small",)),
                   (("frame", i, "bn", "gamma"), (c,), ("gamma",)),
                   (("frame", i, "bn", "beta"), (c,), ("small",))]
        stats += [(("frame", i, "mean"), (c,), ("small",)),
                  (("frame", i, "var"), (c,), ("var",))]
        cin = c
    prev = 2 * cfg["channels"][-1]
    for i, d in enumerate(cfg["embed_dims"]):
        params += [(("embed", i, "w"), (prev, d), ("he", prev)),
                   (("embed", i, "b"), (d,), ("small",)),
                   (("embed", i, "bn", "gamma"), (d,), ("gamma",)),
                   (("embed", i, "bn", "beta"), (d,), ("small",))]
        stats += [(("embed", i, "mean"), (d,), ("small",)),
                  (("embed", i, "var"), (d,), ("var",))]
        prev = d
    params += [(("output", "w"), (prev, cfg["num_targets"]), ("lecun", prev)),
               (("output", "b"), (cfg["num_targets"],), ("small",))]
    return params, stats


def _scaled(z: torch.Tensor, kind: tuple) -> torch.Tensor:
    if kind[0] == "he":
        return z * math.sqrt(2.0 / kind[1])
    if kind[0] == "lecun":
        return z * math.sqrt(1.0 / kind[1])
    if kind[0] == "gamma":
        return 1.0 + 0.1 * z
    if kind[0] == "var":
        return torch.exp(0.2 * z)
    return 0.1 * z


def _tree(entries, leaf) -> Dict:
    """The nest of dicts and lists that ``entries`` describe, with
    ``leaf(index, path, shape, kind)`` at each leaf."""
    tree: Dict = {}
    for index, (path, shape, kind) in enumerate(entries):
        node = tree
        for key, nxt in zip(path[:-1], path[1:]):
            if isinstance(key, int):
                while len(node) <= key:
                    node.append({} if not isinstance(nxt, int) else [])
                node = node[key]
            else:
                node = node.setdefault(key, [] if isinstance(nxt, int) else {})
        node[path[-1]] = leaf(index, path, shape, kind)
    return tree


def _filled(entries, flat: torch.Tensor) -> Dict:
    starts = np.cumsum([0] + [math.prod(s) for _, s, _ in entries])
    return _tree(entries, lambda i, path, shape, kind: _scaled(
        flat[starts[i]:starts[i + 1]].view(shape), kind).contiguous())


def param_names(cfg: Mapping) -> List[str]:
    """Dotted names of the parameters, in ``reference.tdnn.leaves`` order."""
    from .reference.tdnn import leaves
    return leaves(_tree(param_shapes(cfg)[0],
                        lambda i, path, shape, kind: ".".join(map(str, path))))


def weights(cfg: Mapping, seed: int, device, sync=None
            ) -> Tuple[Dict, Dict]:
    """(params, population statistics) in float32 on ``device``: He-scaled
    normal weights, so that activations stay near unit scale through the
    stack, batch-norm scales near 1, small offsets.  ``sync(flat)``, when
    given, makes the drawn numbers every rank's (a broadcast)."""
    p_entries, s_entries = param_shapes(cfg)
    sizes = [sum(math.prod(s) for _, s, _ in e)
             for e in (p_entries, s_entries)]
    flat = torch.randn(sum(sizes), generator=generator(seed, "weights",
                                                       device),
                       device=device)
    if sync is not None:
        sync(flat)
    return (_filled(p_entries, flat[:sizes[0]]),
            _filled(s_entries, flat[sizes[0]:]))


# -- training archives ---------------------------------------------------------

def archive_lengths(traffic: Mapping, seed: int) -> List[int]:
    """Chunk length of each archive: the traffic's stratified lengths in
    the order the seed permutes them to."""
    lengths = list(traffic["chunk_lengths"])
    order = np.random.default_rng(derive(seed, "archive_order")).permutation(
        len(lengths))
    return [lengths[i] for i in order]


def archive_minibatches(traffic: Mapping, cfg: Mapping, seed: int,
                        index: int, length: int, device
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Archive ``index``'s minibatches: features (M, B, T, F) float16 and
    labels (M, B) int64, uniform over the speakers, on ``device``."""
    g = generator(seed, f"archive{index}", device)
    shape = (traffic["minibatches_per_archive"], traffic["rows"], length,
             cfg["feat_dim"])
    feats = torch.randn(shape, generator=g, device=device).to(torch.float16)
    labels = torch.randint(0, cfg["num_targets"], shape[:2], generator=g,
                           device=device)
    return feats, labels


# -- extraction pool -------------------------------------------------------------

def pool_lengths(traffic: Mapping) -> List[int]:
    """The pool's utterance lengths in frames, sorted: log-spaced quantiles
    of the traffic's range."""
    n, lo, hi = traffic["utterances"], traffic["min_frames"], \
        traffic["max_frames"]
    return [int(round(lo * (hi / lo) ** ((i + 0.5) / n))) for i in range(n)]


def vad_decisions(traffic: Mapping, index: int, length: int) -> np.ndarray:
    """Energy-VAD decisions (1 voiced, 0 not) of the pool's ``index``-th
    length: alternating runs of speech and silence, drawn from the length's
    own fixed stream, so every seed has the same voiced counts."""
    rng = np.random.default_rng([index, length])
    s_lo, s_hi = traffic["speech_run"]
    q_lo, q_hi = traffic["silence_run"]
    out = np.empty(length, np.float32)
    at, voiced = 0, True
    while at < length:
        run = int(rng.integers(s_lo, s_hi + 1) if voiced
                  else rng.integers(q_lo, q_hi + 1))
        out[at:at + run] = 1.0 if voiced else 0.0
        at += run
        voiced = not voiced
    return out


def extraction_pool(traffic: Mapping, cfg: Mapping, seed: int, device
                    ) -> List[Tuple[np.ndarray, np.ndarray]]:
    """The pool as host arrays [(features (T, F) float32, vad (T,))], in the
    seed's order.  Features are unit normal noise plus a per-utterance,
    per-dimension offset (which sliding CMVN takes out), made on the device
    in two calls and copied to the host once."""
    lengths = pool_lengths(traffic)
    order = np.random.default_rng(derive(seed, "pool_order")).permutation(
        len(lengths))
    lens = [lengths[i] for i in order]
    g = generator(seed, "pool", device)
    f = cfg["feat_dim"]
    offsets = 3.0 * torch.randn((len(lens), f), generator=g, device=device)
    feats = torch.randn((sum(lens), f), generator=g, device=device)
    feats += torch.repeat_interleave(
        offsets, torch.tensor(lens, device=device), dim=0)
    host = feats.cpu().numpy()
    pool, at = [], 0
    for i, n in zip(order, lens):
        pool.append((host[at:at + n], vad_decisions(traffic, int(i), n)))
        at += n
    return pool
