"""The request generator of the serving cells: a mix file of parameters ->
a stream of requests (prompt tokens, output length, head slot).

A mix (``traffic/<name>.json``, with ``"generator": "requests"``) is data:

* ``loop``: ``closed`` (``in_flight`` requests are outstanding at every
  moment: a finished request is replaced at once);
* ``in_flight``: the closed loop's number of outstanding requests;
* ``prompt``, ``output``: token lengths, each ``{"lognormal": {"mean": m,
  "sigma": s}}``, a log-normal of mean ``m`` (its median ``m exp(-s^2/2)``),
  with the ``source`` of its numbers beside it;
* the configuration's cut of them (its ``max_prompt_tokens`` and
  ``max_new_tokens``, listed in its ``reduced``): a length above the cut
  takes the cut;
* ``requests``: how many requests the stream holds (a closed loop that
  runs out starts over, with new ids);
* token ids uniform over the configuration's vocabulary, head slots
  uniform over its slots.

The lengths are the same for every seed: each block of ``in_flight``
consecutive requests holds the log-normal's ``in_flight`` quantiles at the
block's midpoints, cut, in an order the seed draws (prompt and output
lengths permuted apart).  So every seed offers the same work in every
stretch of the stream; the seed draws which request gets which length,
its tokens and its slot (``numpy.random.default_rng(seed)``).
"""

from __future__ import annotations

import dataclasses
import math
from statistics import NormalDist

import numpy as np


@dataclasses.dataclass
class Requests:
    prompts: list                 # np.int64 arrays
    max_new: np.ndarray           # (n,) output tokens asked for
    slots: np.ndarray             # (n,) head slot of each request
    in_flight: int

    def __len__(self) -> int:
        return len(self.prompts)


def quantile_lengths(spec: dict, k: int, cut: int) -> np.ndarray:
    """The ``k`` midpoint quantiles of the spec's log-normal, at least one
    token and at most ``cut``."""
    mean, sigma = float(spec["lognormal"]["mean"]), float(spec["lognormal"]["sigma"])
    median = mean * math.exp(-sigma * sigma / 2)
    z = [NormalDist().inv_cdf((i + 0.5) / k) for i in range(k)]
    n = [round(median * math.exp(sigma * q)) for q in z]
    return np.clip(np.asarray(n, np.int64), 1, int(cut))


def build(mix: dict, *, num_slots: int, vocab_size: int, seed: int,
          max_prompt: int, max_new: int, **_) -> Requests:
    if mix.get("loop", "closed") != "closed":
        raise ValueError("the request generator builds closed loops only")
    rng = np.random.default_rng(seed)
    k = int(mix["in_flight"])
    n = int(mix["requests"])
    blocks = -(-n // k)
    p_len = quantile_lengths(mix["prompt"], k, max_prompt)
    o_len = quantile_lengths(mix["output"], k, max_new)
    prompt_n = np.concatenate([p_len[rng.permutation(k)] for _ in range(blocks)])[:n]
    out_n = np.concatenate([o_len[rng.permutation(k)] for _ in range(blocks)])[:n]
    tokens = rng.integers(0, vocab_size, int(prompt_n.sum()), dtype=np.int64)
    prompts = np.split(tokens, np.cumsum(prompt_n)[:-1])
    slots = rng.integers(0, num_slots, n)
    return Requests(prompts=prompts, max_new=out_n, slots=slots, in_flight=k)
