"""Arrivals with exponential gaps, stratified: the n = floor(rate_per_s *
seconds) requests due in the window are spaced by the n mid-quantiles of
an exponential at ``rate_per_s``, scaled to fill the window exactly, in
an order the seed draws.  Every seed gets the same set of gaps; the count
does not vary and the gaps are smoother than a Poisson process's, so the
tails read lower than under Poisson arrivals at the same rate."""

import numpy as np


def schedule(traffic: dict, seed: int, seconds: float) -> np.ndarray:
    rate = float(traffic["rate_per_s"])
    n = int(rate * seconds)
    q = (np.arange(n) + 0.5) / n
    gaps = -np.log1p(-q) / rate
    gaps *= seconds / gaps.sum()
    gaps = np.random.default_rng([int(seed), 2]).permutation(gaps)
    return np.concatenate([[0.0], np.cumsum(gaps)[:-1]])
