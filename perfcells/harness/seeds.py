"""The benchmark's own random draws (which calls and rays the check
samples), each a stream of its own from the run's seed and a tag."""

import numpy as np


def rng(seed: int, tag: int) -> np.random.Generator:
    return np.random.default_rng([seed & 0xFFFFFFFF,
                                  (seed >> 32) & 0xFFFFFFFF, tag])
