"""General helpers (numpy copies of trase_tpu's).

Behavioral contract: utils/general_utils.py in the reference
(inverse_sigmoid, safe_state) and utils/system_utils.py
(searchForMaxIteration).
"""
from __future__ import annotations

import os
import random

import numpy as np


def inverse_sigmoid_np(x):
    return np.log(x / (1 - x))


def search_for_max_iteration(folder: str):
    """Largest numeric suffix among `iteration_*` entries in a folder."""
    saved = [int(fname.split("_")[-1]) for fname in os.listdir(folder)]
    return max(saved)


def safe_state(seed: int = 0):
    """Seed the host RNGs (python's random, numpy's global) for
    reproducibility; device randomness is drawn from explicit
    generators."""
    random.seed(seed)
    np.random.seed(seed)
    os.environ.setdefault("PYTHONHASHSEED", str(seed))
