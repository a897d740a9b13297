"""General helpers the serving path needs (numpy copies of trase_tpu's).

Behavioral contract: utils/general_utils.py in the reference
(inverse_sigmoid) and utils/system_utils.py (searchForMaxIteration).
"""
from __future__ import annotations

import os

import numpy as np


def inverse_sigmoid_np(x):
    return np.log(x / (1 - x))


def search_for_max_iteration(folder: str):
    """Largest numeric suffix among `iteration_*` entries in a folder."""
    saved = [int(fname.split("_")[-1]) for fname in os.listdir(folder)]
    return max(saved)
