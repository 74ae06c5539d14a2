"""Deterministic seeding of the host's generators (reference
utils/seed.py:5-10; a copy of ``videomv_tpu/utils/seed.py::setup_seed``).

The port's own draws come from explicit ``torch.Generator``s; this seeds
what the data pipelines and any default-generator draw read: python
``random``, numpy's global generator, ``PYTHONHASHSEED`` for child
processes, and torch's default generators (CPU and every CUDA device).
"""

import os
import random

import numpy as np
import torch

__all__ = ["setup_seed"]


def setup_seed(seed: int) -> None:
    random.seed(seed)
    np.random.seed(seed)
    os.environ["PYTHONHASHSEED"] = str(seed)
    torch.manual_seed(seed)
