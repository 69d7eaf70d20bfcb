"""Seeding and the log redirect of a run (counterpart of
``inductive_recommendation_tpu/utils/run.py``; reference utils.py:13-30,
292-305).

``set_seed`` seeds the host streams that data preparation draws from
(Python's, numpy's global one, which ``generate_data``'s shuffle uses) and
torch's default generators. The trainers draw from their own generators,
seeded from their config's ``seed``.
"""

from __future__ import annotations

import os
import random
import sys

import numpy as np
import torch


def set_seed(seed=0):
    random.seed(seed)
    os.environ["PYTHONHASHSEED"] = str(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)


class Unbuffered:
    """A stream that flushes on every write (utils.py:292-305)."""

    def __init__(self, stream):
        self.stream = stream

    def write(self, data):
        self.stream.write(data)
        self.stream.flush()

    def writelines(self, datas):
        self.stream.writelines(datas)
        self.stream.flush()

    def __getattr__(self, attr):
        return getattr(self.stream, attr)


def init_run(log_path, seed):
    """Seed, make ``log_path`` and send stdout and stderr to
    ``log_path/lo00gg.txt``, unbuffered (utils.py:24-30; the reference's
    file name is kept)."""
    set_seed(seed)
    if not os.path.exists(log_path):
        os.mkdir(log_path)
    f = Unbuffered(open(os.path.join(log_path, "lo00gg.txt"), "w"))
    sys.stderr = f
    sys.stdout = f
