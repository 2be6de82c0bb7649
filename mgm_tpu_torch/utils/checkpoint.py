"""Checkpoint/resume for long multi-tile scenes (mirror of
mgm_tpu/utils/checkpoint.py: the same names and the same .npz format,
so either package resumes from the other's checkpoint directory).

The reference has no checkpointing (SURVEY.md section 5); the tiled
runner persists each finished tile's disparities and costs so a
preempted job resumes at the last finished tile instead of re-solving
the scene.
"""
from __future__ import annotations

import os
import zipfile

import numpy as np


def save_state(path: str, **arrays) -> None:
    """Atomically persist named arrays (.npz): written to a temporary
    name, then renamed over `path`."""
    tmp = path + ".tmp.npz"  # savez appends .npz unless already present
    np.savez_compressed(tmp, **{k: np.asarray(v) for k, v in arrays.items()})
    os.replace(tmp, path)


def load_state(path: str) -> dict | None:
    """Load a checkpoint dict, or None if absent or unreadable."""
    if not os.path.exists(path):
        return None
    try:
        with np.load(path, allow_pickle=False) as z:
            return {k: z[k] for k in z.files}
    except (OSError, ValueError, EOFError, zipfile.BadZipFile):
        return None
