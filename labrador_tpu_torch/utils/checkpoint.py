"""Phase checkpoints: named dicts of tensors and a JSON meta in one npz.

Counterpart of ``labrador_tpu/utils/checkpoint.py``.  ``prove_checkpointed``
saves its phase dicts after each phase, so a preempted proof resumes at
the last phase boundary.  A save writes a temporary file beside ``path``
and renames it over ``path``: a reader finds the previous checkpoint or
the new one, never a part of one.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

_META = "__meta__"
_SEP = "::"


def save(path: str, meta: dict | None = None, **dicts) -> None:
    """save('ckpt.npz', meta={'phases_done': 1}, ph1={'t': t, ...}): each
    dict of tensors under its name, ``meta`` a small JSON dict."""
    arrays = {}
    if meta is not None:
        arrays[_META] = np.frombuffer(json.dumps(meta).encode(), np.uint8)
    for name, tensors in dicts.items():
        for field, x in tensors.items():
            arrays[f"{name}{_SEP}{field}"] = x.detach().cpu().numpy()
    tmp = f"{path}.tmp"
    try:
        with open(tmp, "wb") as f:
            np.savez(f, **arrays)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def load(path: str, device="cuda") -> dict:
    """{name: {field: tensor}} of every dict saved in ``path``, the tensors
    on ``device`` with their saved dtypes."""
    out: dict = {}
    with np.load(path) as z:
        for key in z.files:
            if key == _META:
                continue
            name, field = key.split(_SEP, 1)
            out.setdefault(name, {})[field] = torch.from_numpy(
                z[key]).to(device)
    return out


def load_meta(path: str) -> dict:
    with np.load(path) as z:
        if _META not in z.files:
            return {}
        return json.loads(z[_META].tobytes().decode())


def exists(path: str) -> bool:
    return os.path.exists(path)
