# Checkpoint / resume of simulation state. Port of
# flow_tpu/io/checkpoint.py, in its npz format (arrays as arr_<name>,
# scalars as scl_<name>, __version__ = 1), so that a checkpoint written by
# either package resumes in the other. Host numpy: tensors are copied to
# the host on save, and the caller moves the loaded arrays to its device.
from __future__ import annotations

import numpy as np
import torch

__all__ = ["save_checkpoint", "load_checkpoint"]

_FORMAT_VERSION = 1


def _host(v):
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def save_checkpoint(path, arrays: dict, scalars: dict | None = None):
    """arrays: name -> tensor or array; scalars: name -> float/int. Written
    with np.savez, which appends .npz to a path without it."""
    payload = {f"arr_{k}": _host(v) for k, v in arrays.items()}
    for k, v in (scalars or {}).items():
        payload[f"scl_{k}"] = _host(v)
    payload["__version__"] = np.asarray(_FORMAT_VERSION)
    np.savez(path, **payload)


def load_checkpoint(path, dtype=None):
    """-> (arrays, scalars): numpy arrays (floating ones cast to the numpy
    `dtype` if given) and Python scalars."""
    with np.load(path) as data:
        version = int(data["__version__"])
        if version != _FORMAT_VERSION:
            raise ValueError(f"unknown checkpoint version {version}")
        arrays = {
            k[4:]: (v.astype(dtype) if dtype is not None
                    and np.issubdtype(v.dtype, np.floating) else v)
            for k, v in data.items() if k.startswith("arr_")
        }
        scalars = {k[4:]: v.item() for k, v in data.items() if k.startswith("scl_")}
    return arrays, scalars
