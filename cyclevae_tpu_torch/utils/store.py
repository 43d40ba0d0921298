"""Feature store + file/list utilities.

The port's counterpart of ``cyclevae_tpu/utils/hdf5.py``, with the same data
contract: one file per utterance, and one per speaker's statistics, holding
named datasets (``/feat_org_lf0``, ``/mcep_range``, ``/spcidx_range``,
``/f0``, ``/f0_range``, ``/npow``, ``/npow_range``, ``/mcepspc_range``,
``/cvuvlogf0fil_ap``, ``/gv_range_mean``, ``/cvgv_mean_<model_id>``, ...).
The file is a numpy ``.npz`` archive, not HDF5: the port runs where ``h5py``
is not installed.  A dataset path maps to the archive key without its
leading ``/``; dtypes and shapes are kept, and a 0-d dataset reads back as a
numpy scalar, as h5py returns it.

``write_store`` updates one dataset: it reads every member of the file,
writes them all with the new one to a temporary file in the same directory
and renames that over the file, so a reader never sees a half-written file.
Missing files and datasets fail as ``read_hdf5`` fails: logged, then
``sys.exit(1)``.
"""

from __future__ import annotations

import fnmatch
import logging
import os
import sys
import threading
from typing import Dict, List

import numpy as np


def _key(store_path: str) -> str:
    return store_path.lstrip("/")


def _members(store_name: str) -> Dict[str, np.ndarray]:
    with np.load(store_name, allow_pickle=False) as z:
        return {k: z[k] for k in z.files}


def _require(store_name: str, store_path: str) -> None:
    if not os.path.exists(store_name):
        logging.error("There is no such a store file (%s).", store_name)
        sys.exit(1)
    if not check_store(store_name, store_path):
        logging.error("There is no such a data in store file. (%s)", store_path)
        sys.exit(1)


def check_store(store_name: str, store_path: str) -> bool:
    """Return True iff dataset ``store_path`` exists inside file ``store_name``."""
    if not os.path.exists(store_name):
        return False
    with np.load(store_name, allow_pickle=False) as z:
        return _key(store_path) in z.files


def read_store(store_name: str, store_path: str):
    """Read one dataset (errors out loudly if the file or dataset is missing)."""
    _require(store_name, store_path)
    with np.load(store_name, allow_pickle=False) as z:
        data = z[_key(store_path)]
    return data[()] if data.ndim == 0 else data


def shape_store(store_name: str, store_path: str):
    """Return the shape of a dataset."""
    _require(store_name, store_path)
    with np.load(store_name, allow_pickle=False) as z:
        return z[_key(store_path)].shape


def write_store(store_name: str, store_path: str, write_data, is_overwrite: bool = True):
    """Write one dataset, creating parent dirs; an existing dataset is
    replaced, or with ``is_overwrite=False`` fails as ``write_hdf5`` does."""
    write_data = np.asarray(write_data)
    if write_data.dtype.hasobject:
        raise ValueError(f"{store_path}: the store holds no object arrays")
    folder = os.path.dirname(store_name)
    if folder and not os.path.exists(folder):
        os.makedirs(folder, exist_ok=True)
    members = _members(store_name) if os.path.exists(store_name) else {}
    key = _key(store_path)
    if key in members and not is_overwrite:
        logging.error("Dataset in store file already exists. (%s)", store_path)
        sys.exit(1)
    members[key] = write_data
    tmp = f"{store_name}.{os.getpid()}.{threading.get_ident()}.tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **members)
    os.replace(tmp, store_name)


def find_files(directory: str, pattern: str = "*.wav", use_dir_name: bool = True):
    """Recursive glob, sorted walk order; optionally strip the root dir prefix."""
    files = []
    for root, _, filenames in os.walk(directory, followlinks=True):
        for filename in fnmatch.filter(filenames, pattern):
            files.append(os.path.join(root, filename))
    if not use_dir_name:
        files = [f.replace(directory + "/", "") for f in files]
    return files


def read_txt(file_list: str) -> List[str]:
    """Read a list file: one path per line."""
    with open(file_list) as f:
        return [line.rstrip() for line in f if line.strip()]
