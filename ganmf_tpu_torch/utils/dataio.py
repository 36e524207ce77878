"""Zip-container model persistence.

Equivalent of the reference DataIO (Base/DataIO.py:32-240): every attribute
of a dict is serialized as its own member inside ``<name>.zip`` (json for
primitives, .npy for arrays, .npz for scipy sparse, pickle otherwise), with
temp-file atomicity so a half-written archive is never mistaken for a model.

A copy of ganmf_tpu/utils/dataio.py, which uses no framework: the port reads
and writes the same zips without importing the JAX package.
"""

from __future__ import annotations

import io
import json
import os
import pickle
import shutil
import tempfile
import zipfile
from typing import Any, Dict

import numpy as np
import scipy.sparse as sps


class DataIO:
    def __init__(self, folder_path: str):
        self.folder_path = folder_path

    def _zip_path(self, file_name: str) -> str:
        if not file_name.endswith(".zip"):
            file_name = file_name + ".zip"
        return os.path.join(self.folder_path, file_name)

    def save_data(self, file_name: str, data_dict_to_save: Dict[str, Any]) -> None:
        os.makedirs(self.folder_path, exist_ok=True)
        final_path = self._zip_path(file_name)
        tmp_fd, tmp_path = tempfile.mkstemp(suffix=".zip", dir=self.folder_path)
        os.close(tmp_fd)
        try:
            with zipfile.ZipFile(tmp_path, "w", compression=zipfile.ZIP_DEFLATED) as zf:
                attr_types = {}
                for name, value in data_dict_to_save.items():
                    if sps.issparse(value):
                        buf = io.BytesIO()
                        sps.save_npz(buf, value.tocsr())
                        zf.writestr(name + ".npz", buf.getvalue())
                        attr_types[name] = "sparse"
                    elif isinstance(value, np.ndarray):
                        buf = io.BytesIO()
                        np.save(buf, value)
                        zf.writestr(name + ".npy", buf.getvalue())
                        attr_types[name] = "array"
                    else:
                        try:
                            zf.writestr(name + ".json", json.dumps(value))
                            attr_types[name] = "json"
                        except TypeError:
                            zf.writestr(name + ".pkl", pickle.dumps(value, pickle.HIGHEST_PROTOCOL))
                            attr_types[name] = "pickle"
                zf.writestr(".attr_types.json", json.dumps(attr_types))
            shutil.move(tmp_path, final_path)
        finally:
            if os.path.exists(tmp_path):
                os.remove(tmp_path)

    def load_data(self, file_name: str) -> Dict[str, Any]:
        path = self._zip_path(file_name)
        out: Dict[str, Any] = {}
        with zipfile.ZipFile(path, "r") as zf:
            names = zf.namelist()
            attr_types = {}
            if ".attr_types.json" in names:
                attr_types = json.loads(zf.read(".attr_types.json"))
            for member in names:
                if member == ".attr_types.json":
                    continue
                stem, ext = os.path.splitext(member)
                raw = zf.read(member)
                if ext == ".npz" or attr_types.get(stem) == "sparse":
                    out[stem] = sps.load_npz(io.BytesIO(raw))
                elif ext == ".npy":
                    out[stem] = np.load(io.BytesIO(raw), allow_pickle=False)
                elif ext == ".json":
                    out[stem] = json.loads(raw)
                elif ext == ".pkl":
                    out[stem] = pickle.loads(raw)
        return out
