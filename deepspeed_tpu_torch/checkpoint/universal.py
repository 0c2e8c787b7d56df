"""Universal checkpoint inspection (counterpart of
``deepspeed_tpu/checkpoint/universal.py``).

Capability slot of the reference's ``deepspeed/checkpoint/
deepspeed_checkpoint.py:37`` (DeepSpeedCheckpoint: enumerate a checkpoint's
layer/param structure across tp/pp shards) and ``universal_checkpoint.py``
(reshape to a topology-free layout). Here checkpoints are ALREADY
topology-free — every parameter is stored whole under its pytree path — so
the class is pure introspection: names, shapes, dtypes, lazy tensor access,
and it reads the checkpoints of both packages alike.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

import numpy as np

from ..runtime.checkpointing import FlatNpz, get_latest_tag


def _npz_headers(path: str) -> Dict[str, tuple]:
    """{key: (shape, dtype_str)} read from the npy HEADERS only — no tensor
    data is materialized (a 6.7B checkpoint inspects in milliseconds)."""
    import zipfile

    from numpy.lib import format as npfmt
    out = {}
    dtype_map = {}
    with zipfile.ZipFile(path) as zf:
        for name in zf.namelist():
            if not name.endswith(".npy"):
                continue
            key = name[:-4]
            with zf.open(name) as f:
                version = npfmt.read_magic(f)
                read = (npfmt.read_array_header_1_0 if version == (1, 0)
                        else npfmt.read_array_header_2_0)
                shape, _, dtype = read(f)
            out[key] = (shape, str(dtype))
    meta = out.pop("__dtypes__", None)
    if meta is not None:
        with zipfile.ZipFile(path) as zf:
            with zf.open("__dtypes__.npy") as f:
                raw = np.lib.format.read_array(f)
        dtype_map = json.loads(bytes(raw).decode())
    for key, logical in dtype_map.items():
        if key in out:
            out[key] = (out[key][0], logical)
    return out


class DeepSpeedCheckpoint:
    """Inspector over a saved checkpoint directory. Shapes/dtypes come from
    the npy headers; tensor data loads lazily per get_parameter call."""

    def __init__(self, ckpt_dir: str, tag: Optional[str] = None):
        if tag is None:
            tag = get_latest_tag(ckpt_dir)
            if tag is None:
                raise FileNotFoundError(
                    f"no 'latest' tag file in {ckpt_dir} — pass tag= "
                    "explicitly to inspect a specific checkpoint")
        self.dir = os.path.join(ckpt_dir, tag)
        if not os.path.isdir(self.dir):
            raise FileNotFoundError(f"no checkpoint at {self.dir}")
        self.tag = tag
        with open(os.path.join(self.dir, "meta.json")) as f:
            self.meta = json.load(f)
        self._model_path = os.path.join(self.dir, "model_states.npz")
        self._model_hdrs = _npz_headers(self._model_path)
        optim_path = os.path.join(self.dir, "optim_states.npz")
        self._optim_hdrs = (_npz_headers(optim_path)
                            if os.path.exists(optim_path) else {})

    @property
    def global_step(self) -> int:
        return int(self.meta.get("step", 0))

    def parameter_names(self) -> List[str]:
        return sorted(self._model_hdrs)

    def optimizer_keys(self) -> List[str]:
        return sorted(self._optim_hdrs)

    def get_parameter(self, name: str):
        """One parameter as a CPU tensor (bf16 as ``torch.bfloat16``),
        read alone from the archive."""
        with FlatNpz(self._model_path) as r:
            return r[name]

    def shapes(self) -> Dict[str, tuple]:
        return {k: shape for k, (shape, _) in self._model_hdrs.items()}

    def num_parameters(self) -> int:
        return int(sum(int(np.prod(shape)) if shape else 1
                       for shape, _ in self._model_hdrs.values()))

    def summary(self) -> Dict:
        return {"tag": self.tag, "step": self.global_step,
                "num_parameters": self.num_parameters(),
                "num_tensors": len(self._model_hdrs),
                "optimizer_tensors": len(self._optim_hdrs),
                "dtypes": sorted({dt for _, dt
                                  in self._model_hdrs.values()})}


def inspect_checkpoint(ckpt_dir: str, tag: Optional[str] = None) -> Dict:
    """One-call summary (the ds_report-style view of a checkpoint)."""
    return DeepSpeedCheckpoint(ckpt_dir, tag).summary()
