"""Checkpoint save / load — crash-safe by construction (counterpart of
``deepspeed_tpu/runtime/checkpointing.py``, whose files this module writes
and reads byte for byte).

Format: ``<save_dir>/<tag>/`` holds ``model_states.npz`` (the parameters),
``optim_states.npz`` (``master/<path>`` unless the master aliases the
parameters, ``opt_state/m/<path>``, ``opt_state/v/<path>``), ``meta.json``
(step, skip and loss-scale counters, ``client_state``) and
``ckpt_meta.json`` (the completion marker: sha256 and size of every file).
Every tensor is stored whole under its ``/``-joined path — names, not
partition indices — so a checkpoint written by the JAX package loads here
and the other way round. The npz members are ``.npy`` arrays in a
``ZIP_STORED`` zip64 archive; bfloat16 is stored as its uint16 bit pattern
with a ``__dtypes__`` manifest naming the bf16 keys, so nothing is upcast
and a bf16 leaf round-trips bit-exact as a ``torch.bfloat16`` tensor.

The live state is the caller's tensors: a :class:`Leaf` is one tensor, or
the per-layer tensors that the file stacks along a leading ``[L, ...]``
dim. A save reads one leaf at a time to the host (a sync writer streams
thunks; an async writer gets one pinned host copy per leaf, snapshotted
before the call returns); a load reads one leaf at a time and ``copy_``\\ s
each slice back into the live tensors, so aliases (a module's parameters,
the engine's master and moment lists) stay aliases.

Durability (as in the JAX package):

- every save writes into ``<tag>.tmp``; the final ``<tag>`` appears by one
  ``os.replace``, so no reader sees a half-written tag;
- ``ckpt_meta.json`` is written LAST, after the data files are fsync'd;
- ``latest`` is rewritten atomically, and only after the publish;
- ``load_checkpoint(tag=None)`` verifies the marker (and digests) and on a
  corrupt or partial tag walks back to the newest intact one, repairing
  ``latest``; an explicit corrupt tag raises
  :class:`CheckpointIntegrityError`;
- a failed save's staging dir is quarantined to ``<tag>.failed``.

Every crash-critical stage carries a named chaos failpoint
(``testing.chaos``): ``ckpt.write``, ``ckpt.digest``, ``ckpt.marker``,
``ckpt.rename``, ``ckpt.latest`` and ``ckpt.meta``.

Sharded saves (:func:`save_checkpoint_sharded`, the JAX package's
``_save_checkpoint_multiprocess``): every rank of a process group writes
its own pieces into the shared staging dir, ``model_states-shard{p}.npz``
and ``optim_states-shard{p}.npz``, each with a manifest of global shapes
and piece offsets (:func:`shard_flat_dict`); a leaf that every rank holds
whole is written by rank 0 only. A barrier gates rank 0's marker, publish
and ``latest``. :func:`load_sharded_tree` / :class:`ShardedNpz` read such
a checkpoint, from either package, one whole leaf at a time; a sharded
engine's :class:`Leaf` keeps only its slab of what it reads.
:func:`save_checkpoint` writes one process's whole state and raises in a
world larger than one.
"""

from __future__ import annotations

import dataclasses
import glob
import hashlib
import json
import os
import shutil
import zipfile
from typing import Any, Dict, List, Optional, Set, Tuple

import numpy as np
import torch

from ..testing import chaos
from ..utils.logging import logger

LATEST_FILE = "latest"
META_FILE = "meta.json"
CKPT_META_FILE = "ckpt_meta.json"
STAGING_SUFFIX = ".tmp"
QUARANTINE_SUFFIX = ".failed"
CKPT_FORMAT_VERSION = 1
_DTYPES_KEY = "__dtypes__"
_MANIFEST_KEY = "__manifest__"

_NATIVE_DTYPES = (np.float32, np.float64, np.float16, np.int32, np.int64,
                  np.int8, np.uint8, np.uint16, np.bool_)
_NATIVE_TORCH = (torch.float32, torch.float64, torch.float16, torch.int32,
                 torch.int64, torch.int8, torch.uint8, torch.uint16,
                 torch.bool)


class CheckpointIntegrityError(RuntimeError):
    """An explicitly requested tag failed verification (missing completion
    marker, digest/size mismatch, missing shard files). Auto-resolution
    (``tag=None``) never raises this — it rolls back instead."""


# ---------------------------------------------------------------------------
# Leaves: the live tensors behind one checkpoint path
# ---------------------------------------------------------------------------

class Leaf:
    """One checkpoint leaf held by live tensors: ``parts`` is a single
    tensor (``stacked=False``) or the per-layer tensors that the file
    holds stacked along a new leading dim. ``split``: when each part
    holds only this rank's piece of its whole tensor, the cuts taken one
    after another from the whole, else None: a (dim, rank, world) slab
    of the extent so far (a ZeRO shard, an expert leaf's experts), or a
    ``utils.partitioning.TPShard`` (a tensor-parallel shard: segments of
    the whole, maybe padded). ``writes``: whether this rank writes its
    piece to a sharded save (default: a split piece, or the whole on
    rank 0). ``layers``: (offset, total) when a stacked leaf's parts are
    layers ``offset ..`` of ``total`` (a pipeline stage's blocks)."""

    __slots__ = ("parts", "stacked", "split", "writes", "layers")

    def __init__(self, parts, stacked: bool = False, split=None,
                 writes: Optional[bool] = None,
                 layers: Optional[Tuple[int, int]] = None):
        self.parts: List[torch.Tensor] = (list(parts) if stacked
                                          else [parts])
        self.stacked = stacked
        self.split: Optional[List[Tuple[int, int, int]]] = (
            list(split) if split else None)
        self.writes = writes
        self.layers = layers if stacked else None

    @property
    def partial(self) -> bool:
        """Whether this rank's parts are a piece of the whole leaf."""
        return self.split is not None or self.layers is not None

    def _lead(self) -> Tuple[int, ...]:
        if self.layers is not None:
            return (self.layers[1],)
        return (len(self.parts),) if self.stacked else ()

    @property
    def shape(self) -> Tuple[int, ...]:
        """The whole leaf's shape."""
        s = list(self.parts[0].shape)
        for cut in reversed(self.split or ()):
            if isinstance(cut, tuple):
                s[cut[0]] *= cut[2]
            else:
                s[cut.dim] = cut.whole
        return self._lead() + tuple(s)

    def pieces(self) -> List[Tuple[List[int], Tuple[slice, ...]]]:
        """This rank's piece as boxes of the whole leaf: (offsets in the
        whole, index into one part) for each. A slab is one box; a TP
        shard's segments (qkv's q, k and v columns) are one each, its
        padding and the kv columns a lower model rank also holds in
        none."""
        ndim = self.parts[0].dim()
        whole = list(self.shape)[len(self._lead()):]
        # per dim: (local start, whole start, length) segments
        segs = [[(0, 0, n)] for n in whole]
        ext = list(whole)
        for cut in self.split or ():
            if isinstance(cut, tuple):
                dim, rank, world = cut
                dim %= ndim
                size = ext[dim] // world
                a, b = rank * size, rank * size + size
                segs[dim] = [(max(ls, a) - a, ws + max(ls, a) - ls,
                              min(ls + n, b) - max(ls, a))
                             for ls, ws, n in segs[dim]
                             if min(ls + n, b) > max(ls, a)]
                ext[dim] = size
            else:
                dim = cut.dim % ndim
                # a kv head several model ranks hold: its lowest holder's
                segs[dim] = list(cut.owned_segs())
                ext[dim] = cut.local
        out = []

        def walk(d, start, index):
            if d == ndim:
                out.append(([0] * len(self._lead()) + start, tuple(index)))
                return
            for ls, ws, n in segs[d]:
                walk(d + 1, start + [ws], index + [slice(ls, ls + n)])
        walk(0, [], [])
        if self.layers is not None:
            out = [([self.layers[0]] + start[1:], index)
                   for start, index in out]
        return out

    def piece(self, index: Tuple[slice, ...]) -> "Leaf":
        """A leaf over the views ``part[index]`` of this one's parts."""
        return Leaf([p[index] for p in self.parts] if self.stacked
                    else self.parts[0][index], self.stacked)

    def read(self, pinned: bool = False) -> torch.Tensor:
        """A host copy of the live tensors (this rank's piece of a split
        leaf) in their own dtype. ``pinned``: page-locked, filled by
        non-blocking copies (the caller synchronizes once)."""
        src = self.parts[0]
        pin = pinned and src.device.type == "cuda"
        lead = (len(self.parts),) if self.stacked else ()
        out = torch.empty(lead + tuple(src.shape), dtype=src.dtype,
                          pin_memory=pin)
        views = out.unbind(0) if self.stacked else (out,)
        for dst, part in zip(views, self.parts):
            dst.copy_(part.detach(), non_blocking=pin)
        return out

    def write(self, value: torch.Tensor) -> None:
        """Copy ``value`` (the file's whole leaf, any dtype or device) into
        the live tensors (their piece of it, if split), casting to their
        dtype."""
        if tuple(value.shape) != self.shape:
            raise ValueError(f"shape {tuple(value.shape)} vs {self.shape}")
        lead = len(self._lead())
        if self.layers is not None:
            value = value.narrow(0, self.layers[0], len(self.parts))
        for cut in self.split or ():
            if isinstance(cut, tuple):
                dim, rank, world = cut
                size = value.shape[lead + dim] // world
                value = value.narrow(lead + dim, rank * size, size)
            else:
                value = cut.take(value)
        src = value.unbind(0) if self.stacked else (value,)
        with torch.no_grad():
            for part, v in zip(self.parts, src):
                part.copy_(v)


# ---------------------------------------------------------------------------
# npz writer / readers
# ---------------------------------------------------------------------------

def _host_array(val) -> Tuple[np.ndarray, bool]:
    """(numpy array, is_bf16) of a tensor / array / Leaf; bf16 comes back
    as its uint16 bit pattern."""
    if isinstance(val, Leaf):
        val = val.read()
    if isinstance(val, torch.Tensor):
        t = val.detach()
        if t.device.type != "cpu":
            t = t.cpu()
        if t.dtype == torch.bfloat16:
            return t.contiguous().view(torch.int16).numpy().view(np.uint16), \
                True
        if t.dtype not in _NATIVE_TORCH:
            t = t.to(torch.float32)
        return t.contiguous().numpy(), False
    arr = np.asarray(val)
    if arr.dtype.name == "bfloat16":        # an ml_dtypes array from a caller
        return arr.view(np.uint16), True
    return arr, False


def write_flat_npz(flat: Dict[str, Any], path: str) -> None:
    """Streaming npz writer: arrays, tensors, :class:`Leaf` s or thunks
    producing one are written into the zip one at a time and freed.
    bfloat16 is stored as bf16 (uint16 bit pattern + a dtype manifest)."""
    from numpy.lib import format as npfmt
    dtypes: Dict[str, str] = {}
    with zipfile.ZipFile(path, "w", zipfile.ZIP_STORED, allowZip64=True) as zf:
        first = True
        for key, val in flat.items():
            arr, bf16 = _host_array(val() if callable(val) else val)
            if bf16:
                dtypes[key] = "bfloat16"
            elif arr.dtype not in _NATIVE_DTYPES:
                arr = arr.astype(np.float32)
            with zf.open(key + ".npy", "w", force_zip64=True) as f:
                npfmt.write_array(f, np.ascontiguousarray(arr),
                                  allow_pickle=False)
            del arr
            if first:
                # fires after the first array so a raise/kill here leaves a
                # TRUNCATED file — the hardest partial for a loader to spot
                # without digests
                chaos.failpoint("ckpt.write")
                first = False
        meta = np.frombuffer(json.dumps(dtypes).encode(), dtype=np.uint8)
        with zf.open(_DTYPES_KEY + ".npy", "w") as f:
            npfmt.write_array(f, meta, allow_pickle=False)


def _to_tensor(arr: np.ndarray, bf16: bool) -> torch.Tensor:
    if bf16:
        return torch.from_numpy(np.ascontiguousarray(arr).view(np.int16)) \
            .view(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(arr))


def to_tensor(val) -> torch.Tensor:
    """A tensor, or a CPU tensor of a numpy array (an ml_dtypes bfloat16
    array of the JAX package comes back as ``torch.bfloat16``)."""
    if isinstance(val, torch.Tensor):
        return val
    arr, bf16 = _host_array(val)
    return _to_tensor(arr, bf16)


class FlatNpz:
    """Lazy reader of one npz written by :func:`write_flat_npz` (or a plain
    ``np.savez``): ``keys()``, and ``[key]`` reads one member as a CPU
    tensor (bf16 members as ``torch.bfloat16``)."""

    def __init__(self, path: str):
        self._data = np.load(path)
        files = self._data.files
        self._bf16 = set()
        if _DTYPES_KEY in files:
            mapping = json.loads(bytes(self._data[_DTYPES_KEY]).decode())
            self._bf16 = {k for k, dt in mapping.items() if dt == "bfloat16"}
        self._keys = [k for k in files if k not in (_DTYPES_KEY,
                                                    _MANIFEST_KEY)]

    def keys(self) -> List[str]:
        return list(self._keys)

    def __contains__(self, key: str) -> bool:
        return key in self._keys

    def __getitem__(self, key: str) -> torch.Tensor:
        return _to_tensor(self._data[key], key in self._bf16)

    def close(self) -> None:
        self._data.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def read_flat_npz(path: str) -> Dict[str, torch.Tensor]:
    """Inverse of :func:`write_flat_npz` (also reads plain ``np.savez``
    archives): every member as a CPU tensor."""
    with FlatNpz(path) as r:
        return {k: r[k] for k in r.keys()}


class ShardedNpz:
    """Lazy reader over ``{base}-shard*.npz`` files that N processes wrote
    (each a manifest of global shapes and piece offsets): ``[key]``
    assembles ONE whole leaf from its pieces (peak host memory is the
    largest tensor, never the model). ``expected_shards`` (from the
    checkpoint meta) guards against partial checkpoints; per-leaf element
    coverage is validated regardless."""

    def __init__(self, ckpt_dir: str, base: str,
                 expected_shards: Optional[int] = None):
        files = sorted(glob.glob(os.path.join(ckpt_dir,
                                              base + "-shard*.npz")))
        if not files:
            raise FileNotFoundError(f"no {base}-shard*.npz under {ckpt_dir}")
        if expected_shards is not None and len(files) != expected_shards:
            raise FileNotFoundError(
                f"incomplete sharded checkpoint: found {len(files)} {base} "
                f"shard files under {ckpt_dir}, expected {expected_shards}. "
                "Restoring a multi-process checkpoint requires every host's "
                "shard files in ONE directory.")
        self._handles = [np.load(f) for f in files]
        self._merged: Dict[str, Dict[str, Any]] = {}
        self._bf16: List[Set[str]] = []
        for hi, h in enumerate(self._handles):
            man = json.loads(bytes(h[_MANIFEST_KEY]).decode())
            dt = (json.loads(bytes(h[_DTYPES_KEY]).decode())
                  if _DTYPES_KEY in h.files else {})
            self._bf16.append({k for k, v in dt.items() if v == "bfloat16"})
            for key, ent in man.items():
                slot = self._merged.setdefault(key, {"shape": ent["shape"],
                                                     "pieces": []})
                slot["pieces"].extend((hi, p) for p in ent["pieces"])

    def keys(self) -> List[str]:
        return list(self._merged)

    def __contains__(self, key: str) -> bool:
        return key in self._merged

    def __getitem__(self, key: str) -> torch.Tensor:
        ent = self._merged.get(key)
        if ent is None:
            raise KeyError(f"checkpoint missing parameter '{key}'")
        out = None
        covered = 0
        for hi, p in ent["pieces"]:
            piece = _to_tensor(self._handles[hi][p["name"]],
                               p["name"] in self._bf16[hi])
            if out is None:
                out = torch.zeros(tuple(ent["shape"]), dtype=piece.dtype)
            idx = tuple(slice(st, st + sz)
                        for st, sz in zip(p["start"], piece.shape))
            out[idx] = piece
            covered += piece.numel()
        if out is None or covered != out.numel():
            raise ValueError(
                f"sharded checkpoint pieces for '{key}' cover {covered} of "
                f"{0 if out is None else out.numel()} elements — missing "
                "shard data")
        return out

    def close(self) -> None:
        for h in self._handles:
            h.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def load_sharded_tree(ckpt_dir: str, base: str, like=None,
                      expected_shards: Optional[int] = None
                      ) -> Dict[str, torch.Tensor]:
    """Reassemble the leaves of ``{base}-shard*.npz`` into whole CPU
    tensors, one leaf at a time: every leaf, or those of ``like`` (a flat
    dict of :class:`Leaf` s or tensors, whose shapes are checked; Leaves
    are also written)."""
    with ShardedNpz(ckpt_dir, base, expected_shards) as r:
        if like is None:
            return {k: r[k] for k in r.keys()}
        return _restore(r, like)


def _restore(reader, like: Dict[str, Any], prefix: str = ""
             ) -> Dict[str, torch.Tensor]:
    """Read ``prefix + key`` for every key of ``like`` (shape-checked);
    a :class:`Leaf` target is written in place and not returned."""
    out = {}
    for key, ref in like.items():
        name = prefix + key
        if name not in reader:
            raise KeyError(f"checkpoint missing parameter '{name}'")
        val = reader[name]
        if tuple(val.shape) != tuple(ref.shape):
            raise ValueError(f"shape mismatch for '{name}': ckpt "
                             f"{tuple(val.shape)} vs model "
                             f"{tuple(ref.shape)}")
        if isinstance(ref, Leaf):
            ref.write(val)
        else:
            out[key] = val
        del val
    return out


# ---------------------------------------------------------------------------
# Name-keyed trees
# ---------------------------------------------------------------------------

def flatten_tree(tree: Dict[str, Any], prefix: str = "") -> Dict[str, Any]:
    """Nested dict -> ``{path: leaf}`` with ``/``-joined paths, sorted the
    way the JAX package flattens a dict (by key, at every level)."""
    out: Dict[str, Any] = {}
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out.update(flatten_tree(v, prefix + k + "/"))
        else:
            out[prefix + k] = v
    return out


def unflatten_tree(flat: Dict[str, Any]) -> Dict[str, Any]:
    """Inverse of :func:`flatten_tree`."""
    out: Dict[str, Any] = {}
    for path, v in flat.items():
        node = out
        parts = path.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return out


def _sorted_keys(flat: Dict[str, Any]) -> List[str]:
    return sorted(flat, key=lambda k: k.split("/"))


def save_tree(flat: Dict[str, Any], path: str) -> None:
    """Write a flat (or nested) name-keyed dict of tensors / Leaves."""
    if any(isinstance(v, dict) for v in flat.values()):
        flat = flatten_tree(flat)
    write_flat_npz({k: flat[k] for k in _sorted_keys(flat)}, path)


def load_tree(path: str, like: Dict[str, Any]) -> Dict[str, Any]:
    """Read ``path`` into the structure of ``like`` (a nested or flat
    dict): every key must be present with the same shape. Returns the
    loaded CPU tensors in ``like``'s structure, in the file's dtypes."""
    nested = any(isinstance(v, dict) for v in like.values())
    flat_like = flatten_tree(like) if nested else like
    with FlatNpz(path) as r:
        got = _restore(r, flat_like)
    return unflatten_tree(got) if nested else got


# ---------------------------------------------------------------------------
# Durability primitives: fsync, digests, completion marker, atomic publish
# ---------------------------------------------------------------------------

def _fsync_file(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _fsync_dir(path: str) -> None:
    """fsync a directory so renames/creations inside it are durable; a
    filesystem that can't fsync directories degrades to best-effort."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def file_digest(path: str) -> str:
    """Streaming sha256 of a file's bytes."""
    chaos.failpoint("ckpt.digest")
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def write_completion_marker(stage_dir: str, num_shards: int = 1) -> None:
    """Digest every data file in the staging dir, fsync them, then write
    ``ckpt_meta.json`` LAST (tmp + atomic replace + dir fsync)."""
    files: Dict[str, Dict[str, Any]] = {}
    for name in sorted(os.listdir(stage_dir)):
        if name in (CKPT_META_FILE, CKPT_META_FILE + ".tmp"):
            continue
        path = os.path.join(stage_dir, name)
        if not os.path.isfile(path):
            continue
        files[name] = {"sha256": file_digest(path),
                       "size": os.path.getsize(path)}
        _fsync_file(path)
    marker = {"format_version": CKPT_FORMAT_VERSION,
              "num_shards": num_shards,
              "files": files}
    chaos.failpoint("ckpt.marker")
    tmp = os.path.join(stage_dir, CKPT_META_FILE + ".tmp")
    with open(tmp, "w") as f:
        json.dump(marker, f, indent=2)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, os.path.join(stage_dir, CKPT_META_FILE))
    _fsync_dir(stage_dir)


def publish_tag(save_dir: str, tag: str) -> str:
    """Atomically promote ``<tag>.tmp`` to ``<tag>``; an existing tag dir
    (an overwrite-save) is moved aside first so the final rename is still
    one atomic transition."""
    stage = os.path.join(save_dir, tag + STAGING_SUFFIX)
    final = os.path.join(save_dir, tag)
    chaos.failpoint("ckpt.rename")
    if os.path.isdir(final):
        old = final + ".replaced"
        if os.path.isdir(old):
            shutil.rmtree(old)
        os.replace(final, old)
        os.replace(stage, final)
        shutil.rmtree(old, ignore_errors=True)
    else:
        os.replace(stage, final)
    _fsync_dir(save_dir)
    return final


def write_latest(save_dir: str, tag: str) -> None:
    """Atomic ``latest`` update: a crash leaves the old pointer or the new
    one, never a truncated file."""
    chaos.failpoint("ckpt.latest")
    tmp = os.path.join(save_dir, LATEST_FILE + STAGING_SUFFIX)
    with open(tmp, "w") as f:
        f.write(tag)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, os.path.join(save_dir, LATEST_FILE))
    _fsync_dir(save_dir)


def quarantine_staging(stage_dir: str, reason: str = "") -> Optional[str]:
    """Move a failed save's staging dir to ``<tag>.failed`` so the next
    save of the same tag starts clean. A staging dir whose marker is
    present (only the publish failed) is left for publish recovery at the
    next load. Never raises (this runs on failure paths)."""
    try:
        if not os.path.isdir(stage_dir):
            return None
        if os.path.exists(os.path.join(stage_dir, CKPT_META_FILE)):
            logger.error(
                "checkpoint save failed (%s) AFTER its staging dir was "
                "fully durable; leaving %s for publish recovery at the "
                "next load", reason or "see prior log", stage_dir)
            return None
        base = (stage_dir[:-len(STAGING_SUFFIX)]
                if stage_dir.endswith(STAGING_SUFFIX) else stage_dir)
        dst = base + QUARANTINE_SUFFIX
        n = 0
        while os.path.exists(dst):
            n += 1
            dst = f"{base}{QUARANTINE_SUFFIX}.{n}"
        os.replace(stage_dir, dst)
        logger.error("checkpoint save failed (%s): staging quarantined at %s",
                     reason or "see prior log", dst)
        return dst
    except OSError as e:  # pragma: no cover - double fault
        logger.error("could not quarantine %s: %s", stage_dir, e)
        return None


# ---------------------------------------------------------------------------
# Verification, tag enumeration, rollback, retention
# ---------------------------------------------------------------------------

def verify_tag(ckpt_dir: str, check_digests: bool = True) -> Optional[str]:
    """``None`` when the tag is intact, else a human-readable reason.
    Tags from before the marker format pass on a structural check alone,
    with a warning."""
    if not os.path.isdir(ckpt_dir):
        return "missing directory"
    try:
        with open(os.path.join(ckpt_dir, META_FILE)) as f:
            json.load(f)
    except (OSError, ValueError) as e:
        return f"unreadable {META_FILE} ({e.__class__.__name__})"
    marker_path = os.path.join(ckpt_dir, CKPT_META_FILE)
    if not os.path.exists(marker_path):
        has_model = (
            os.path.exists(os.path.join(ckpt_dir, "model_states.npz"))
            or glob.glob(os.path.join(ckpt_dir, "model_states-shard*.npz")))
        if not has_model:
            return "no completion marker and no model_states data"
        logger.warning(
            "checkpoint %s predates the completion-marker format; loading "
            "without digest verification", ckpt_dir)
        return None
    try:
        with open(marker_path) as f:
            marker = json.load(f)
    except (OSError, ValueError) as e:
        return f"unreadable {CKPT_META_FILE} ({e.__class__.__name__})"
    files = marker.get("files", {})
    if not any(n.startswith("model_states") for n in files):
        return "completion marker lists no model_states data"
    for name, info in files.items():
        path = os.path.join(ckpt_dir, name)
        if not os.path.exists(path):
            return f"missing file {name}"
        if os.path.getsize(path) != info.get("size"):
            return (f"size mismatch for {name}: {os.path.getsize(path)} != "
                    f"{info.get('size')}")
    num_shards = marker.get("num_shards")
    shard_files = [n for n in files if n.startswith("model_states-shard")]
    if shard_files and num_shards is not None \
            and len(shard_files) != num_shards:
        return (f"marker lists {len(shard_files)} model shards, "
                f"expected {num_shards}")
    if check_digests:
        for name, info in files.items():
            got = file_digest(os.path.join(ckpt_dir, name))
            if got != info.get("sha256"):
                return f"digest mismatch for {name}"
    return None


def _is_reserved_name(name: str) -> bool:
    return (name.endswith(STAGING_SUFFIX) or name.endswith(".replaced")
            or name.endswith(QUARANTINE_SUFFIX)
            or f"{QUARANTINE_SUFFIX}." in name)


def _tag_sort_key(save_dir: str, tag: str) -> Tuple[int, float]:
    step = -1
    try:
        with open(os.path.join(save_dir, tag, META_FILE)) as f:
            step = int(json.load(f).get("step", -1))
    except (OSError, ValueError):
        pass
    try:
        mtime = os.path.getmtime(os.path.join(save_dir, tag))
    except OSError:
        mtime = 0.0
    return (step, mtime)


def list_tags(save_dir: str) -> List[str]:
    """Published (non-staging, non-quarantined) tags, oldest -> newest by
    recorded step, then directory mtime."""
    if not os.path.isdir(save_dir):
        return []
    out = []
    for name in sorted(os.listdir(save_dir)):
        path = os.path.join(save_dir, name)
        if not os.path.isdir(path) or _is_reserved_name(name):
            continue
        if not (os.path.exists(os.path.join(path, META_FILE))
                or os.path.exists(os.path.join(path, CKPT_META_FILE))):
            continue
        out.append(name)
    out.sort(key=lambda t: _tag_sort_key(save_dir, t))
    return out


def _recover_interrupted_publishes(load_dir: str) -> None:
    """Finish publishes a crash interrupted: a ``<tag>.tmp`` holding its
    marker is fully durable, so it is promoted; ``.replaced`` debris whose
    tag is live again is swept. Never raises."""
    try:
        names = os.listdir(load_dir)
    except OSError:
        return
    for name in names:
        if not name.endswith(STAGING_SUFFIX):
            continue
        tag = name[:-len(STAGING_SUFFIX)]
        if not tag or tag == LATEST_FILE:
            continue
        stage = os.path.join(load_dir, name)
        if not os.path.isdir(stage) \
                or os.path.isdir(os.path.join(load_dir, tag)) \
                or not os.path.exists(os.path.join(stage, CKPT_META_FILE)):
            continue        # debris or not yet durable: leave for quarantine
        try:
            publish_tag(load_dir, tag)
            logger.warning("recovered interrupted publish of checkpoint "
                           "'%s' (marker was durable, rename was not)", tag)
        except OSError as e:
            logger.error("could not recover interrupted publish of %s: %s",
                         tag, e)
    for name in names:
        if name.endswith(".replaced") and os.path.isdir(
                os.path.join(load_dir, name[:-len(".replaced")])):
            shutil.rmtree(os.path.join(load_dir, name), ignore_errors=True)


def resolve_load_tag(load_dir: str, check_digests: bool = True) -> str:
    """The newest intact tag under ``load_dir``. Corrupt or partial tags
    are skipped (logged, left in place); if the survivor differs from what
    ``latest`` points at, ``latest`` is repaired to match."""
    _recover_interrupted_publishes(load_dir)
    latest = get_latest_tag(load_dir)
    tags = list_tags(load_dir)[::-1]                      # newest first
    if not tags:
        raise FileNotFoundError(
            f"no checkpoint tags under {load_dir}"
            + ("" if latest else f" (and no '{LATEST_FILE}' tag file)"))
    skipped: List[Tuple[str, str]] = []
    for tag in tags:
        reason = verify_tag(os.path.join(load_dir, tag),
                            check_digests=check_digests)
        if reason is not None:
            skipped.append((tag, reason))
            logger.warning("skipping corrupt checkpoint %s: %s",
                           os.path.join(load_dir, tag), reason)
            continue
        if tag != latest:
            logger.warning(
                "rolling back to newest intact checkpoint '%s' "
                "(%r pointed at %r%s)", tag, LATEST_FILE, latest,
                f"; skipped {[t for t, _ in skipped]}" if skipped else "")
            try:
                write_latest(load_dir, tag)
            except OSError as e:
                logger.error("could not repair %s: %s", LATEST_FILE, e)
        return tag
    detail = "; ".join(f"{t}: {r}" for t, r in skipped)
    raise FileNotFoundError(
        f"no intact checkpoint under {load_dir} ({detail})")


def prune_checkpoints(save_dir: str, keep_last: int, keep_every: int = 0,
                      protect: Optional[Set[str]] = None) -> List[str]:
    """Retention GC: keep the newest ``keep_last`` tags, every tag whose
    recorded step is a positive multiple of ``keep_every``, whatever
    ``latest`` points at, and ``protect``. Returns the removed tags.
    ``keep_last <= 0`` is a no-op."""
    if keep_last <= 0:
        return []
    protect = set(protect or ())
    latest = get_latest_tag(save_dir)
    if latest:
        protect.add(latest)
    tags = list_tags(save_dir)                            # oldest -> newest
    keep = set(tags[-keep_last:]) | protect
    if keep_every > 0:
        for tag in tags:
            step, _ = _tag_sort_key(save_dir, tag)
            if step > 0 and step % keep_every == 0:
                keep.add(tag)
    removed = []
    for tag in tags:
        if tag in keep:
            continue
        shutil.rmtree(os.path.join(save_dir, tag), ignore_errors=True)
        removed.append(tag)
    if removed:
        logger.info("checkpoint retention: removed %s (keep_last=%d, "
                    "keep_every=%d)", removed, keep_last, keep_every)
    return removed


def get_latest_tag(load_dir: str) -> Optional[str]:
    latest = os.path.join(load_dir, LATEST_FILE)
    if not os.path.exists(latest):
        return None
    try:
        with open(latest) as f:
            tag = f.read().strip()
    except OSError:
        return None
    return tag or None


# ---------------------------------------------------------------------------
# Save / load
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class TrainState:
    """What a checkpoint holds, as flat path-keyed dicts of live leaves
    (:class:`Leaf`, tensors or host arrays) plus the scalar counters of the
    JAX package's ``TrainState``. ``opt_state`` keys are the optimizer
    slots' paths (``m/<path>``, ``v/<path>``); ``master`` is None when the
    master aliases the parameters."""
    params: Dict[str, Any]
    opt_state: Dict[str, Any]
    master: Optional[Dict[str, Any]] = None
    step: int = 0
    skipped_steps: int = 0
    nonfinite_streak: int = 0
    loss_scale: float = 1.0
    scale_good_steps: int = 0
    scale_hysteresis: int = 2


def _world_size() -> int:
    import torch.distributed as dist
    return (dist.get_world_size()
            if dist.is_available() and dist.is_initialized() else 1)


def _build_meta(state: TrainState, client_state,
                master_aliases_params, num_shards: int = 1
                ) -> Dict[str, Any]:
    return {
        "master_aliases_params": master_aliases_params,
        "sharded": num_shards > 1,
        "num_shards": num_shards,
        "step": int(state.step),
        "skipped_steps": int(state.skipped_steps),
        "nonfinite_streak": int(state.nonfinite_streak),
        "loss_scale": float(state.loss_scale),
        "scale_good_steps": int(state.scale_good_steps),
        "scale_hysteresis": int(state.scale_hysteresis),
        "client_state": client_state or {},
    }


def _write_meta(stage_dir: str, meta: Dict[str, Any]) -> None:
    chaos.failpoint("ckpt.meta")
    with open(os.path.join(stage_dir, META_FILE), "w") as f:
        json.dump(meta, f, indent=2)


def _finalize_tag(save_dir: str, tag: str, num_shards: int,
                  keep_last: Optional[int], keep_every: int) -> None:
    """Marker -> publish -> latest -> retention, FIFO-ordered behind the
    data writes. Idempotent past the publish: a retried job after a
    successful rename only rewrites ``latest``."""
    stage_dir = os.path.join(save_dir, tag + STAGING_SUFFIX)
    if os.path.isdir(stage_dir):
        write_completion_marker(stage_dir, num_shards=num_shards)
        publish_tag(save_dir, tag)
    elif not os.path.isdir(os.path.join(save_dir, tag)):
        raise FileNotFoundError(
            f"nothing to finalize for checkpoint '{tag}': neither "
            f"{stage_dir} nor a published tag exists")
    write_latest(save_dir, tag)
    logger.info(f"saved checkpoint {os.path.join(save_dir, tag)}")
    if keep_last:
        prune_checkpoints(save_dir, keep_last, keep_every, protect={tag})


def _optim_group(state: TrainState) -> Dict[str, Any]:
    group = {"opt_state/" + k: v for k, v in state.opt_state.items()}
    if state.master is not None:
        group.update({"master/" + k: v for k, v in state.master.items()})
    return {k: group[k] for k in _sorted_keys(group)}


def _snapshot(flat: Dict[str, Any], lazy: bool) -> Dict[str, Any]:
    """The writer's view of a flat dict: thunks that read one leaf at a
    time (``lazy``, sync writers), else host copies taken now — pinned,
    one per leaf — so an async writer never sees a later in-place
    update."""
    out: Dict[str, Any] = {}
    pinned = False
    for k in _sorted_keys(flat):
        v = flat[k]
        if isinstance(v, Leaf):
            if lazy:
                out[k] = v.read
            else:
                out[k] = v.read(pinned=True)
                pinned = pinned or v.parts[0].device.type == "cuda"
        elif isinstance(v, torch.Tensor) and not lazy:
            out[k] = v.detach().to("cpu", copy=True)
        else:
            out[k] = v
    if pinned:
        torch.cuda.synchronize()
    return out


def save_checkpoint(save_dir: str,
                    tag: str,
                    state: TrainState,
                    client_state: Optional[Dict[str, Any]] = None,
                    master_aliases_params: bool = False,
                    ckpt_engine=None,
                    keep_last: Optional[int] = None,
                    keep_every: int = 0) -> str:
    """Write ``{save_dir}/{tag}/`` atomically (staging dir + marker +
    rename); update ``latest`` only after the tag is fully durable.

    ``master_aliases_params``: the master is the parameter tree (fp32 and
    pure-bf16 training), so ``optim_states.npz`` holds no ``master/``
    group. ``ckpt_engine``: a ``checkpoint.engine.CheckpointEngine`` —
    async engines do the file IO off-thread, FIFO-ordered, and a failed
    write quarantines the staging dir instead of publishing.
    ``keep_last`` / ``keep_every``: retention GC after the publish."""
    if _world_size() > 1:
        raise NotImplementedError(
            "save_checkpoint writes one process's whole state; in a "
            "torch.distributed world larger than one each rank writes its "
            "own pieces through save_checkpoint_sharded (ROADMAP item 2.6)")
    ckpt_dir = os.path.join(save_dir, tag)
    stage_dir = ckpt_dir + STAGING_SUFFIX
    if ckpt_engine is None:
        from ..checkpoint.engine import NpzCheckpointEngine
        ckpt_engine = NpzCheckpointEngine()
    os.makedirs(save_dir, exist_ok=True)
    if os.path.isdir(stage_dir):
        # a previous save of this tag may still be writing (async): drain
        # it before touching the staging dir
        ckpt_engine.commit(tag)
        if os.path.isdir(stage_dir):
            shutil.rmtree(stage_dir)
    os.makedirs(stage_dir)
    ckpt_engine.create(tag, stage_dir=stage_dir)
    lazy = getattr(ckpt_engine, "wants_lazy", True)
    meta = _build_meta(state, client_state, master_aliases_params)
    try:
        ckpt_engine.save(_snapshot(state.params, lazy),
                         os.path.join(stage_dir, "model_states.npz"))
        ckpt_engine.save(_snapshot(_optim_group(state), lazy),
                         os.path.join(stage_dir, "optim_states.npz"))
        ckpt_engine.run(lambda: _write_meta(stage_dir, meta),
                        label=os.path.join(stage_dir, META_FILE))
        ckpt_engine.run(
            lambda: _finalize_tag(save_dir, tag, 1, keep_last, keep_every),
            label=f"finalize:{tag}")
    except Exception as e:
        quarantine_staging(stage_dir, reason=f"{e.__class__.__name__}: {e}")
        raise
    return ckpt_dir


def shard_flat_dict(flat: Dict[str, Any], rank: int) -> Dict[str, Any]:
    """This rank's pieces of ``flat`` (:class:`Leaf` s, or tensors every
    rank holds whole) as a flat dict keyed ``<path>::<n>``, plus the
    ``__manifest__`` of global shapes and piece offsets that both
    packages' sharded readers take. A split leaf contributes this rank's
    boxes of the whole (:meth:`Leaf.pieces`: a slab, or a TP shard's
    segments, each at its global offsets); a whole one is written by rank
    0 only, so every element is stored once across the job."""
    out: Dict[str, Any] = {}
    manifest: Dict[str, Any] = {}
    for key in _sorted_keys(flat):
        v = flat[key]
        split = isinstance(v, Leaf) and v.partial
        shape = list(v.shape) if isinstance(v, (Leaf, torch.Tensor)) \
            else list(np.shape(v))
        pieces = []
        writes = v.writes if isinstance(v, Leaf) else None
        if writes if writes is not None else (split or rank == 0):
            boxes = v.pieces() if split else [([0] * len(shape), None)]
            for n, (start, index) in enumerate(boxes):
                name = f"{key}::{n}"
                out[name] = v if index is None or len(boxes) == 1 and \
                    _covers(v, index) else v.piece(index)
                pieces.append({"name": name, "start": start})
        manifest[key] = {"shape": shape, "pieces": pieces}
    out[_MANIFEST_KEY] = np.frombuffer(json.dumps(manifest).encode(),
                                       dtype=np.uint8)
    return out


def _covers(leaf: Leaf, index: Tuple[slice, ...]) -> bool:
    """Whether ``index`` takes the whole of each part."""
    return all(sl.start == 0 and sl.stop == n
               for sl, n in zip(index, leaf.parts[0].shape))


def save_checkpoint_sharded(save_dir: str,
                            tag: str,
                            state: TrainState,
                            client_state: Optional[Dict[str, Any]] = None,
                            master_aliases_params: bool = False,
                            ckpt_engine=None,
                            keep_last: Optional[int] = None,
                            keep_every: int = 0) -> str:
    """The sharded save of a process group (the JAX package's
    ``_save_checkpoint_multiprocess``): every rank writes its pieces of
    ``state`` (:func:`shard_flat_dict`) into the shared staging dir; a
    rank's write failure is folded into an all-reduced ok flag, never
    raised before the collective, so no rank hangs; only if every rank
    wrote does rank 0 write the meta, the marker, publish and ``latest``.
    A last all-reduce makes the save durable on every rank when it
    returns and raises on every rank if rank 0's finalize failed. Async
    writers are drained here. Returns the tag's directory."""
    from .. import comm
    import torch.distributed as dist
    rank, world = dist.get_rank(), dist.get_world_size()
    ckpt_dir = os.path.join(save_dir, tag)
    stage_dir = ckpt_dir + STAGING_SUFFIX
    if ckpt_engine is None:
        from ..checkpoint.engine import NpzCheckpointEngine
        ckpt_engine = NpzCheckpointEngine()
    os.makedirs(save_dir, exist_ok=True)
    if rank == 0 and os.path.isdir(stage_dir):
        shutil.rmtree(stage_dir)        # stale staging from a crashed save
    comm.barrier(f"ckpt-stage-{tag}")
    os.makedirs(stage_dir, exist_ok=True)
    # no stage_dir registered: one rank's commit() must not quarantine
    # the shared staging dir while the others still write
    ckpt_engine.create(tag)
    lazy = getattr(ckpt_engine, "wants_lazy", True)
    local_ok = True
    try:
        ckpt_engine.save(_snapshot(shard_flat_dict(state.params, rank), lazy),
                         os.path.join(stage_dir,
                                      f"model_states-shard{rank}.npz"))
        ckpt_engine.save(_snapshot(shard_flat_dict(_optim_group(state), rank),
                                   lazy),
                         os.path.join(stage_dir,
                                      f"optim_states-shard{rank}.npz"))
    except Exception as e:
        logger.error("rank %d shard write for %s failed: %s", rank, tag, e)
        local_ok = False
    ok = bool(ckpt_engine.commit(tag)) and local_ok
    if not _all_ok(ok):
        logger.error(f"sharded checkpoint {ckpt_dir}: a rank's shard write "
                     "failed; leaving `latest` on the previous checkpoint")
        if rank == 0:
            quarantine_staging(stage_dir,
                               reason="a rank's shard write failed")
        return ckpt_dir
    err = None
    if rank == 0:
        try:
            _write_meta(stage_dir, _build_meta(state, client_state,
                                               master_aliases_params, world))
            _finalize_tag(save_dir, tag, world, keep_last, keep_every)
        except Exception as e:
            quarantine_staging(stage_dir,
                               reason=f"{e.__class__.__name__}: {e}")
            err = e
    if not _all_ok(err is None):
        if err is not None:
            raise err
        raise RuntimeError(f"sharded checkpoint {ckpt_dir}: rank 0 failed "
                           "to publish it")
    return ckpt_dir


def _all_ok(ok: bool) -> bool:
    """True iff ``ok`` on every rank of the world (one all-reduce on the
    group's device). It spans every mesh axis, not ``data``'s group
    alone: under a mesh whose data group is smaller than the world, rank
    0 would otherwise digest and publish shards that other ranks were
    still writing."""
    from .. import comm
    from ..parallel.mesh import MESH_AXES
    import torch.distributed as dist
    dev = (torch.device("cuda", torch.cuda.current_device())
           if dist.get_backend() == "nccl" else torch.device("cpu"))
    flag = torch.tensor([1.0 if ok else 0.0], device=dev)
    comm.all_reduce(flag, op=comm.ReduceOp.MIN, axis=MESH_AXES)
    return bool(flag.item() == 1.0)


def open_states(ckpt_dir: str, base: str, meta: Dict[str, Any]):
    """A reader of a tag's ``base`` states: its one whole-leaf file, or
    the ``-shard*`` files of a process group (leaves assembled from their
    pieces)."""
    path = os.path.join(ckpt_dir, base + ".npz")
    if os.path.exists(path):
        return FlatNpz(path)
    return ShardedNpz(ckpt_dir, base, expected_shards=meta.get("num_shards"))


def read_meta(ckpt_dir: str) -> Dict[str, Any]:
    with open(os.path.join(ckpt_dir, META_FILE)) as f:
        return json.load(f)


def resolve_tag(load_dir: str, tag: Optional[str], verify: bool) -> str:
    """``tag=None``: the newest intact tag (rolling back over corrupt
    ones); an explicit tag is verified and raises
    :class:`CheckpointIntegrityError` when corrupt."""
    if tag is None:
        return resolve_load_tag(load_dir, check_digests=verify)
    if verify:
        reason = verify_tag(os.path.join(load_dir, tag))
        if reason is not None:
            raise CheckpointIntegrityError(
                f"checkpoint {os.path.join(load_dir, tag)} failed "
                f"verification: {reason}")
    return tag


def load_checkpoint(load_dir: str, tag: Optional[str], state: TrainState,
                    verify: bool = True) -> Tuple[TrainState, Dict[str, Any]]:
    """Load into the live leaves of ``state``, one leaf at a time, and
    return (state with the meta's counters, client_state).

    ``tag=None`` resumes from the newest intact tag, rolling back over
    corrupt or partial ones; an explicit tag is verified and raises
    :class:`CheckpointIntegrityError` when corrupt. The parameters come
    from ``model_states`` — or from the checkpoint's ``master/`` group
    when ``state`` has no master of its own (a master-less engine loading
    a mixed-precision checkpoint, as the JAX engine does); ``state``'s
    master from the ``master/`` group, or from ``model_states`` when the
    checkpoint's master aliases its parameters."""
    tag = resolve_tag(load_dir, tag, verify)
    ckpt_dir = os.path.join(load_dir, tag)
    meta = read_meta(ckpt_dir)
    aliased = bool(meta.get("master_aliases_params"))
    model = open_states(ckpt_dir, "model_states", meta)
    optim = open_states(ckpt_dir, "optim_states", meta)
    try:
        if state.master is None and not aliased:
            _restore(optim, state.params, "master/")
        else:
            _restore(model, state.params)
        if state.master is not None:
            if aliased:
                _restore(model, state.master)
            else:
                _restore(optim, state.master, "master/")
        _restore(optim, state.opt_state, "opt_state/")
    finally:
        model.close()
        optim.close()
    state = dataclasses.replace(
        state, step=int(meta["step"]),
        skipped_steps=int(meta["skipped_steps"]),
        nonfinite_streak=int(meta.get("nonfinite_streak", 0)),
        loss_scale=float(meta["loss_scale"]),
        scale_good_steps=int(meta["scale_good_steps"]),
        scale_hysteresis=int(meta["scale_hysteresis"]))
    logger.info(f"loaded checkpoint {ckpt_dir} at step {meta['step']}")
    return state, meta.get("client_state", {})


def consolidated_fp32_state_dict(state: TrainState) -> Dict[str, np.ndarray]:
    """The master weights (or the parameters, when the master aliases
    them) as one host fp32 numpy dict (the zero_to_fp32 equivalent)."""
    src = state.master if state.master is not None else state.params
    out = {}
    for k in _sorted_keys(src):
        v = src[k]
        t = v.read() if isinstance(v, Leaf) else torch.as_tensor(v)
        out[k] = t.to(torch.float32).numpy()
    return out


def save_16bit_model(state: TrainState, path: str) -> None:
    """The parameters in their compute dtype, name-keyed (the reference's
    ``engine.save_16bit_model``)."""
    save_tree(state.params, path)
