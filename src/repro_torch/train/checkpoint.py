"""Log-anchored checkpointing, the port of ``train/checkpoint.py`` (paper
§3.2 snapshot store, applied to the training environment).

A checkpoint records (params, optimizer state, data cursor, step) plus the
**AgentBus position** it corresponds to, so recovery = load latest
checkpoint + replay the log suffix. Integrity: the array file carries a
checksum; ``verify`` is what the rule-voter's checkpoint-integrity
precondition calls before a ``restore`` intention is approved.

The format is the reference's: one ``state.npz`` of the state tree's
leaves under their ``/``-joined key paths (``params/layers/attn/wq``,
``opt/v/embed/vr``, ``opt/step``), plus a JSON manifest with the file's
SHA-256. Writes are atomic (tmp + rename) and the manifest is written
last, so a crash mid-write never yields a checkpoint that ``latest()``
would return. A checkpoint saved by either package restores into the
other. The file is hashed in chunks, so a full-width checkpoint (16 GB)
is not read into memory at once; the digest is the same.
"""
from __future__ import annotations

import hashlib
import json
import os
import time
from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from ..models.params import params_to_numpy

_HASH_CHUNK = 64 << 20


def _flatten(tree: Any, prefix: str = "") -> Dict[str, np.ndarray]:
    """A tree of numpy arrays -> {"/"-joined key path: array}."""
    if isinstance(tree, dict):
        flat = {}
        for k, v in tree.items():
            flat.update(_flatten(v, f"{prefix}{k}/"))
        return flat
    return {prefix[:-1]: tree}


def _unflatten_into(tree: Any, flat: Mapping[str, np.ndarray],
                    prefix: str = "") -> Any:
    if isinstance(tree, dict):
        return {k: _unflatten_into(v, flat, f"{prefix}{k}/")
                for k, v in tree.items()}
    key = prefix[:-1]
    arr = flat[key]
    assert arr.shape == tuple(tree.shape), (key, arr.shape, tree.shape)
    return torch.from_numpy(arr).to(device=tree.device, dtype=tree.dtype)


def _sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(_HASH_CHUNK), b""):
            h.update(block)
    return h.hexdigest()


class CheckpointStore:
    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)

    def _dir(self, step: int) -> str:
        return os.path.join(self.root, f"step-{step:010d}")

    def save(self, step: int, state: Any, *, log_position: int,
             data_cursor: int, extra: Optional[Dict[str, Any]] = None) -> str:
        d = self._dir(step)
        tmp = d + ".tmp"
        os.makedirs(tmp, exist_ok=True)
        np.savez(os.path.join(tmp, "state.npz"),
                 **_flatten(params_to_numpy(state)))
        digest = _sha256(os.path.join(tmp, "state.npz"))
        manifest = {"step": step, "log_position": log_position,
                    "data_cursor": data_cursor, "sha256": digest,
                    "time": time.time(), "extra": extra or {}}
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(d):
            os.rename(d, d + f".old-{time.time_ns()}")
        os.rename(tmp, d)
        return d

    def list_steps(self) -> List[int]:
        out = []
        for n in os.listdir(self.root):
            if not (n.startswith("step-") and n[5:].isdigit()):
                continue  # skips .tmp / .old-* / .deleted-* variants
            if os.path.exists(os.path.join(self.root, n, "manifest.json")):
                out.append(int(n[5:]))
        return sorted(out)

    def latest(self) -> Optional[int]:
        steps = self.list_steps()
        return steps[-1] if steps else None

    def manifest(self, step: int) -> Dict[str, Any]:
        with open(os.path.join(self._dir(step), "manifest.json")) as f:
            return json.load(f)

    def verify(self, step: int) -> bool:
        """Checksum integrity check (rule-voter precondition)."""
        try:
            man = self.manifest(step)
            return _sha256(os.path.join(self._dir(step), "state.npz")) \
                == man["sha256"]
        except (FileNotFoundError, json.JSONDecodeError, KeyError):
            return False

    def restore(self, step: int, like: Any) -> Tuple[Any, Dict[str, Any]]:
        """The state saved at ``step``, as tensors shaped, typed and placed
        as the leaves of ``like``, and its manifest."""
        assert self.verify(step), f"checkpoint {step} failed integrity check"
        man = self.manifest(step)
        # one leaf at a time on the host: the npz is read key by key
        with np.load(os.path.join(self._dir(step), "state.npz")) as z:
            return _unflatten_into(like, z), man

    def delete(self, step: int, pinned: bool = False) -> None:
        if pinned:
            raise PermissionError("refusing to delete a pinned checkpoint")
        d = self._dir(step)
        os.rename(d, d + f".deleted-{time.time_ns()}")
