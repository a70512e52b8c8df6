"""Fault-tolerant checkpointing, Mez-log style (the paper's Section 4.4
applied to training state).

The port of the JAX package's ``checkpoint/checkpointer.py``, with its
on-disk layout:

  <root>/step_<n>/MANIFEST.json       {step, keys, crcs, dtypes, meta}
  <root>/step_<n>/<flatkey>.npy       one full (unsharded) array per leaf

  * per-leaf files with CRC32 integrity records: a torn or corrupted leaf
    discards the whole step and recovery falls back to the previous valid
    step (the paper's "partially written segments ... discarded during the
    recovery process");
  * atomic publication: write to ``step_<n>.tmp``, fsync, rename;
  * ``keep`` newest steps are kept, older ones deleted;
  * ``save_async`` snapshots host copies of the leaves, then writes them
    off the training loop's critical path.

Trees are nested dicts of tensors (or NumPy arrays); the flat key of a
leaf is its key path joined with ``/`` (``repro_torch.tree``), the JAX
package's key.  NumPy has no bfloat16 without ``ml_dtypes``, so a
bfloat16 leaf is stored as its ``uint16`` bits and the manifest records
its dtype; ``restore`` gives it back as bfloat16.  The JAX package's
manifest records no dtypes, and its ``np.save`` of an ``ml_dtypes``
bfloat16 leaf writes 2-byte void records (``|V2``): ``restore`` reads
those as bfloat16 bits where the target leaf is bfloat16, and raises
``ValueError`` for any other void leaf.  ``restore`` places each leaf on
one device (default ``"cuda"``) or, given ``shardings`` (a tree of
``sharding.partition.NamedSharding`` on a ``DeviceMesh``), puts each
rank's block of it back as a ``DTensor``: the stored arrays are whole, so
any mesh restores any checkpoint.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import zlib
from typing import Any

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.tree import tree_items, tree_map, tree_map_with_keys

__all__ = ["Checkpointer"]

_BF16 = "bfloat16"


class _HostLeaf:
    """A leaf copied to the host (``save_async``'s snapshot): a copy of
    its own, also of a CPU tensor or an array, whose memory the caller may
    go on writing."""

    def __init__(self, leaf):
        self.arr, self.dtype_name = _to_numpy(leaf)
        if not (isinstance(leaf, torch.Tensor) and leaf.device.type != "cpu"):
            self.arr = self.arr.copy()


def _to_numpy(leaf) -> tuple[np.ndarray, str]:
    """A host copy of one leaf and the dtype name the manifest records."""
    if isinstance(leaf, _HostLeaf):
        return leaf.arr, leaf.dtype_name
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), _BF16
        a = t.numpy()
    else:
        a = np.asarray(leaf)
    return a, a.dtype.name


def _from_numpy(arr: np.ndarray, dtype_name: str, device) -> torch.Tensor:
    if dtype_name == _BF16:
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    return t.to(device)


def _stored_dtype(key: str, arr: np.ndarray, leaf) -> str:
    """The dtype name of a leaf that the manifest does not type (a JAX
    checkpoint's): NumPy's own, but a 2-byte void leaf -- ``np.save`` of an
    ``ml_dtypes`` bfloat16 array -- is bfloat16 bits, which only a bfloat16
    target leaf may claim."""
    if arr.dtype.kind != "V":
        return arr.dtype.name
    target = getattr(leaf, "dtype", None)
    if arr.dtype.itemsize == 2 and target == torch.bfloat16:
        return _BF16
    raise ValueError(f"{key}: stored as untyped {arr.dtype.str} records, "
                     f"target leaf is {target}; only a 2-byte leaf restored "
                     f"into a bfloat16 target is read (as bfloat16 bits)")


def _fname(key: str) -> str:
    return key.replace("/", "__") + ".npy"


def _crc(path: str) -> str:
    with open(path, "rb") as fh:
        return f"{zlib.crc32(fh.read()) & 0xFFFFFFFF:08x}"


class Checkpointer:
    def __init__(self, root: str, *, keep: int = 3):
        self.root = root
        self.keep = keep
        os.makedirs(root, exist_ok=True)
        self._lock = threading.Lock()

    # -- save -----------------------------------------------------------------
    def save(self, step: int, tree: Any, *, meta: dict | None = None) -> str:
        """Write one checkpoint atomically; returns the final directory."""
        with self._lock:
            final = os.path.join(self.root, f"step_{step:08d}")
            tmp = final + ".tmp"
            if os.path.exists(tmp):
                shutil.rmtree(tmp)
            os.makedirs(tmp)
            crcs, dtypes = {}, {}
            for key, leaf in tree_items(tree):
                arr, dtypes[key] = _to_numpy(leaf)
                path = os.path.join(tmp, _fname(key))
                with open(path, "wb") as fh:
                    np.save(fh, arr)
                    fh.flush()
                    os.fsync(fh.fileno())
                crcs[key] = _crc(path)
            manifest = {"step": step, "keys": sorted(crcs), "crcs": crcs,
                        "dtypes": dtypes, "meta": meta or {}}
            with open(os.path.join(tmp, "MANIFEST.json"), "w") as fh:
                json.dump(manifest, fh, indent=1)
                fh.flush()
                os.fsync(fh.fileno())
            if os.path.exists(final):
                shutil.rmtree(final)
            os.replace(tmp, final)
            self._gc()
            return final

    def save_async(self, step: int, tree: Any, **kw) -> threading.Thread:
        """Background save (off the training critical path).  Host copies of
        the leaves are taken before this returns, so training can go on
        writing its tensors."""
        host = tree_map(_HostLeaf, tree)
        t = threading.Thread(target=self.save, args=(step, host), kwargs=kw,
                             daemon=True)
        t.start()
        return t

    # -- restore --------------------------------------------------------------
    def steps(self) -> list[int]:
        out = []
        for name in os.listdir(self.root):
            if name.startswith("step_") and not name.endswith(".tmp"):
                try:
                    out.append(int(name.split("_")[1]))
                except ValueError:
                    pass
        return sorted(out)

    def _manifest(self, step: int) -> dict | None:
        path = os.path.join(self.root, f"step_{step:08d}", "MANIFEST.json")
        if not os.path.exists(path):
            return None
        try:
            with open(path) as fh:
                return json.load(fh)
        except json.JSONDecodeError:
            return None

    def _valid(self, step: int) -> bool:
        d = os.path.join(self.root, f"step_{step:08d}")
        manifest = self._manifest(step)
        if manifest is None:
            return False
        for key in manifest["keys"]:
            path = os.path.join(d, _fname(key))
            if not os.path.exists(path) or _crc(path) != manifest["crcs"][key]:
                return False
        return True

    def latest_valid_step(self) -> int | None:
        """Newest step whose every leaf passes CRC (torn steps skipped)."""
        for step in reversed(self.steps()):
            if self._valid(step):
                return step
        return None

    def restore(self, target_tree: Any, *, step: int | None = None,
                device: "str | torch.device | None" = None,
                shardings: Any = None) -> tuple[Any, int]:
        """Restore into the structure of ``target_tree`` (its leaves give
        the keys and the shapes; the stored dtypes are kept) from ``step``
        (default: the newest valid one), every leaf on ``device`` (default
        ``"cuda"``; without a CUDA device the default raises
        ``RuntimeError``).  A leaf the manifest does not type takes NumPy's
        dtype, or bfloat16 for 2-byte void records aimed at a bfloat16
        target (``_stored_dtype``).  Raises ``FileNotFoundError`` when no
        valid step exists and ``ValueError`` on a shape mismatch or on void
        records aimed at any other target.  With ``shardings`` (a tree of
        ``NamedSharding`` matching ``target_tree``) each leaf becomes the
        ``DTensor`` of this rank's block, read from the whole array."""
        dev = resolve_device(device)
        step = step if step is not None else self.latest_valid_step()
        if step is None:
            raise FileNotFoundError(f"no valid checkpoint under {self.root}")
        d = os.path.join(self.root, f"step_{step:08d}")
        dtypes = (self._manifest(step) or {}).get("dtypes", {})

        def load(key, leaf):
            arr = np.load(os.path.join(d, _fname(key)))
            if tuple(arr.shape) != tuple(leaf.shape):
                raise ValueError(f"shape mismatch for {key}: "
                                 f"{arr.shape} vs {tuple(leaf.shape)}")
            name = dtypes.get(key) or _stored_dtype(key, arr, leaf)
            return _from_numpy(arr, name, dev)

        tree = tree_map_with_keys(load, target_tree)
        if shardings is not None:
            tree = tree_map(lambda x, sh: sh.distribute(x), tree, shardings)
        return tree, step

    # -- gc -------------------------------------------------------------------
    def _gc(self) -> None:
        steps = self.steps()
        for s in steps[: max(0, len(steps) - self.keep)]:
            shutil.rmtree(os.path.join(self.root, f"step_{s:08d}"),
                          ignore_errors=True)

    # -- test helper ----------------------------------------------------------
    def corrupt(self, step: int, *, leaf_index: int = 0) -> None:
        """Flip a byte in one leaf (emulates a torn write for tests)."""
        manifest = self._manifest(step)
        key = manifest["keys"][leaf_index]
        path = os.path.join(self.root, f"step_{step:08d}", _fname(key))
        with open(path, "r+b") as fh:
            fh.seek(-1, 2)
            b = fh.read(1)
            fh.seek(-1, 2)
            fh.write(bytes([b[0] ^ 0xFF]))
