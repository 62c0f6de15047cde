"""Fault-tolerant checkpointing, as ``repro/checkpoint/checkpointer.py``.

  * atomic checkpoints: write to ``step_N.tmp`` then rename;
  * async save (background thread) so the train loop never blocks on IO;
  * keep-last-N retention + a persistent ``latest`` pointer;
  * resumable data iterator: (seed, step) round-trips via metadata, and
    batch t is a pure function of (seed, t) in the dataset layer;
  * preemption hook: SIGTERM triggers a final synchronous save.

Layout:  <dir>/step_<N>/{manifest.json, 000000.npy, 000001.npy, ...}

The layout, the manifest keys and the fault sites are the JAX
package's, so a directory written by one package is read by the other.
Every leaf's SHA-256 and byte count are recorded in the manifest before
the atomic rename, ``verify_step`` re-hashes a finished checkpoint
against them, and opening a ``Checkpointer`` sweeps ``*.tmp`` partials
left by a crash mid-write.  Fault sites: ``snapshot.write_leaf`` per
leaf, ``snapshot.finalize`` just before the rename.

Leaves come from the port's own flatten (``flatten``) in place of
``jax.tree.flatten``, in a fixed order: a dataclass by its fields in
declared order, a dict by sorted key, a list or tuple (named tuples
too) in order, a ``torch.nn.Module`` by its ``state_dict`` keys sorted,
and a tensor, array or Python number as one leaf (``None`` has none).
Tensors are copied to the host (``.cpu().numpy()``).  A bfloat16 tensor
has no numpy dtype: it is written as its bit pattern, a uint16 ``.npy``,
and the manifest's ``bf16_leaves`` lists its index, so ``restore``
reinterprets the bits and the leaf comes back bitwise.  The manifest's
``treedef`` is the port's own description of the structure; nothing
reads it back.
"""
from __future__ import annotations

import copy
import dataclasses
import hashlib
import json
import os
import shutil
import signal
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.faults import get_faults


class CheckpointCorruptError(RuntimeError):
    """A finished checkpoint failed checksum / completeness verification."""


_SCALARS = (bool, int, float)


def _children(tree) -> Tuple[str, List[Tuple[str, Any]]]:
    """``(kind, [(key, child), ...])`` of one node; a leaf is its own
    only child, under the key ``""``."""
    if tree is None:
        return "none", []
    if isinstance(tree, (torch.Tensor, np.ndarray, np.generic) + _SCALARS):
        return "leaf", [("", tree)]
    if isinstance(tree, torch.nn.Module):
        sd = tree.state_dict(keep_vars=True)
        return "module", [(k, sd[k]) for k in sorted(sd)]
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return "dataclass", [(f.name, getattr(tree, f.name))
                             for f in dataclasses.fields(tree)]
    if isinstance(tree, dict):
        return "dict", [(str(k), tree[k]) for k in sorted(tree)]
    if isinstance(tree, (list, tuple)):
        return "seq", [(str(i), c) for i, c in enumerate(tree)]
    raise TypeError(f"cannot checkpoint a {type(tree).__name__}")


def flatten(tree) -> Tuple[List[Any], str]:
    """The leaves of ``tree`` in the fixed order above, and the
    structure: each leaf's path, ``/``-joined, one per line."""
    leaves: List[Any] = []
    paths: List[str] = []

    def walk(t, path):
        kind, kids = _children(t)
        if kind == "leaf":
            leaves.append(t)
            paths.append(path)
            return
        for k, c in kids:
            walk(c, f"{path}/{k}" if path else k)

    walk(tree, "")
    return leaves, "\n".join(paths)


def unflatten(like, leaves: List[Any]):
    """A tree shaped like ``like`` holding ``leaves`` in ``flatten``'s
    order.  Modules are deep-copied and loaded; dataclasses are
    rebuilt with ``dataclasses.replace``."""
    it = iter(leaves)

    def build(t):
        kind, kids = _children(t)
        if kind == "leaf":
            return next(it)
        if kind == "none":
            return None
        keys = [k for k, _ in kids]
        new = [build(c) for _, c in kids]
        if kind == "module":
            m = copy.deepcopy(t)
            sd = m.state_dict(keep_vars=True)
            with torch.no_grad():
                for k, v in zip(keys, new):
                    sd[k].copy_(v)
            return m
        if kind == "dataclass":
            return dataclasses.replace(t, **{
                f.name: v for f, v in zip(dataclasses.fields(t), new)
                if f.init})
        if kind == "dict":
            return type(t)(zip(sorted(t), new))
        if hasattr(t, "_fields"):                      # a named tuple
            return type(t)(*new)
        return type(t)(new)

    return build(like)


def _sha256_file(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def _host_array(x) -> np.ndarray:
    """A leaf on the host; bf16 tensors as their uint16 bits."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16)
        return x.numpy()
    return np.asarray(x)


def _leaf_like(arr: np.ndarray, ref, bf16: bool):
    """A restored leaf in ``ref``'s kind, type and device."""
    if isinstance(ref, torch.Tensor):
        arr = np.ascontiguousarray(arr).reshape(arr.shape)   # keeps 0-d
        if bf16:
            t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
        else:
            t = torch.from_numpy(arr)
        return t.to(ref.device, ref.dtype)
    if isinstance(ref, _SCALARS):
        return type(ref)(arr.item())
    if hasattr(ref, "dtype") and arr.dtype != ref.dtype:
        arr = arr.astype(ref.dtype)
    return arr


class Checkpointer:
    def __init__(self, directory: str, *, keep: int = 3, faults=None):
        self.dir = directory
        self.keep = keep
        self.faults = faults if faults is not None else get_faults()
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._lock = threading.Lock()
        self.sweep_partials()

    def sweep_partials(self) -> List[str]:
        """Remove ``step_*.tmp`` partial dirs (and a stale ``latest.tmp``
        pointer) left behind by a crash mid-publish.  A partial is never
        loadable — ``all_steps`` skips ``.tmp`` — but sweeping keeps the
        store clean and reclaims the space.  Returns swept names."""
        swept = []
        for name in os.listdir(self.dir):
            p = os.path.join(self.dir, name)
            if name.startswith("step_") and name.endswith(".tmp"):
                shutil.rmtree(p, ignore_errors=True)
                swept.append(name)
            elif name == "latest.tmp":
                os.unlink(p)
                swept.append(name)
        return swept

    # -- save ---------------------------------------------------------------

    def save(self, step: int, tree: Any,
             metadata: Optional[Dict[str, Any]] = None,
             blocking: bool = True) -> None:
        leaves, treedef = flatten(tree)
        host_leaves = [_host_array(l) for l in leaves]
        meta = dict(metadata or {})
        meta["step"] = int(step)
        meta["treedef"] = treedef
        meta["n_leaves"] = len(host_leaves)
        bf16 = [i for i, l in enumerate(leaves)
                if isinstance(l, torch.Tensor) and l.dtype == torch.bfloat16]
        if bf16:
            meta["bf16_leaves"] = bf16
        if blocking:
            self._write(step, host_leaves, meta)
        else:
            self.wait()
            t = threading.Thread(target=self._write,
                                 args=(step, host_leaves, meta), daemon=True)
            self._thread = t
            t.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _write(self, step: int, host_leaves, meta) -> None:
        with self._lock:
            final = os.path.join(self.dir, f"step_{step}")
            tmp = final + ".tmp"
            shutil.rmtree(tmp, ignore_errors=True)
            os.makedirs(tmp)
            shas, sizes = [], []
            for i, arr in enumerate(host_leaves):
                leaf = os.path.join(tmp, f"{i:06d}.npy")
                np.save(leaf, arr, allow_pickle=False)
                shas.append(_sha256_file(leaf))
                sizes.append(os.path.getsize(leaf))
                # corrupt lands after the checksum is taken, so a flipped
                # byte is a detectable mismatch; crash leaves a .tmp dir
                self.faults.fire("snapshot.write_leaf", path=leaf,
                                 step=step, leaf=i)
            meta = dict(meta, leaf_sha256=shas, leaf_bytes=sizes)
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(meta, f)
            self.faults.fire("snapshot.finalize", step=step)
            shutil.rmtree(final, ignore_errors=True)
            os.rename(tmp, final)
            with open(os.path.join(self.dir, "latest.tmp"), "w") as f:
                f.write(str(step))
            os.replace(os.path.join(self.dir, "latest.tmp"),
                       os.path.join(self.dir, "latest"))
            self._gc()

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s}"),
                          ignore_errors=True)

    # -- restore --------------------------------------------------------------

    def all_steps(self) -> List[int]:
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and not name.endswith(".tmp"):
                try:
                    out.append(int(name.split("_")[1]))
                except ValueError:
                    pass
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        p = os.path.join(self.dir, "latest")
        if os.path.exists(p):
            with open(p) as f:
                s = int(f.read().strip())
            if os.path.isdir(os.path.join(self.dir, f"step_{s}")):
                return s
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, like: Any, step: Optional[int] = None
                ) -> Tuple[Any, Dict[str, Any]]:
        """Restore into the structure of ``like``: each tensor leaf on
        its ``like`` leaf's device and in its type, each number as its
        Python type.  ``like`` itself is not changed."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.dir}")
        d = os.path.join(self.dir, f"step_{step}")
        with open(os.path.join(d, "manifest.json")) as f:
            meta = json.load(f)
        leaves, _ = flatten(like)
        if meta["n_leaves"] != len(leaves):
            raise ValueError(
                f"checkpoint has {meta['n_leaves']} leaves, target "
                f"structure has {len(leaves)} — incompatible trees")
        bf16 = set(meta.get("bf16_leaves", ()))
        out = [_leaf_like(np.load(os.path.join(d, f"{i:06d}.npy")), ref,
                          i in bf16) for i, ref in enumerate(leaves)]
        return unflatten(like, out), meta

    # -- verification ----------------------------------------------------------

    def verify_step(self, step: int) -> Dict[str, Any]:
        """Re-hash every leaf of a finished checkpoint against the
        checksums recorded at write time.  Raises
        :class:`CheckpointCorruptError` on any missing leaf, size or
        digest mismatch; returns the manifest on success.  Manifests
        written before checksums existed (no ``leaf_sha256``) verify
        leaf *presence* only."""
        d = os.path.join(self.dir, f"step_{step}")
        mpath = os.path.join(d, "manifest.json")
        if not os.path.exists(mpath):
            raise CheckpointCorruptError(f"step {step}: manifest missing")
        try:
            with open(mpath) as f:
                meta = json.load(f)
        except ValueError as e:
            raise CheckpointCorruptError(
                f"step {step}: manifest unreadable ({e})") from e
        n = int(meta.get("n_leaves", 0))
        shas = meta.get("leaf_sha256")
        sizes = meta.get("leaf_bytes")
        for i in range(n):
            leaf = os.path.join(d, f"{i:06d}.npy")
            if not os.path.exists(leaf):
                raise CheckpointCorruptError(
                    f"step {step}: leaf {i} missing")
            if sizes is not None and os.path.getsize(leaf) != sizes[i]:
                raise CheckpointCorruptError(
                    f"step {step}: leaf {i} size mismatch")
            if shas is not None and _sha256_file(leaf) != shas[i]:
                raise CheckpointCorruptError(
                    f"step {step}: leaf {i} checksum mismatch")
        return meta

    # -- preemption ------------------------------------------------------------

    def install_preemption_handler(self, get_state: Callable[[], Tuple[int,
                                   Any, Dict]], sig=signal.SIGTERM) -> None:
        """On SIGTERM (preemption notice), write a final checkpoint before
        the process dies — nodes are revocable at cluster scale."""

        def handler(signum, frame):
            step, tree, meta = get_state()
            meta = dict(meta, preempted=True, wall=time.time())
            self.save(step, tree, metadata=meta, blocking=True)
            raise SystemExit(143)

        signal.signal(sig, handler)
