"""Checkpointing: async save, atomic manifest, restore (port of
`repro.checkpoint.checkpoint`, with its on-disk layout).

Layout (one directory per step):

  <dir>/step_000042/
      manifest.json      {step, leaves: {path: {shape, dtype}}, n_hosts}
      <leaf-path>.npy    one file per tree leaf, the path's "/" as "__"
  <dir>/LATEST           atomic pointer (written last => crash-safe)

A leaf's path is its dict keys joined by "/" ("opt/m/layers/attn/wq/
kernel"), as the reference names a pytree leaf, so a checkpoint written
by either package restores in the other.  A bfloat16 leaf is stored as
its 16-bit pattern ("<u2"; the manifest says "bfloat16") and comes back
as bfloat16 where its `like` leaf is bfloat16.

Fault-tolerance contract (runtime/ft.py):
  * save is ASYNC: device->host copy at call time, file I/O in a
    background thread; `wait()` joins before the next save or exit, and
    raises if the write failed.
  * restore_latest() never reads a partially written step: LATEST is
    renamed into place only after the manifest's fsync.
  * leaves are saved whole, so a restore may go to any device.

`host_id`/`n_hosts` select the leaves this host writes (its share of a
multi-host save); one card is host 0 of 1 and writes them all.  Each
host writes its leaves into the step's temporary directory; the manifest
(every leaf's shape and dtype), the step directory and LATEST are
published once, by host 0: with one host by its background write, with
several in `wait()`, after a `barrier` every host calls (and a second
one, so that no host reads the step before it is published).  The
trainer over ranks gathers the cut leaves first and lets rank 0 write
them all (`launch/train.py`), so its checkpoint is the one a one-process
run writes, and restores at any world size.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.device import resolve_device


def _leaf_paths(tree, prefix: str = "") -> Dict[str, Any]:
    """{"a/b/c": leaf} over the nested dicts of `tree`."""
    if not isinstance(tree, dict):
        return {prefix: tree}
    out = {}
    for key in sorted(tree):
        out.update(_leaf_paths(tree[key], f"{prefix}/{key}" if prefix
                               else str(key)))
    return out


def _dtype_name(t) -> str:
    """The manifest's dtype of a leaf (`_to_numpy`'s name, no copy)."""
    if not isinstance(t, torch.Tensor):
        return str(np.array(t).dtype)
    if t.dtype == torch.bfloat16:
        return "bfloat16"
    return str(torch.empty((), dtype=t.dtype).numpy().dtype)


def _to_numpy(t) -> Tuple[np.ndarray, str]:
    """(a host copy of a leaf, its dtype's name).  The copy is a snapshot:
    later in-place updates of the tensor do not reach it."""
    if not isinstance(t, torch.Tensor):
        arr = np.array(t)
        return arr, str(arr.dtype)
    t = t.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    arr = t.numpy()
    return arr, str(arr.dtype)


def _to_tensor(arr: np.ndarray, like, device) -> torch.Tensor:
    if tuple(arr.shape) != tuple(like.shape):
        raise ValueError(f"checkpoint leaf {tuple(arr.shape)} does not match "
                         f"{tuple(like.shape)}")
    if like.dtype == torch.bfloat16 and arr.dtype == np.uint16:
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16) \
            .to(device)
    return torch.as_tensor(arr).to(device)


class Checkpointer:
    def __init__(self, directory: str, keep: int = 3, host_id: int = 0,
                 n_hosts: int = 1,
                 barrier: Optional[Callable[[], None]] = None):
        """`barrier`: with n_hosts > 1, a call that no host leaves before
        every host has made it (e.g. `core.mesh.mesh_barrier`)."""
        if n_hosts > 1 and barrier is None:
            raise ValueError("a save by several hosts needs a barrier")
        self.dir = directory
        self.keep = keep
        self.host_id, self.n_hosts = host_id, n_hosts
        self.barrier = barrier
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._pending: Optional[Tuple[int, Dict[str, Any]]] = None
        os.makedirs(directory, exist_ok=True)

    # -- save -----------------------------------------------------------------
    def save(self, step: int, state) -> None:
        self.wait()
        leaves = _leaf_paths(state)
        # device->host NOW (snapshot semantics); file IO async.
        host_leaves = {k: _to_numpy(v)[0] for k, v in leaves.items()
                       if self._owns(k)}
        meta = {k: {"shape": list(v.shape), "dtype": _dtype_name(v)}
                for k, v in leaves.items()}
        if self.n_hosts > 1:
            self._pending = (step, meta)
        self._thread = threading.Thread(
            target=self._write_or_keep_error, args=(step, host_leaves, meta),
            daemon=True)
        self._thread.start()

    def _write_or_keep_error(self, *args) -> None:
        try:
            self._write(*args)
        except Exception as e:   # noqa: BLE001 -- raised again by wait()
            self._error = e

    def _owns(self, key: str) -> bool:
        h = int(hashlib.md5(key.encode()).hexdigest(), 16)
        return (h % self.n_hosts) == self.host_id

    def _write(self, step: int, leaves, meta) -> None:
        tmp = os.path.join(self.dir, f"step_{step:09d}") + ".tmp"
        os.makedirs(tmp, exist_ok=True)
        for k, v in leaves.items():
            np.save(os.path.join(tmp, k.replace("/", "__") + ".npy"), v)
        if self.n_hosts == 1:
            self._publish(step, meta)

    def _publish(self, step: int, meta) -> None:
        """The manifest, the step directory and LATEST (host 0, once)."""
        d = os.path.join(self.dir, f"step_{step:09d}")
        tmp = d + ".tmp"
        manifest = {"step": step, "leaves": meta, "n_hosts": self.n_hosts}
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, d)  # atomic publish
        with open(os.path.join(self.dir, "LATEST.tmp"), "w") as f:
            f.write(str(step))
            f.flush()
            os.fsync(f.fileno())
        os.replace(os.path.join(self.dir, "LATEST.tmp"),
                   os.path.join(self.dir, "LATEST"))
        self._gc()

    def _gc(self) -> None:
        steps = sorted(p for p in os.listdir(self.dir)
                       if p.startswith("step_") and not p.endswith(".tmp"))
        for p in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.dir, p), ignore_errors=True)

    def wait(self) -> None:
        """Join the background write; raise its error if it failed.  With
        several hosts, publish the pending step: every host's leaves
        written (a barrier), host 0 publishes, and a second barrier."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError("checkpoint save failed") from err
        if self._pending is not None:
            step, meta = self._pending
            self._pending = None
            self.barrier()
            if self.host_id == 0:
                self._publish(step, meta)
            self.barrier()

    # -- restore --------------------------------------------------------------
    def latest_step(self) -> Optional[int]:
        fp = os.path.join(self.dir, "LATEST")
        if not os.path.exists(fp):
            return None
        with open(fp) as f:
            return int(f.read().strip())

    def restore(self, step: int, like, device=None):
        """The state tree saved at `step`, shaped like `like` (a tree of
        tensors, e.g. on the meta device), on `device` (None: the card)."""
        dev = resolve_device(device)
        d = os.path.join(self.dir, f"step_{step:09d}")

        def load(path: str, leaf):
            arr = np.load(os.path.join(d, path.replace("/", "__") + ".npy"))
            return _to_tensor(arr, leaf, dev)
        return _rebuild(like, load)

    def restore_latest(self, like, device=None):
        step = self.latest_step()
        if step is None:
            return None, None
        return step, self.restore(step, like, device=device)


def _rebuild(like, load, prefix: str = ""):
    """`like`'s dict structure with each leaf replaced by load(path, leaf)."""
    if not isinstance(like, dict):
        return load(prefix, like)
    return {k: _rebuild(v, load, f"{prefix}/{k}" if prefix else str(k))
            for k, v in like.items()}
