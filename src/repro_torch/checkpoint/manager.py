"""Atomic, async checkpoints in the reference's on-disk layout: the port
of ``repro.checkpoint.manager``.

``<dir>/step_N.tmp/<flat-key>.npy`` for every leaf plus a
``manifest.json`` (step, extra, each key's shape and dtype name), then
the ``step_N.tmp -> step_N`` rename commits the step, so a partial write
is never taken for a checkpoint.  A flat key is the leaf's path as the
reference writes it (``i:0|k:layers|i:3|k:mix|k:wq``,
``core/tree.path_key``).  bfloat16 and float8_e5m2 leaves are stored
as their integer containers (``uint16`` / ``uint8``) with the true dtype
name in the manifest, as the reference stores them, so either package
reads the other's checkpoints.  Saves copy to the host at once and write
on a thread (``wait()`` joins it); the last ``keep`` steps are kept.

Sharded trees (``launch/sharding.py``: each leaf this rank's block, with
a tree of ``NamedSharding``): ``save(..., shardings=)`` gathers every
leaf on the calling thread, every rank taking part (the writer thread
issues no collective), and only rank 0 writes, in the same layout; with
a process group the next ``wait()`` ends with a barrier of all ranks, so
no rank restores a step before its manifest exists.  ``restore(..., shardings=)`` reads the
full arrays and keeps this rank's block of each for the *current* mesh:
a step saved on one mesh restores onto another (elastic re-sharding).
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.core.collectives import gather_block, local_block
from repro_torch.core.tree import flatten_with_path, path_key, unflatten
from repro_torch.models.convert import _NARROW

# the manifest's names of the other dtypes a param or AdamW tree holds
_PLAIN = {"float32": torch.float32, "float16": torch.float16,
          "int32": torch.int32}
_NAMES = {dt: name for name, (_, dt) in _NARROW.items()}
_NAMES.update({dt: name for name, dt in _PLAIN.items()})


def _flatten(tree) -> Dict[str, Any]:
    return {path_key(p): leaf for p, leaf in flatten_with_path(tree)}


def to_host(t: torch.Tensor):
    """A leaf as ``(numpy array to store, dtype name)``: narrow floats as
    their unsigned integer containers."""
    t = t.detach().to("cpu", copy=True)   # the caller may update it next
    name = _NAMES[t.dtype]
    if name in _NARROW:
        view, _ = _NARROW[name]
        signed = torch.int16 if view == np.uint16 else torch.int8
        return t.view(signed).numpy().view(view), name
    return t.numpy(), name


def from_host(arr: np.ndarray, name: str, device) -> torch.Tensor:
    """The inverse of :func:`to_host` (``arr`` as ``np.load`` gives it:
    contiguous and writable, shared, not copied), onto ``device``."""
    if name in _NARROW:
        view, dt = _NARROW[name]
        signed = np.int16 if view == np.uint16 else np.int8
        t = torch.from_numpy(arr.view(signed)).view(dt)
    else:
        t = torch.from_numpy(arr).to(_PLAIN[name])
    return t.to(device)


def _group_running() -> bool:
    import torch.distributed as dist
    return dist.is_available() and dist.is_initialized()


def _rank() -> int:
    import torch.distributed as dist
    return dist.get_rank()


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._barrier = False       # a sharded save's wait() ends with one
        os.makedirs(directory, exist_ok=True)

    def save(self, step: int, tree, extra: Optional[Dict] = None,
             shardings=None):
        """Copy every leaf to the host now; write on a thread.  With
        ``shardings`` (a tree of ``NamedSharding`` in ``tree``'s
        structure) every rank calls this: the leaves are gathered here,
        one at a time, and rank 0 writes them."""
        self.wait()
        flat = _flatten(tree)
        flat_sh = list(_flatten(shardings).values()) \
            if shardings is not None else [None] * len(flat)
        group = shardings is not None and _group_running()
        writer = not group or _rank() == 0
        host = {}
        for (k, v), s in zip(flat.items(), flat_sh):
            full = v if s is None else gather_block(v, s.spec, s.mesh)
            if writer:
                host[k] = to_host(full)
            del full
        self._barrier = group
        if not writer:
            return
        meta = {
            "step": step,
            "extra": extra or {},
            "keys": {k: {"shape": list(a.shape), "dtype": name}
                     for k, (a, name) in host.items()},
        }
        self._thread = threading.Thread(
            target=self._write_catching, args=(step, host, meta),
            daemon=True)
        self._thread.start()

    def _write_catching(self, step, host, meta):
        try:
            self._write(step, host, meta)
        except BaseException as e:  # noqa: BLE001 -- raised by wait()
            self._error = e

    def _write(self, step: int, host, meta: Dict):
        tmp = os.path.join(self.dir, f"step_{step}.tmp")
        final = os.path.join(self.dir, f"step_{step}")
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        for k, (a, _) in host.items():
            np.save(os.path.join(tmp, k.replace("/", "_") + ".npy"), a)
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(meta, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)  # the commit
        self._gc()

    def wait(self):
        """Join the pending write (and, after a sharded save, meet every
        rank at a barrier); raise what the write raised."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._barrier:
            import torch.distributed as dist
            self._barrier = False
            dist.barrier()
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _gc(self):
        steps = self.all_steps()
        for s in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.dir, f"step_{s}"),
                          ignore_errors=True)

    def all_steps(self):
        out = []
        for d in os.listdir(self.dir):
            if d.startswith("step_") and not d.endswith(".tmp") \
                    and os.path.exists(os.path.join(self.dir, d,
                                                    "manifest.json")):
                out.append(int(d.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def manifest(self, step: int) -> Dict:
        """Step ``step``'s manifest (step, extra, keys)."""
        with open(os.path.join(self.dir, f"step_{step}",
                               "manifest.json")) as f:
            return json.load(f)

    def restore(self, step: int, tree_like, device=None, shardings=None):
        """The tree of ``tree_like``'s structure from step ``step``, each
        leaf on ``device`` (default: the device of ``tree_like``'s
        leaf), in the dtype the manifest names.  With ``shardings`` (a
        tree of ``NamedSharding`` for the current mesh) each leaf is this
        rank's block.  Returns ``(tree, manifest)``."""
        path = os.path.join(self.dir, f"step_{step}")
        meta = self.manifest(step)
        flat = _flatten(tree_like)
        flat_sh = list(_flatten(shardings).values()) \
            if shardings is not None else [None] * len(flat)
        out = []
        for (k, like), s in zip(flat.items(), flat_sh):
            arr = np.load(os.path.join(path, k.replace("/", "_") + ".npy"))
            dev = device if device is not None else like.device
            name = meta["keys"][k]["dtype"]
            if s is None:
                out.append(from_host(arr, name, dev))
            else:   # narrowed on the host: the full array stays there
                out.append(local_block(from_host(arr, name, "cpu"), s.spec,
                                       s.mesh).to(dev))
        return unflatten(tree_like, out), meta
