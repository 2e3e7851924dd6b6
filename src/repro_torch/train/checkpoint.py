"""Fault-tolerant checkpointing: atomic, versioned, asynchronous, cast on
restore (``repro/train/checkpoint.py``, in a format of the port's own).

Layout: ``<dir>/step_<N>/<leaf path>.npy`` plus ``manifest.json``, the
leaves keyed by their dotted tree paths ("params.stack.body.0.mixer...").
Writes go to ``step_<N>.tmp`` and are renamed into place only after every
leaf and the manifest are written and fsync'd, so a preempted writer never
leaves a checkpoint that restore would pick up (it scans completed
directories only).  The ``keep`` newest checkpoints are retained.

``save_async`` snapshots to host memory at once (the device-to-host copy)
and writes on a background thread.  ``restore`` takes a target tree and
loads each leaf onto the target leaf's device and dtype: a checkpoint
written in float32 restores into bfloat16, or from the card onto the CPU.

Elastic restore: a checkpoint holds whole leaves, whatever the world size
that wrote it, so a run at any other world size reads it back bit for bit.
Inside a ``torch.distributed`` group (the data-parallel ranks hold
replicated trees) only rank 0 writes, and every rank waits at a barrier
until the write is committed: after ``save``, and for ``save_async`` in the
next ``wait`` (which ``save``, ``save_async`` and ``close`` call), so every
rank must make the same calls.  Every rank reads.

Sharded trees (parameters cut over a mesh, ``dist/sharding.py``): given
``specs`` (the whole tree's specs) and ``mesh``, ``save`` and
``save_async`` first gather every cut leaf whole (a collective on every
rank), and ``restore`` cuts each whole leaf it reads to this rank's block
of the current mesh, so a checkpoint of ``--mesh 2,2`` resumes under
``1,1`` or ``1,2``.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import threading
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.nn.module import tree_map, tree_unflatten

_LEAF_SEP = "."


def _flatten(tree, prefix: str = "") -> Dict[str, Any]:
    """{dotted path: leaf} in tree order."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    out: Dict[str, Any] = {}
    for k, v in items:
        out.update(_flatten(v, f"{prefix}{_LEAF_SEP}{k}" if prefix else str(k)))
    return out


def _to_host(leaf) -> np.ndarray:
    """A leaf as a numpy array of its own (bfloat16, which numpy lacks, as
    float32): a copy, so a later in-place update of the tensor does not
    reach a snapshot that is still being written."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.dtype == torch.bfloat16:
            t = t.to(torch.float32)
        return np.array(t.cpu().numpy())
    return np.array(leaf)


def _whole(tree, specs, mesh):
    if specs is None:
        return tree
    from repro_torch.dist.sharding import gather_tree

    return gather_tree(tree, specs, mesh)


def _leaves(tree) -> list:
    return list(_flatten(tree).values())


class CheckpointManager:
    """Versioned checkpoints of a tree of tensors under ``directory``."""

    def __init__(self, directory: str, *, keep: int = 3):
        self.directory = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._pool = ThreadPoolExecutor(max_workers=1)
        self._lock = threading.Lock()
        self._pending: Optional[Future] = None
        self._grouped = dist.is_available() and dist.is_initialized()
        self._writer = not self._grouped or dist.get_rank() == 0
        self._unsynced = False   # a save_async whose barrier is still to come

    # ---- write -------------------------------------------------------------
    def save(self, step: int, tree, specs=None, mesh=None) -> str:
        """Write ``tree`` as checkpoint ``step`` now; returns its directory.
        ``specs``/``mesh``: the tree is sharded; it is gathered first."""
        # drain an in-flight asynchronous write first: two writers on one
        # step's tmp directory would race
        self.wait()
        tree = _whole(tree, specs, mesh)
        final = self._final(step)
        if self._writer:
            final = self._write(step, tree_map(_to_host, tree))
        if self._grouped:
            dist.barrier()
        return final

    def save_async(self, step: int, tree, specs=None, mesh=None) -> Future:
        """Snapshot ``tree`` to the host now (gathered first, given
        ``specs``/``mesh``) and write it on a thread."""
        self.wait()
        tree = _whole(tree, specs, mesh)
        self._unsynced = self._grouped
        if not self._writer:
            done: Future = Future()
            done.set_result(self._final(step))
            return done
        host = tree_map(_to_host, tree)
        self._pending = self._pool.submit(self._write, step, host)
        return self._pending

    def wait(self) -> None:
        """Wait for the asynchronous write, if any (re-raising its error);
        in a group, every rank then waits for rank 0's write."""
        try:
            if self._pending is not None:
                pending, self._pending = self._pending, None
                pending.result()
        finally:
            if self._unsynced:
                self._unsynced = False
                dist.barrier()

    def _final(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step:09d}")

    def close(self) -> None:
        """Finish the pending write and stop the writer thread."""
        try:
            self.wait()
        finally:
            self._pool.shutdown()

    def _write(self, step: int, host_tree) -> str:
        final = self._final(step)
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        manifest = {"step": step, "leaves": {}}
        for key, arr in _flatten(host_tree).items():
            fname = re.sub(r"[^A-Za-z0-9_.-]", "_", key) + ".npy"
            with open(os.path.join(tmp, fname), "wb") as f:
                np.save(f, arr)
                f.flush()
                os.fsync(f.fileno())
            manifest["leaves"][key] = {"file": fname, "shape": list(arr.shape),
                                       "dtype": str(arr.dtype)}
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        with self._lock:
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)   # the atomic commit
            self._gc()
        return final

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:09d}"), ignore_errors=True)

    # ---- read --------------------------------------------------------------
    def all_steps(self) -> List[int]:
        """Steps of the completed checkpoints, oldest first."""
        out = []
        for name in os.listdir(self.directory):
            m = re.fullmatch(r"step_(\d+)", name)
            if m and os.path.exists(os.path.join(self.directory, name, "manifest.json")):
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: int, target, specs=None, mesh=None):
        """Checkpoint ``step`` in the structure of ``target``, each leaf on
        the target leaf's device (the CPU for a ``meta`` tensor, which
        stands for a shape and dtype only) and in its dtype; given
        ``specs``/``mesh``, each whole leaf cut to this rank's block."""
        if specs is not None:
            from repro_torch.dist.sharding import leaves_with_specs, local_slice

            cut = [s for _, s in leaves_with_specs(target, specs)]
            whole = self.restore(step, target)
            return tree_unflatten(target, [local_slice(t, s, mesh).contiguous() if s else t
                                           for t, s in zip(_leaves(whole), cut)])
        d = os.path.join(self.directory, f"step_{step:09d}")
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        leaves = []
        for key, tgt in _flatten(target).items():
            meta = manifest["leaves"].get(key)
            if meta is None:
                raise KeyError(f"checkpoint {step} has no leaf {key!r}")
            t = torch.from_numpy(np.load(os.path.join(d, meta["file"])))
            if isinstance(tgt, torch.Tensor):
                dev = "cpu" if tgt.device.type == "meta" else tgt.device
                t = t.to(device=dev, dtype=tgt.dtype)
            leaves.append(t)
        return tree_unflatten(target, leaves)

    def restore_latest(self, target):
        """(step, tree) of the newest checkpoint, or (None, None)."""
        step = self.latest_step()
        if step is None:
            return None, None
        return step, self.restore(step, target)
