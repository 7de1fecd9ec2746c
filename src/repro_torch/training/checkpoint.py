"""Checkpointing: atomic, async-capable, step-journaled, restart-exact.

Counterpart of :mod:`repro.training.checkpoint`, in the same layout, so a
checkpoint written by either package restores in the other:
``<dir>/step_<n>/arrays.npz`` + ``meta.json``, plus ``<dir>/JOURNAL`` with
the last durably committed step (written by tmpfile + rename, so a crash
never leaves a torn journal). The arrays are the flat ``{path: ndarray}``
mapping of :func:`repro_torch.models.convert.flat_from_tree`. A save copies
the tree to the host before it returns (or backgrounds the write, with
``async_save``); a restore gives tensors on the manager's device.
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile
import threading
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.models.convert import flat_from_tree, tree_from_flat

Pytree = Any


def _atomic_write(path: str, data: bytes):
    d = os.path.dirname(path)
    os.makedirs(d, exist_ok=True)
    with tempfile.NamedTemporaryFile(dir=d, delete=False) as f:
        f.write(data)
        tmp = f.name
    os.replace(tmp, path)


class CheckpointManager:
    """``device``: where :meth:`restore` puts the tensors (``cuda`` unless
    the caller asks for the CPU)."""

    def __init__(self, directory: str, *, keep: int = 3,
                 async_save: bool = False,
                 device: "str | torch.device" = "cuda"):
        self.dir = directory
        self.keep = keep
        self.async_save = async_save
        self.device = device
        self._thread: Optional[threading.Thread] = None
        os.makedirs(directory, exist_ok=True)

    # --------------------------------------------------------------- save
    def save(self, step: int, state: Pytree, extra: Optional[dict] = None):
        """Durable save; returns when committed (or backgrounded if async)."""
        flat = flat_from_tree(state)

        def work():
            sdir = os.path.join(self.dir, f"step_{step:08d}")
            tmpdir = sdir + ".tmp"
            if os.path.exists(tmpdir):
                shutil.rmtree(tmpdir)
            os.makedirs(tmpdir, exist_ok=True)
            np.savez(os.path.join(tmpdir, "arrays.npz"), **flat)
            meta = {"step": step, "extra": extra or {},
                    "paths": sorted(flat)}
            with open(os.path.join(tmpdir, "meta.json"), "w") as f:
                json.dump(meta, f)
            if os.path.exists(sdir):
                shutil.rmtree(sdir)
            os.replace(tmpdir, sdir)
            # journal commit LAST -> restart never sees a torn checkpoint
            _atomic_write(os.path.join(self.dir, "JOURNAL"),
                          json.dumps({"last_step": step}).encode())
            self._gc()

        if self.async_save:
            self.wait()
            self._thread = threading.Thread(target=work, daemon=True)
            self._thread.start()
        else:
            work()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self):
        steps = self.all_steps()
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:08d}"),
                          ignore_errors=True)

    # ------------------------------------------------------------ restore
    def all_steps(self) -> list[int]:
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and not name.endswith(".tmp"):
                out.append(int(name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        j = os.path.join(self.dir, "JOURNAL")
        if not os.path.exists(j):
            return None
        with open(j) as f:
            step = json.load(f)["last_step"]
        return step if step in self.all_steps() else (
            self.all_steps()[-1] if self.all_steps() else None)

    def restore(self, step: Optional[int] = None) -> tuple[int, Pytree, dict]:
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.dir}")
        sdir = os.path.join(self.dir, f"step_{step:08d}")
        with np.load(os.path.join(sdir, "arrays.npz")) as z:
            flat = {k: z[k] for k in z.files}
        with open(os.path.join(sdir, "meta.json")) as f:
            meta = json.load(f)
        return step, tree_from_flat(flat, self.device), meta.get("extra", {})
