"""Fault-tolerant checkpointing: npz + JSON manifest.

* atomic (write to a tmp dir, then rename) — a crash mid-save never
  corrupts the latest checkpoint;
* async (one background save in flight) — training never blocks on IO;
* place-on-load — leaves are saved whole on the host and restored onto a
  target ``device``, or each onto its own through a placement tree;
* keeps the last ``keep`` checkpoints, deletes older ones.

The on-disk format is the reference's: ``arrays.npz`` with ``/``-joined
tree keys and ``manifest.json`` with ``"format": 1``, so a float or int
checkpoint loads in either package.  numpy has no bfloat16, so a bf16
leaf is saved as its 16-bit patterns (uint16) and its key listed in the
manifest's ``"bf16_keys"``; a reference checkpoint's bf16 leaf (saved
through ``ml_dtypes``, read back by plain numpy as raw ``|V2`` bytes) is
read as bf16 bits too.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time

import numpy as np
import torch


def _flatten(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}/"))
    else:
        out[prefix[:-1]] = tree
    return out


def _unflatten(flat: dict):
    root: dict = {}
    for key, v in flat.items():
        parts = key.split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v

    def fix(node):
        if not isinstance(node, dict):
            return node
        keys = list(node.keys())
        if keys and all(k.isdigit() for k in keys):
            return [fix(node[str(i)]) for i in range(len(keys))]
        return {k: fix(v) for k, v in node.items()}

    return fix(root)


def _to_host(x) -> tuple[np.ndarray, bool]:
    """A leaf as a numpy array the caller may not mutate (a copy), and
    whether it holds bf16 bits."""
    if isinstance(x, torch.Tensor):
        x = x.detach().to("cpu", copy=True)
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16), True
        return x.numpy(), False
    return np.array(x), False


def _from_host(a: np.ndarray, bf16: bool, device) -> torch.Tensor:
    if bf16 or (a.dtype.kind == "V" and a.dtype.itemsize == 2):
        bits = np.asarray(a, order="C").view(np.int16)
        return torch.from_numpy(bits).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.asarray(a, order="C")).to(device)


class Checkpointer:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: threading.Thread | None = None

    # ----------------------------------------------------------------- save
    def save(self, step: int, state: dict, blocking: bool = True):
        """state: arbitrary tree of tensors (params/opt/extra)."""
        host, bf16_keys = {}, []
        for k, v in _flatten(state).items():
            host[k], bf16 = _to_host(v)
            if bf16:
                bf16_keys.append(k)
        if self._thread is not None:
            self._thread.join()  # one in-flight save at a time
        if blocking:
            self._write(step, host, bf16_keys)
        else:
            self._thread = threading.Thread(
                target=self._write, args=(step, host, bf16_keys), daemon=True
            )
            self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _write(self, step: int, host: dict, bf16_keys: list):
        tmp = os.path.join(self.dir, f".tmp-{step}-{os.getpid()}")
        os.makedirs(tmp, exist_ok=True)
        np.savez(os.path.join(tmp, "arrays.npz"), **host)
        manifest = {
            "step": int(step),
            "time": time.time(),
            "keys": sorted(host.keys()),
            "format": 1,
            "bf16_keys": sorted(bf16_keys),
        }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        final = os.path.join(self.dir, f"step-{step:010d}")
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        self._gc()

    def _gc(self):
        steps = self.list_steps()
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step-{s:010d}"))

    # -------------------------------------------------------------- restore
    def list_steps(self):
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step-"):
                out.append(int(name.split("-")[1]))
        return sorted(out)

    def latest_step(self):
        steps = self.list_steps()
        return steps[-1] if steps else None

    def restore(self, step: int | None = None, device="cuda",
                placement=None):
        """Returns (step, state) with tensor leaves on ``device``, or, with
        ``placement`` (a tree of devices matching the saved state), each
        leaf on its own device."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.dir}")
        path = os.path.join(self.dir, f"step-{step:010d}")
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        bf16_keys = set(manifest.get("bf16_keys", ()))
        devices = (_flatten(placement) if placement is not None
                   else dict.fromkeys(manifest["keys"], device))
        with np.load(os.path.join(path, "arrays.npz")) as data:
            flat = {k: _from_host(data[k], k in bf16_keys, devices[k])
                    for k in manifest["keys"]}
        return manifest["step"], _unflatten(flat)
