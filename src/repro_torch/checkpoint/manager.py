"""Checkpoints: an npz shard and a manifest per step, atomic step commit,
async save, GC.

Port of `repro.checkpoint.manager` with the reference's on-disk layout:

  <dir>/step_000000123/
      manifest.json          keys, shapes, dtypes, n_hosts, step
      host_0.npz             the state's leaves by path ("params::layers::0::...")
  <dir>/LATEST               committed step pointer (written last => atomic)

The async save copies every tensor to host numpy on the caller's thread
(the reference's `device_get` in `_flatten`) before the writer thread
starts, so training may update the tensors in place while it writes. A
DTensor leaf is gathered whole first (a collective: every rank of the
process group calls `save`); with more than one rank, rank 0 alone copies
the gathered values to the host and writes them, synchronously, and every
rank waits for it. `restore` writes the saved
values into the target state's own tensors in place, on their device: the
port's state holds the model's live parameters, which the model keeps
using. Given `shardings` (a `repro_torch.sharding.NamedSharding` tree),
it instead returns new DTensors placed on the target mesh, whatever mesh
saved them: the elastic path. bfloat16 leaves are stored as their uint16
bit patterns and named "bfloat16" in the manifest.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.tree import walk

SEP = "::"


def _to_numpy(t: torch.Tensor, keep: bool = True
              ) -> Optional[Tuple[np.ndarray, str]]:
    """The leaf's whole value on the host. A DTensor is gathered first (a
    collective every rank joins); with `keep` false the gathered value is
    dropped there and None returned: ranks that do not write copy nothing
    to the host."""
    t = t.detach()
    if hasattr(t, "full_tensor"):          # a DTensor: its whole value
        t = t.full_tensor()
    if not keep:
        return None
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).cpu().numpy().view(np.uint16).copy(), \
            "bfloat16"
    arr = t.cpu().numpy().copy()
    return arr, str(arr.dtype)


def _flatten(tree: Any, keep: bool = True
             ) -> Tuple[Dict[str, np.ndarray], Dict[str, str]]:
    """Every leaf on the host by path; with `keep` false, the leaves are
    only gathered (the collectives of a rank that does not write)."""
    flat, dtypes = {}, {}
    for path, leaf in walk(tree):
        got = _to_numpy(leaf, keep)
        if got is not None:
            key = SEP.join(path)
            flat[key], dtypes[key] = got
    return flat, dtypes


def _world() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------------ save

    def save(self, step: int, state: Any, blocking: bool = True) -> None:
        if self._thread is not None:
            self._thread.join()  # one in-flight save at a time
            self._thread = None
        if _world() > 1:                  # rank 0 writes; all wait for it
            writer = dist.get_rank() == 0
            flat, dtypes = _flatten(state, keep=writer)
            if writer:
                self._write(step, flat, dtypes)
            dist.barrier()
            return
        flat, dtypes = _flatten(state)    # the host copy is the caller's
        if blocking:
            self._write(step, flat, dtypes)
        else:
            t = threading.Thread(target=self._write,
                                 args=(step, flat, dtypes), daemon=True)
            t.start()
            self._thread = t

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _write(self, step: int, flat: Dict[str, np.ndarray],
               dtypes: Dict[str, str]) -> None:
        d = os.path.join(self.dir, f"step_{step:09d}")
        tmp = d + ".tmp"
        os.makedirs(tmp, exist_ok=True)
        np.savez(os.path.join(tmp, "host_0.npz"), **flat)
        manifest = {
            "step": step,
            "keys": sorted(flat.keys()),
            "shapes": {k: list(v.shape) for k, v in flat.items()},
            "dtypes": dtypes,
            "n_hosts": 1,
        }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.isdir(d):
            shutil.rmtree(d)
        os.rename(tmp, d)
        with open(os.path.join(self.dir, "LATEST.tmp"), "w") as f:
            f.write(str(step))
        os.replace(os.path.join(self.dir, "LATEST.tmp"),
                   os.path.join(self.dir, "LATEST"))
        self._gc()

    def _gc(self) -> None:
        for s in self.all_steps()[: -self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:09d}"),
                          ignore_errors=True)

    # --------------------------------------------------------------- restore

    def latest_step(self) -> Optional[int]:
        p = os.path.join(self.dir, "LATEST")
        if not os.path.exists(p):
            return None
        with open(p) as f:
            return int(f.read().strip())

    def all_steps(self):
        out = []
        for n in os.listdir(self.dir):
            if n.startswith("step_") and not n.endswith(".tmp"):
                out.append(int(n.split("_")[1]))
        return sorted(out)

    @torch.no_grad()
    def restore(self, step: int, target_state: Any,
                shardings: Any = None) -> Any:
        """Write step `step` into the tensors of `target_state` (same tree
        structure), in place on their devices; returns `target_state`.
        With `shardings` (a NamedSharding tree of the same structure),
        return a new tree of DTensors placed with it instead: the saved
        mesh need not equal the target mesh."""
        d = os.path.join(self.dir, f"step_{step:09d}")
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        with np.load(os.path.join(d, "host_0.npz")) as z:
            data = {n: z[n] for n in z.files}
        srcs = {}
        for path, leaf in walk(target_state):
            key = SEP.join(path)
            arr = data[key]
            if manifest["dtypes"][key] == "bfloat16":
                src = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
            else:
                src = torch.from_numpy(arr)
            if tuple(src.shape) != tuple(leaf.shape):
                raise ValueError(f"checkpoint {key}: shape {tuple(src.shape)}"
                                 f", target {tuple(leaf.shape)}")
            if shardings is None:
                if hasattr(leaf, "device_mesh"):      # a DTensor: its shard
                    from torch.distributed.tensor import distribute_tensor

                    src = distribute_tensor(src, leaf.device_mesh,
                                            leaf.placements,
                                            src_data_rank=None)
                leaf.copy_(src.to(leaf.device))
            else:
                srcs[path] = src
        if shardings is None:
            return target_state
        from repro_torch.sharding import distribute
        from repro_torch.sharding.rules import map_with_path

        return distribute(map_with_path(lambda path, _: srcs[path],
                                         target_state), shardings)
