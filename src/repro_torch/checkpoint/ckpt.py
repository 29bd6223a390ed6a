"""Fault-tolerant checkpoints of a tree of tensors, the port's copy of
``repro.checkpoint.ckpt``, in its layout, so that either package restores
what the other saved.

Layout:  <dir>/step_<N:08d>/
             shard_<host>.npz     the leaves, keyed by their tree paths
             MANIFEST.json        step, time, keys, shapes, dtypes

Guarantees:
* **Atomic commit** — the files are written into ``step_<N>.tmp``, the
  manifest last, and the directory is renamed only after every array is on
  disk: a preempted writer never corrupts the latest checkpoint, and
  readers only trust renamed directories holding a manifest.
* **Async save** — :class:`AsyncCheckpointer` copies the state to host
  memory before it returns (the train step updates the state in place, so
  the next step would otherwise overwrite what the writer reads) and writes
  in a background thread.
* **Restore onto a device** — leaves are restored by path and placed on
  ``device``; missing or extra paths raise with the offending keys.
* **Elastic restore** — ``restore(..., shardings=)`` places each leaf as a
  DTensor by its sharding, on any mesh: a checkpoint holds whole leaves,
  whatever mesh saved it.
* **Saves under a mesh** — a state of DTensors is gathered leaf by leaf on
  every rank (a collective: every rank calls ``save``), and rank 0 alone
  writes the same keys and whole leaves a one-device save writes.
* **Retention** — :func:`gc` prunes old steps, never the newest.

bf16 leaves are stored as their ``uint16`` bit patterns and labelled
``"bfloat16"`` in the manifest, as the reference stores them; the port
reads and writes them through torch's own bf16 view.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.tree import leaves_with_paths, unflatten


def _to_storable(leaf) -> tuple[np.ndarray, str]:
    """A leaf (tensor, numpy array or number) as the array the file holds
    and the dtype name the manifest gives it."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        a = t.numpy()
    else:
        a = np.asarray(leaf)
    return a, str(a.dtype)


def _from_storable(a: np.ndarray, dtype_name: str) -> torch.Tensor:
    a = np.require(a, requirements=["C", "W"])  # keeps 0-d leaves 0-d
    if dtype_name == "bfloat16":
        if a.dtype != np.uint16:
            raise ValueError(f"bfloat16 leaf stored as {a.dtype}")
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    if a.dtype.name != dtype_name:
        raise ValueError(f"leaf stored as {a.dtype}, manifest says {dtype_name}")
    return torch.from_numpy(a)


def _whole(leaf):
    """A DTensor's whole value (gathered on every rank), else the leaf."""
    if hasattr(leaf, "full_tensor"):
        return leaf.full_tensor()
    return leaf


def is_writer(state) -> bool:
    """Whether this process writes ``state``'s checkpoints: always, but for
    a state of DTensors, whose rank 0 alone writes."""
    import torch.distributed as dist

    sharded = any(hasattr(leaf, "full_tensor") for _, leaf in leaves_with_paths(state))
    return not sharded or dist.get_rank() == 0


def _snapshot(state) -> dict:
    """The state's leaves copied to host memory, keyed by path, as (array,
    dtype name); DTensor leaves whole."""
    out = {}
    for key, leaf in leaves_with_paths(state):
        leaf = _whole(leaf)
        if isinstance(leaf, torch.Tensor):
            out[key] = _to_storable(leaf.detach().to("cpu", copy=True))
        else:
            out[key] = _to_storable(np.array(leaf, copy=True))
    return out


def _write(snapshot: dict, step: int, directory: str, host_id: int) -> str:
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    np.savez(os.path.join(tmp, f"shard_{host_id}.npz"),
             **{k: a for k, (a, _) in snapshot.items()})
    manifest = {
        "step": step,
        "time": time.time(),
        "keys": sorted(snapshot),
        "shapes": {k: list(a.shape) for k, (a, _) in snapshot.items()},
        "dtypes": {k: name for k, (_, name) in snapshot.items()},
    }
    with open(os.path.join(tmp, "MANIFEST.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)  # atomic commit
    return final


def save(state, step: int, directory: str, host_id: int = 0) -> str:
    """Write ``state`` (a tree of tensors, DTensors or numpy arrays) as step
    ``step`` and return the committed directory (on every rank; only the
    writer, :func:`is_writer`, writes)."""
    snapshot = _snapshot(state)
    final = os.path.join(directory, f"step_{step:08d}")
    if is_writer(state):
        final = _write(snapshot, step, directory, host_id)
    return final


class AsyncCheckpointer:
    """Snapshot synchronously, write in the background; one writer at a time."""

    def __init__(self, directory: str):
        self.directory = directory
        self._thread: threading.Thread | None = None
        self.last_path: str | None = None

    def save(self, state, step: int) -> None:
        snapshot = _snapshot(state)  # on the host before the next step runs
        self.wait()
        if not is_writer(state):
            return
        self._thread = threading.Thread(
            target=self._write, args=(snapshot, step), daemon=True)
        self._thread.start()

    def _write(self, snapshot, step):
        self.last_path = _write(snapshot, step, self.directory, 0)

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None


def _committed_steps(directory: str) -> list[int]:
    if not os.path.isdir(directory):
        return []
    return sorted(
        int(n.split("_")[1]) for n in os.listdir(directory)
        if n.startswith("step_") and not n.endswith(".tmp")
        and os.path.exists(os.path.join(directory, n, "MANIFEST.json")))


def latest_step(directory: str) -> int | None:
    steps = _committed_steps(directory)
    return steps[-1] if steps else None


def restore(directory: str, abstract_state, step: int | None = None,
            device="cuda", shardings=None):
    """Load a checkpoint into the tree of ``abstract_state`` (tensors whose
    shapes and dtypes are wanted, ``meta`` ones will do) on ``device``.
    ``shardings``: an optional tree of
    :class:`~repro_torch.distributed.sharding.NamedSharding` matching
    ``abstract_state``, on a ``DeviceMesh`` of ``device``'s type — the
    elastic-resharding hook: each leaf becomes a DTensor holding this rank's
    shard, whatever mesh the checkpoint came from. Returns (state, step)."""
    dev = resolve_device(device)
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no committed checkpoints in {directory}")
    path = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(path, "MANIFEST.json")) as f:
        manifest = json.load(f)
    arrays: dict[str, np.ndarray] = {}
    for name in sorted(os.listdir(path)):
        if name.startswith("shard_") and name.endswith(".npz"):
            with np.load(os.path.join(path, name)) as z:
                for k in z.files:
                    arrays[k] = z[k]
    want = {k for k, _ in leaves_with_paths(abstract_state)}
    have = set(arrays)
    if want != have:
        raise ValueError(f"checkpoint/tree mismatch: missing={sorted(want - have)[:5]} "
                         f"extra={sorted(have - want)[:5]}")

    def build(key, leaf):
        t = _from_storable(arrays[key], manifest["dtypes"][key])
        if tuple(t.shape) != tuple(leaf.shape):
            raise ValueError(f"checkpoint/tree mismatch: {key} has shape "
                             f"{tuple(t.shape)}, the tree {tuple(leaf.shape)}")
        t = t.to(device=dev, dtype=leaf.dtype)
        return flat_sh[key].place(t) if key in flat_sh else t

    flat_sh = dict(leaves_with_paths(shardings)) if shardings is not None else {}
    return unflatten(abstract_state, [build(k, leaf) for k, leaf in
                                      leaves_with_paths(abstract_state)]), manifest["step"]


def gc(directory: str, keep: int = 3) -> list[str]:
    """Remove every committed step but the newest ``keep``; return the paths
    removed."""
    steps = _committed_steps(directory)
    removed = []
    for s in steps[:-keep] if keep else steps:
        p = os.path.join(directory, f"step_{s:08d}")
        shutil.rmtree(p)
        removed.append(p)
    return removed
