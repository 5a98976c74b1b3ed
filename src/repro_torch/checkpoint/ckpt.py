"""Async, atomic checkpointing (port of `repro/checkpoint/ckpt.py`), in the
JAX package's on-disk format, so that either package restores the
other's checkpoints:

    <dir>/step_<N>.tmp/            (written)
        shard_0.npz                leaf_<i> for the i-th leaf
        manifest.json              names, shapes, dtypes, extra
    <dir>/step_<N>/                (atomic rename on completion)

Leaves are numbered in `jax.tree_util`'s order and named by the "/"-join
of the dict keys and list indices that lead to them (`repro_torch.tree`).
A bfloat16 leaf is stored as a uint8 view [..., 2] with "bfloat16" in the
manifest and decoded straight into `torch.bfloat16` (no `ml_dtypes`).

  * atomic commit: a crash mid-write leaves only a .tmp dir, never a
    half-valid checkpoint; `latest_step` ignores .tmp;
  * async: `Checkpointer.save_async` copies device tensors to the host
    (blocking only for the copy) and writes on a background thread, so the
    train loop may overwrite its params in place meanwhile;
  * bounded retention: keep_last prunes old steps.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import tree as tree_lib

_BF16 = "bfloat16"


def _host(leaf) -> Tuple[np.ndarray, str]:
    """A host copy of one leaf as numpy (a bf16 tensor as its uint8 bytes
    [..., 2]); the manifest's dtype name beside it."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True).contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint8) \
                .reshape(tuple(t.shape) + (2,)), _BF16
        return t.numpy(), str(t.dtype).replace("torch.", "")
    a = np.array(leaf)
    if a.dtype.name == _BF16:    # numpy's bfloat16 extension type
        return a.view(np.uint8).reshape(a.shape + (2,)), _BF16
    return a, str(a.dtype)


def _snapshot(tree: Any):
    names, leaves = tree_lib.flatten_with_paths(tree)
    return names, [_host(leaf) for leaf in leaves]


def save(path: str, step: int, tree: Any, *, extra: Optional[Dict] = None,
         keep_last: int = 3) -> str:
    """Synchronous atomic save. Returns the committed directory."""
    return _write(path, step, *_snapshot(tree), extra, keep_last)


def _write(path: str, step: int, names: List[str], host: List, extra,
           keep_last: int) -> str:
    tmp = os.path.join(path, f"step_{step}.tmp")
    final = os.path.join(path, f"step_{step}")
    os.makedirs(tmp, exist_ok=True)
    np.savez(os.path.join(tmp, "shard_0.npz"),
             **{f"leaf_{i}": a for i, (a, _) in enumerate(host)})
    manifest = {
        "step": step,
        "names": names,
        "shapes": [list(a.shape[:-1] if dt == _BF16 else a.shape)
                   for a, dt in host],
        "dtypes": [dt for _, dt in host],
        "extra": extra or {},
    }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)                     # atomic commit
    _prune(path, keep_last)
    return final


def _prune(path: str, keep_last: int) -> None:
    steps = sorted(latest_steps(path))
    for s in steps[:-keep_last]:
        shutil.rmtree(os.path.join(path, f"step_{s}"), ignore_errors=True)


def latest_steps(path: str) -> List[int]:
    if not os.path.isdir(path):
        return []
    out = []
    for d in os.listdir(path):
        if d.startswith("step_") and not d.endswith(".tmp") and \
                os.path.exists(os.path.join(path, d, "manifest.json")):
            out.append(int(d.split("_")[1]))
    return out


def latest_step(path: str) -> Optional[int]:
    steps = latest_steps(path)
    return max(steps) if steps else None


def _decode(a: np.ndarray, dtype: str, shape) -> torch.Tensor:
    if dtype == _BF16:
        return torch.from_numpy(np.ascontiguousarray(a).reshape(-1)
                                .view(np.int16).copy()) \
            .view(torch.bfloat16).reshape(shape)
    return torch.from_numpy(np.asarray(a, dtype=np.dtype(dtype))
                            .reshape(shape).copy())


def restore(path: str, step: int, like: Any, *, shardings: Any = None,
            mesh: Any = None) -> Any:
    """The checkpoint of `step` as a tree of `like`'s structure, whose
    leaf names must match the stored ones. Each leaf is a tensor of the
    stored dtype, on the device of `like`'s leaf when that is a tensor
    and on the CPU otherwise (e.g. a `like` of the JAX package's layout
    with numpy leaves, for `convert.from_jax`).

    With `shardings` (a spec tree of `like`'s structure from
    `launch/shardings.py`, or one `shardings.P` for every leaf) and the
    restoring job's DeviceMesh `mesh`, each leaf becomes a DTensor laid
    out by its spec on the mesh's devices: the elastic re-shard point.
    The stored arrays are whole, so each rank takes its shard of its own
    copy, whatever mesh wrote the checkpoint."""
    final = os.path.join(path, f"step_{step}")
    with open(os.path.join(final, "manifest.json")) as f:
        manifest = json.load(f)
    names, like_leaves = tree_lib.flatten_with_paths(like)
    if names != manifest["names"]:
        raise ValueError("checkpoint/model structure mismatch: "
                         f"{len(manifest['names'])} stored leaves, "
                         f"{len(names)} asked for")
    if shardings is not None and mesh is None:
        raise ValueError("restore with shardings needs the mesh")
    leaves = []
    with np.load(os.path.join(final, "shard_0.npz")) as data:
        for i, ref in enumerate(like_leaves):
            t = _decode(data[f"leaf_{i}"], manifest["dtypes"][i],
                        manifest["shapes"][i])
            if isinstance(ref, torch.Tensor) and shardings is None:
                t = t.to(ref.device)
            leaves.append(t)
    out = tree_lib.unflatten(like, leaves)
    if shardings is None:
        return out
    from repro_torch.launch import shardings as sh
    if isinstance(shardings, sh.P):
        shardings = tree_lib.unflatten(like, [shardings] * len(leaves))
    return sh.distribute(out, mesh, shardings, src_data_rank=None)


def restore_extra(path: str, step: int) -> Dict:
    with open(os.path.join(path, f"step_{step}", "manifest.json")) as f:
        return json.load(f)["extra"]


class Checkpointer:
    """Async wrapper: snapshot to host, write on a daemon thread."""

    def __init__(self, path: str, keep_last: int = 3):
        self.path = path
        self.keep_last = keep_last
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[Exception] = None
        os.makedirs(path, exist_ok=True)

    def save_async(self, step: int, tree: Any,
                   extra: Optional[Dict] = None) -> None:
        self.wait()
        names, host = _snapshot(tree)            # host copies (blocking)

        def _run():
            try:
                _write(self.path, step, names, host, extra, self.keep_last)
            except Exception as e:  # re-raised by wait()
                self._error = e
        self._thread = threading.Thread(target=_run, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        """Waits for the pending write; raises the error it met, if any."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err
