"""Checkpointing of the port's training state: atomic, resumable, optionally
async.  Counterpart of src/repro/train/checkpoint.py, with its layout:

    <dir>/step_000000123/
        manifest.json        # step, and each leaf's shape and dtype
        arrays.npz           # the leaves, by name
    <dir>/LATEST             # pointer file naming the newest step

The training state is ``(params, AdamWState(step, mu, nu))``: its leaves are
named ``params/<dotted name>``, ``opt/step``, ``opt/mu/<name>`` and
``opt/nu/<name>``.  Other states (dicts, lists, tuples, named tuples of
tensors and numbers) flatten to their `/`-joined keys, as the reference's
trees do.

A step is written into a directory of its own and renamed into place, so a
crash mid-save never leaves a torn checkpoint.  `save_async` copies every
leaf to the host on the caller's thread (so the in-place optimizer may go on
at once) and writes on a background thread.  Unlike the reference's, writers
do not race: each writes its own temporary step directory and pointer file,
the rename into place and the pointer update run under one lock (a thread
lock and an flock on ``<dir>/.lock``), and `LATEST` never moves to a smaller
step than the one it names, so a slow writer of an older step cannot move it
back.  `gc_old` never removes the step `LATEST` names.  `wait_pending`
re-raises a writer's error.  numpy has no bfloat16: a bf16 leaf raises
`TypeError` naming it (the trainer's masters and moments are float32).
A DTensor leaf (FSDP+TP training) is this rank's own shard: each rank
writes its shards into its own directory and restores them into the same
placements.
"""
from __future__ import annotations

import contextlib
import json
import os
import re
import shutil
import tempfile
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.distributed.tensor import DTensor

from .optimizer import AdamWState

State = Any

_STEP_DIR = re.compile(r"^step_(\d{9})$")
_lock = threading.Lock()
_pending: List[threading.Thread] = []
_errors: List[BaseException] = []
#: wall seconds of the last save's parts ("to_host_s", "write_s"), the last
#: wait ("wait_s") and restore ("restore_s"), and the last save's "bytes"
timings: Dict[str, float] = {}


# ---------------------------------------------------------------------- #
# the state as named leaves
# ---------------------------------------------------------------------- #

def _is_train_state(tree: Any) -> bool:
    return (isinstance(tree, tuple) and len(tree) == 2
            and isinstance(tree[0], nn.Module)
            and isinstance(tree[1], AdamWState))


def _children(tree: Any) -> List[Tuple[str, Any]]:
    """(key, child) of a container node, or [] for a leaf."""
    if _is_train_state(tree):
        return [("params", tree[0]), ("opt", tree[1])]
    if isinstance(tree, nn.Module):
        return list(tree.named_parameters())
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return list(zip(tree._fields, tree))
    if isinstance(tree, dict):
        return [(str(k), v) for k, v in tree.items()]
    if isinstance(tree, (list, tuple)):
        return [(str(i), v) for i, v in enumerate(tree)]
    return []


def flatten(tree: State, prefix: str = "") -> List[Tuple[str, Any]]:
    """[(name, leaf)] in a fixed order; leaves are tensors, arrays or
    numbers."""
    kids = _children(tree)
    if not kids and not _is_leaf(tree):
        return []
    if not kids:
        return [(prefix, _local(tree))]
    out = []
    for key, child in kids:
        out += flatten(child, f"{prefix}/{key}" if prefix else key)
    return out


def _local(x: Any) -> Any:
    """A DTensor's own shard (a view of it), any other leaf itself."""
    if isinstance(x, DTensor):
        with torch.no_grad():
            return x.to_local()
    return x


def _is_leaf(x: Any) -> bool:
    return isinstance(x, (torch.Tensor, np.ndarray, int, float, np.number))


def _to_numpy(name: str, leaf: Any) -> np.ndarray:
    """A host copy of one leaf (never a view of a tensor the trainer may
    update in place)."""
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype == torch.bfloat16:
            raise TypeError(f"checkpoint leaf {name!r} is bfloat16, which "
                            f"numpy cannot hold: checkpoint the float32 "
                            f"masters")
        return leaf.detach().to("cpu", copy=True).numpy()
    return np.array(leaf)


def to_host(tree: State) -> Dict[str, np.ndarray]:
    """Every leaf of `tree` copied to host memory, by name."""
    return {name: _to_numpy(name, leaf) for name, leaf in flatten(tree)}


# ---------------------------------------------------------------------- #
# writing
# ---------------------------------------------------------------------- #

@contextlib.contextmanager
def _locked(ckpt_dir: str):
    """One writer at a time: a thread lock within this process, an flock
    across processes."""
    with _lock:
        try:
            import fcntl
        except ImportError:     # pragma: no cover — non-POSIX: threads only
            yield
            return
        with open(os.path.join(ckpt_dir, ".lock"), "a+") as fh:
            fcntl.flock(fh, fcntl.LOCK_EX)
            try:
                yield
            finally:
                fcntl.flock(fh, fcntl.LOCK_UN)


def _step_name(step: int) -> str:
    return f"step_{step:09d}"


def write(ckpt_dir: str, step: int, host: Dict[str, np.ndarray]) -> str:
    """Write host arrays as checkpoint `step` and point LATEST at it unless
    LATEST names a later step; returns the checkpoint's path."""
    t0 = time.perf_counter()
    os.makedirs(ckpt_dir, exist_ok=True)
    name = _step_name(step)
    final = os.path.join(ckpt_dir, name)
    tmp = tempfile.mkdtemp(prefix=name + ".tmp-", dir=ckpt_dir)
    try:
        manifest = {
            "step": step,
            "leaves": {k: {"shape": list(v.shape), "dtype": str(v.dtype)}
                       for k, v in host.items()},
        }
        np.savez(os.path.join(tmp, "arrays.npz"), **host)
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f, indent=1)
        with _locked(ckpt_dir):
            if os.path.exists(final):       # the same step saved again
                old = tempfile.mkdtemp(prefix=name + ".old-", dir=ckpt_dir)
                os.replace(final, os.path.join(old, name))
                shutil.rmtree(old, ignore_errors=True)
            os.replace(tmp, final)
            latest = latest_step(ckpt_dir)
            if latest is None or step >= latest:
                fd, ptr = tempfile.mkstemp(prefix=".LATEST.", dir=ckpt_dir)
                with os.fdopen(fd, "w") as f:
                    f.write(name)
                os.replace(ptr, os.path.join(ckpt_dir, "LATEST"))
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    timings["write_s"] = time.perf_counter() - t0
    return final


def save(ckpt_dir: str, step: int, tree: State) -> str:
    """Synchronous atomic save; returns the checkpoint path."""
    return write(ckpt_dir, step, _host_copy(tree))


def _host_copy(tree: State) -> Dict[str, np.ndarray]:
    t0 = time.perf_counter()
    host = to_host(tree)
    timings["to_host_s"] = time.perf_counter() - t0
    timings["bytes"] = sum(v.nbytes for v in host.values())
    return host


def save_async(ckpt_dir: str, step: int, tree: State) -> threading.Thread:
    """Copy to host on this thread, write on a background thread."""
    host = _host_copy(tree)

    def run() -> None:
        try:
            write(ckpt_dir, step, host)
        except Exception as e:  # noqa: BLE001 — re-raised by wait_pending
            _errors.append(e)

    t = threading.Thread(target=run, daemon=True)
    t.start()
    _pending.append(t)
    return t


def wait_pending() -> None:
    """Join every background writer; re-raise the first writer error."""
    t0 = time.perf_counter()
    while _pending:
        _pending.pop().join()
    timings["wait_s"] = time.perf_counter() - t0
    if _errors:
        err = _errors[0]
        _errors.clear()
        raise err


# ---------------------------------------------------------------------- #
# reading
# ---------------------------------------------------------------------- #

def latest_step(ckpt_dir: str) -> Optional[int]:
    ptr = os.path.join(ckpt_dir, "LATEST")
    try:
        with open(ptr) as f:
            name = f.read().strip()
    except OSError:
        return None
    if not _STEP_DIR.match(name) or \
            not os.path.isdir(os.path.join(ckpt_dir, name)):
        return None
    return int(name.split("_")[1])


def _numpy_dtype(leaf: Any) -> np.dtype:
    if isinstance(leaf, torch.Tensor):
        return torch.empty((), dtype=leaf.dtype).numpy().dtype
    return np.asarray(leaf).dtype


def _rebuild(tree: Any, values: Dict[str, Any], prefix: str = "") -> Any:
    """`tree` with its leaves replaced by values[name]: tensors are copied
    into in place (on their device), numbers replaced."""
    if _is_train_state(tree):
        return (_rebuild(tree[0], values, _join(prefix, "params")),
                _rebuild(tree[1], values, _join(prefix, "opt")))
    if isinstance(tree, nn.Module):
        for n, p in tree.named_parameters():
            _copy_into(p, values[_join(prefix, n)])
        return tree
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_rebuild(v, values, _join(prefix, k))
                            for k, v in zip(tree._fields, tree)))
    if isinstance(tree, dict):
        return {k: _rebuild(v, values, _join(prefix, str(k)))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, values, _join(prefix, str(i)))
                          for i, v in enumerate(tree))
    if isinstance(tree, torch.Tensor):
        _copy_into(tree, values[prefix])
        return tree
    if _is_leaf(tree):
        value = values[prefix]
        if isinstance(tree, np.ndarray):
            return np.array(value)
        return type(tree)(value.item() if isinstance(value, torch.Tensor)
                          else value)
    return tree


def _copy_into(dst: torch.Tensor, src: Any) -> None:
    dst = _local(dst)
    if src is not dst:          # a leaf restore() has already copied
        with torch.no_grad():
            dst.copy_(src)


def _join(prefix: str, key: str) -> str:
    return f"{prefix}/{key}" if prefix else key


def restore(ckpt_dir: str, template: State,
            step: Optional[int] = None) -> Tuple[State, int]:
    """Restore checkpoint `step` (default: LATEST) into the structure of
    `template`: each leaf's shape and dtype are checked against the
    template's, tensors are copied into the template's own tensors on their
    device, numbers are replaced.  Returns (state, step)."""
    t0 = time.perf_counter()
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    path = os.path.join(ckpt_dir, _step_name(step))
    values: Dict[str, Any] = {}
    with np.load(os.path.join(path, "arrays.npz")) as arrays:
        for key, leaf in flatten(template):
            if key not in arrays:
                raise KeyError(f"checkpoint missing leaf {key}")
            arr = arrays[key]
            want = tuple(getattr(leaf, "shape", ()))
            if tuple(arr.shape) != want:
                raise ValueError(
                    f"leaf {key}: checkpoint shape {arr.shape} != {want}")
            if arr.dtype != _numpy_dtype(leaf):
                raise ValueError(f"leaf {key}: checkpoint dtype {arr.dtype} "
                                 f"!= {_numpy_dtype(leaf)}")
            values[key] = torch.from_numpy(arr) \
                if isinstance(leaf, torch.Tensor) else arr
            if isinstance(leaf, torch.Tensor):  # one leaf in host memory
                _rebuild(leaf, values, key)     # at a time
                values[key] = leaf
    state = _rebuild(template, values)
    timings["restore_s"] = time.perf_counter() - t0
    return state, step


def all_steps(ckpt_dir: str) -> List[int]:
    if not os.path.isdir(ckpt_dir):
        return []
    return sorted(int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
                  if _STEP_DIR.match(d))


def gc_old(ckpt_dir: str, keep: int = 3) -> None:
    """Remove all but the `keep` newest steps, never the one LATEST
    names."""
    if not os.path.isdir(ckpt_dir):
        return
    with _locked(ckpt_dir):
        latest = latest_step(ckpt_dir)
        for s in all_steps(ckpt_dir)[:-keep]:
            if s != latest:
                shutil.rmtree(os.path.join(ckpt_dir, _step_name(s)),
                              ignore_errors=True)
