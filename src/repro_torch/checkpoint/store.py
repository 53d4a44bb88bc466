"""Atomic pytree checkpoint store (port of ``repro.checkpoint.store``).

Same on-disk layout as the JAX package — one ``arrays.npz`` keyed by
``/``-joined path keys, the manifest embedded in it and beside it, and a
sha256 content digest — so a checkpoint written by either package
restores in the other. Leaves are saved from host copies of the tensors;
``restore`` hands tensors back on the requested device.

Concurrency contract (exercised by the FaaS runtime, where several worker
*processes* write and restore snapshots concurrently):

* **Writers never collide**: each ``save`` stages into a private
  ``step_XXX.tmp-<pid>-<nonce>`` directory and installs it with an atomic
  ``os.rename`` — two processes saving the same tag can interleave freely
  and the final directory is always one writer's complete output, never a
  torn mix.
* **Readers never see partial state**: ``restore`` only ever opens the
  installed directory; a reader racing a replace (rename-aside + rename-in)
  can momentarily observe the tag missing and retries briefly.
* ``latest_step`` ignores staging/aside directories, so a crash mid-save
  (SIGKILL'd worker) leaves at worst dead ``.tmp`` litter, never a
  half-visible checkpoint.
"""

from __future__ import annotations

import hashlib
import json
import os
import re
import shutil
import time
import uuid
from typing import Any, Optional

import ml_dtypes
import numpy as np

from repro_torch import tree as tree_lib
from repro_torch.wire.codec import to_numpy, to_tensor

PyTree = Any

_SEP = "/"
_STEP_RE = re.compile(r"^step_(\d{10})$")


class CheckpointCorruption(Exception):
    """A checkpoint's stored arrays do not match their manifest digest."""


# fault-injection seam (runtime/faults.py, DESIGN.md §17): called with the
# staging directory after the npz is written but BEFORE the atomic
# install.  Raising OSError here simulates ENOSPC at the worst moment —
# the staged bytes exist but must never become visible.  None = dormant.
_write_fault_hook = None


def install_write_fault_hook(fn) -> None:
    global _write_fault_hook
    _write_fault_hook = fn


def clear_write_fault_hook() -> None:
    global _write_fault_hook
    _write_fault_hook = None


def _content_digest(stored: dict[str, np.ndarray]) -> str:
    """sha256 over the stored (npz-encoded) arrays in sorted key order —
    the integrity witness verified on every restore."""
    h = hashlib.sha256()
    for k in sorted(stored):
        h.update(k.encode("utf-8"))
        v = stored[k]
        h.update(str(v.dtype).encode())
        h.update(str(v.shape).encode())
        h.update(np.ascontiguousarray(v).tobytes())
    return h.hexdigest()


def _flatten_with_paths(tree: PyTree) -> dict[str, np.ndarray]:
    return {
        tree_lib.path_key(path): to_numpy(leaf)
        for path, leaf in tree_lib.flatten_with_path(tree)
    }


def _install(tmp: str, final: str) -> None:
    """Atomically make ``tmp`` the contents of ``final``.

    POSIX cannot rename over a non-empty directory, so replacing an
    existing checkpoint moves the old one aside first; a concurrent reader
    retries the brief not-found window, and a concurrent writer that loses
    the race simply installs over us the same way.
    """
    last: Optional[OSError] = None
    for _ in range(100):
        try:
            os.rename(tmp, final)
            return
        except OSError as e:
            last = e
        if os.path.isdir(final):
            aside = final + f".old-{uuid.uuid4().hex[:8]}"
            try:
                os.rename(final, aside)
            except OSError:
                continue  # another writer swapped in between; retry install
            shutil.rmtree(aside, ignore_errors=True)
        # else: a concurrent writer moved final aside between our failed
        # rename and now — the next rename attempt can win the slot
    raise OSError(f"could not install checkpoint at {final}") from last


def save(directory: str, step: int, tree: PyTree, extra: Optional[dict] = None) -> str:
    """Atomically write ``tree`` as checkpoint ``step``. Returns the path.

    Safe under concurrent writers of the same ``(directory, step)`` tag and
    under readers restoring while a writer replaces the tag.
    """
    final = os.path.join(directory, f"step_{step:010d}")
    tmp = final + f".tmp-{os.getpid()}-{uuid.uuid4().hex[:8]}"
    os.makedirs(tmp, exist_ok=True)
    try:
        flat = _flatten_with_paths(tree)
        # npz cannot hold bfloat16: store the raw bits as uint16; the true
        # dtype is in the manifest and restored on load
        stored = {
            k: (v.view(np.uint16) if v.dtype.name == "bfloat16" else v)
            for k, v in flat.items()
        }
        manifest = {
            "step": step,
            "keys": sorted(flat),
            "shapes": {k: list(v.shape) for k, v in flat.items()},
            "dtypes": {k: str(v.dtype) for k, v in flat.items()},
            "digest": _content_digest(stored),
            "extra": extra or {},
        }
        # the manifest rides INSIDE the npz too: restore then needs a single
        # file open, so a concurrent replace can never hand it one version's
        # manifest with another version's arrays
        stored["__manifest__"] = np.frombuffer(
            json.dumps(manifest).encode("utf-8"), dtype=np.uint8
        )
        np.savez(os.path.join(tmp, "arrays.npz"), **stored)
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f, indent=1)
            f.flush()
            os.fsync(f.fileno())
        if _write_fault_hook is not None:
            _write_fault_hook(tmp)
        _install(tmp, final)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    return final


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = []
    for d in os.listdir(directory):
        m = _STEP_RE.match(d)
        if m:  # staging (.tmp-*) and aside (.old-*) dirs never match
            steps.append(int(m.group(1)))
    return max(steps) if steps else None


def _restore_once(path: str, like: PyTree, device) -> PyTree:
    arrays = np.load(os.path.join(path, "arrays.npz"))
    if "__manifest__" in arrays:  # single-open read: immune to replaces
        manifest = json.loads(arrays["__manifest__"].tobytes().decode("utf-8"))
    else:  # pre-embedding checkpoints
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
    dtypes = manifest.get("dtypes", {})
    if "digest" in manifest:  # pre-digest checkpoints skip verification
        got = _content_digest(
            {k: arrays[k] for k in manifest["keys"] if k in arrays}
        )
        if got != manifest["digest"] or any(
            k not in arrays for k in manifest["keys"]
        ):
            raise CheckpointCorruption(
                f"checkpoint {path}: content digest mismatch "
                f"(manifest {manifest['digest'][:12]}…, stored {got[:12]}…)"
            )
    out = []
    for p, leaf in tree_lib.flatten_with_path(like):
        key = tree_lib.path_key(p)
        if key not in arrays:
            raise KeyError(f"checkpoint {path} missing {key}")
        arr = arrays[key]
        if dtypes.get(key) == "bfloat16":  # stored as uint16 bits
            arr = arr.view(ml_dtypes.bfloat16)
        want = tuple(leaf.shape)
        if tuple(arr.shape) != want:
            raise ValueError(f"{key}: checkpoint {arr.shape} != expected {want}")
        out.append(to_tensor(arr, device))
    return tree_lib.unflatten(like, out)


def restore(directory: str, step: int, like: PyTree,
            device: Any = "cpu") -> PyTree:
    """Restore into the structure of ``like`` (shapes validated), as
    tensors on ``device``.

    Retries the brief not-found window a concurrent replace opens (the old
    directory moves aside before the new one moves in).
    """
    path = os.path.join(directory, f"step_{step:010d}")
    last: Optional[Exception] = None
    for _ in range(40):
        try:
            return _restore_once(path, like, device)
        except FileNotFoundError as e:
            last = e
            time.sleep(0.025)
    raise FileNotFoundError(f"checkpoint {path} never became readable") from last


def all_steps(directory: str) -> list[int]:
    """Every installed checkpoint generation, ascending."""
    if not os.path.isdir(directory):
        return []
    steps = []
    for d in os.listdir(directory):
        m = _STEP_RE.match(d)
        if m:
            steps.append(int(m.group(1)))
    return sorted(steps)


def restore_latest_valid(
    directory: str, like: PyTree, device: Any = "cpu"
) -> tuple[Optional[int], Optional[PyTree]]:
    """Restore the newest checkpoint whose content digest verifies,
    falling back generation by generation past corrupt ones (every
    generation is retained precisely so this walk has somewhere to go).
    Returns ``(step, tree)`` — ``(None, None)`` when no valid generation
    exists (cold start)."""
    for step in reversed(all_steps(directory)):
        path = os.path.join(directory, f"step_{step:010d}")
        try:
            return step, _restore_once(path, like, device)
        except FileNotFoundError:
            # racing a concurrent replace of this tag: the standard
            # retry window, then fall through to the previous generation
            try:
                return step, restore(directory, step, like, device)
            except (FileNotFoundError, CheckpointCorruption,
                    KeyError, ValueError):
                continue
        except (CheckpointCorruption, KeyError, ValueError) as e:
            print(f"checkpoint {path}: unusable ({e}); "
                  f"falling back to previous generation", flush=True)
            continue
    return None, None


def manifest_extra(directory: str, step: int) -> dict:
    path = os.path.join(directory, f"step_{step:010d}", "manifest.json")
    with open(path) as f:
        return json.load(f).get("extra", {})
