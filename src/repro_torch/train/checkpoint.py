"""Checkpointing with atomic commit, CRC validation and async snapshots.

The reference's layout and guarantees (``repro.train.checkpoint``)::

    <dir>/step_000000123/
        manifest.json      # step, leaf count, shapes, dtypes, CRCs
        arr_00000.npy ...  # one file per leaf
    <dir>/LATEST           # atomically-renamed pointer file

* **atomic commit** — data is written into ``step_x.tmp`` and renamed only
  after every file and the manifest landed; a crash mid-write never
  corrupts the latest valid checkpoint;
* **CRC validation** — every leaf carries a crc32; :func:`latest_step`
  falls back to the previous valid checkpoint on a mismatch (torn-write
  protection) and :func:`restore` of a bad one raises;
* **keep-N GC** — old checkpoints are pruned after commit;
* **async mode** — :meth:`AsyncCheckpointer.save_async` copies every leaf
  to the host (blocking only for that copy) and writes on a thread, so
  training overlaps the I/O.

A tree is a tensor, an ``nn.Module`` (its parameters in
``named_parameters`` order), or a list, tuple (``NamedTuple`` included)
or dict (keys sorted, as JAX flattens them) of trees; the trainer saves
``(model, AdamWState)``.  numpy has no bfloat16, so a bfloat16 leaf is
stored as its ``uint16`` view with ``"bfloat16"`` in the manifest, and
restored bit for bit.  :func:`restore` writes into the tensors of the tree
it is given, in place, on their devices.
"""

from __future__ import annotations

import json
import shutil
import threading
import zlib
from pathlib import Path
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

_BF16 = "bfloat16"


def leaves(tree: Any) -> List[torch.Tensor]:
    """The tree's leaves in checkpoint order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, torch.nn.Module):
        return [p for _, p in tree.named_parameters()]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for item in tree for x in leaves(item)]
    raise TypeError(f"not a checkpoint tree leaf: {type(tree)}")


def _host(leaf) -> Tuple[np.ndarray, str]:
    """A leaf as the host array that is stored (a copy), and its dtype's
    name."""
    t = leaf.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), _BF16
    arr = t.numpy()
    return arr, str(arr.dtype)


def _crc(arr: np.ndarray) -> int:
    return zlib.crc32(arr.tobytes())


def _write(ckpt_dir: str, step: int, arrays: List[Tuple[np.ndarray, str]],
           keep: int) -> Path:
    base = Path(ckpt_dir)
    base.mkdir(parents=True, exist_ok=True)
    final = base / f"step_{step:09d}"
    tmp = base / f"step_{step:09d}.tmp"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    entries = []
    for i, (arr, dtype) in enumerate(arrays):
        fname = f"arr_{i:05d}.npy"
        np.save(tmp / fname, arr, allow_pickle=False)
        entries.append({"file": fname, "shape": list(arr.shape),
                        "dtype": dtype, "crc": _crc(arr)})
    manifest = {"step": step, "n_leaves": len(arrays), "leaves": entries}
    (tmp / "manifest.json").write_text(json.dumps(manifest))
    if final.exists():
        shutil.rmtree(final)
    tmp.rename(final)                      # atomic commit
    latest_tmp = base / "LATEST.tmp"
    latest_tmp.write_text(final.name)
    latest_tmp.rename(base / "LATEST")
    _gc(base, keep)
    return final


def save(ckpt_dir: str, step: int, tree: Any, *, keep: int = 3) -> Path:
    """Synchronous checkpoint save with atomic commit."""
    return _write(ckpt_dir, step, [_host(x) for x in leaves(tree)], keep)


def _gc(base: Path, keep: int) -> None:
    ckpts = sorted(p for p in base.glob("step_*") if p.is_dir()
                   and not p.name.endswith(".tmp"))
    for old in ckpts[:-keep]:
        shutil.rmtree(old, ignore_errors=True)


def _validate(ckpt: Path) -> bool:
    """Every leaf present, readable and matching its CRC."""
    try:
        manifest = json.loads((ckpt / "manifest.json").read_text())
        for e in manifest["leaves"]:
            arr = np.load(ckpt / e["file"], allow_pickle=False)
            if _crc(arr) != e["crc"]:
                return False
        return True
    except (OSError, ValueError, KeyError):
        return False


def latest_step(ckpt_dir: str) -> Optional[int]:
    """The newest valid checkpoint's step: LATEST's first, then the step
    directories newest first; None when none is valid."""
    base = Path(ckpt_dir)
    pointer = base / "LATEST"
    candidates = []
    if pointer.exists():
        candidates.append(base / pointer.read_text().strip())
    candidates += sorted((p for p in base.glob("step_*") if p.is_dir()
                          and not p.name.endswith(".tmp")), reverse=True)
    for c in candidates:
        if c.exists() and _validate(c):
            return int(c.name.split("_")[1])
    return None


@torch.no_grad()
def restore(ckpt_dir: str, tree_like: Any,
            step: Optional[int] = None) -> Tuple[Any, int]:
    """Restore into ``tree_like``'s leaves, in place; returns (tree_like,
    step).  ``step`` None takes :func:`latest_step`; a checkpoint that
    fails its CRC check raises ``IOError``, one that does not fit the
    tree (leaf count, shape or dtype) ``ValueError``."""
    base = Path(ckpt_dir)
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no valid checkpoint under {ckpt_dir}")
    ckpt = base / f"step_{step:09d}"
    if not _validate(ckpt):
        raise IOError(f"checkpoint {ckpt} failed CRC validation")
    manifest = json.loads((ckpt / "manifest.json").read_text())
    targets = leaves(tree_like)
    if len(targets) != manifest["n_leaves"]:
        raise ValueError(f"checkpoint {ckpt} holds {manifest['n_leaves']} "
                         f"leaves, the tree {len(targets)}")
    for e, target in zip(manifest["leaves"], targets):
        arr = np.load(ckpt / e["file"], allow_pickle=False)
        if tuple(arr.shape) != tuple(target.shape):
            raise ValueError(f"{e['file']}: shape {arr.shape} does not fit "
                             f"{tuple(target.shape)}")
        if e["dtype"] == _BF16:
            t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
        else:
            t = torch.from_numpy(arr)
        if t.dtype != target.dtype:
            raise ValueError(f"{e['file']}: dtype {e['dtype']} does not fit "
                             f"{target.dtype}")
        target.copy_(t)
    return tree_like, step


class AsyncCheckpointer:
    """Overlaps checkpoint I/O with training (one in flight at a time)."""

    def __init__(self, ckpt_dir: str, keep: int = 3):
        self.ckpt_dir = ckpt_dir
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[Exception] = None
        self.last_path: Optional[Path] = None

    def save_async(self, step: int, tree: Any) -> None:
        """Snapshot every leaf to the host now (a copy, so later in-place
        updates do not reach it), then write on a thread."""
        self.wait()
        arrays = [_host(x) for x in leaves(tree)]

        def work():
            try:
                self.last_path = _write(self.ckpt_dir, step, arrays,
                                        self.keep)
            except Exception as exc:         # re-raised by wait()
                self._error = exc

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        """Join the write in flight; raise what it raised."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err
