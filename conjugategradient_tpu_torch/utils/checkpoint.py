"""Checkpoint / resume for long solves, and persistence of the port's trees.

CG state is small (3 vectors and 3 scalars), so a checkpoint is a host
download and an ``.npz`` of plain numpy arrays: the file the JAX package's
``utils/checkpoint.py`` writes, so a state saved by either package resumes
in the other.  ``solvers.cg.cg_solve_chunked`` writes one per chunk and
resumes from it, in a new process too.

``save_pytree`` / ``load_pytree`` persist the port's own trees (an
``MgHierarchy`` from ``build_hierarchy``, any ``core.formats`` container):
multigrid setup takes seconds to minutes on the host, and a saved hierarchy
turns a later process's setup into a file read.
"""

from __future__ import annotations

import dataclasses
import io
import os
import pickle
from typing import Optional

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class CGState:
    """The full CG recurrence state; resuming from it continues the *same*
    Krylov sequence (no restart penalty)."""

    x: np.ndarray
    r: np.ndarray
    p: np.ndarray
    rz: float
    rr: float
    rr0: float
    iteration: int

    @property
    def n(self) -> int:
        return int(self.x.shape[0])


def save_state(path: str, state: CGState) -> None:
    _atomic_savez(
        path,
        compressed=False,
        x=np.asarray(state.x),
        r=np.asarray(state.r),
        p=np.asarray(state.p),
        scalars=np.asarray([state.rz, state.rr, state.rr0], dtype=np.float64),
        iteration=np.asarray(state.iteration, dtype=np.int64),
    )


def load_state(path: str) -> CGState:
    with np.load(path) as z:
        rz, rr, rr0 = (float(v) for v in z["scalars"])
        return CGState(
            x=z["x"], r=z["r"], p=z["p"], rz=rz, rr=rr, rr0=rr0, iteration=int(z["iteration"])
        )


def maybe_resume(path: Optional[str]) -> Optional[CGState]:
    if path and os.path.exists(path):
        return load_state(path)
    return None


def _atomic_savez(path: str, compressed: bool, **payload) -> None:
    """savez to a tmp name (numpy appends .npz), then an atomic rename: a
    reader never sees a half-written file."""
    tmp = path + ".tmp"
    (np.savez_compressed if compressed else np.savez)(tmp, **payload)
    os.replace(tmp + ".npz", path)


class _Leaves(pickle.Pickler):
    """Pickles a tree with every tensor and numpy array taken out as a
    numbered leaf (``persistent_id``): the structure goes to the pickle,
    the arrays to the ``.npz``.  A tensor's dtype is recorded beside it,
    and bf16 is stored as its int16 bits (numpy has no bf16)."""

    def __init__(self, file):
        super().__init__(file, protocol=pickle.HIGHEST_PROTOCOL)
        self.leaves = []

    def persistent_id(self, obj):
        if torch.is_tensor(obj):
            t = obj.detach().cpu().contiguous()
            arr = t.view(torch.int16).numpy() if t.dtype == torch.bfloat16 else t.numpy()
            self.leaves.append(arr)
            return ("tensor", len(self.leaves) - 1, str(t.dtype).split(".")[-1])
        if isinstance(obj, np.ndarray):
            self.leaves.append(obj)
            return ("ndarray", len(self.leaves) - 1, None)
        return None


class _Unleaves(pickle.Unpickler):
    def __init__(self, file, leaves, device):
        super().__init__(file)
        self._leaves = leaves
        self._device = device

    def persistent_load(self, pid):
        kind, i, dtype = pid
        arr = self._leaves[i]
        if kind == "ndarray":
            return arr
        t = torch.from_numpy(arr)
        if dtype == "bfloat16":
            t = t.view(torch.bfloat16)
        return t.to(self._device)


def save_pytree(path: str, tree) -> None:
    """Persist ``tree`` (an ``MgHierarchy``, a ``core.formats`` container,
    or any picklable structure of them) atomically to ``path``: its tensors
    and numpy arrays as a compressed ``.npz`` payload, the structure
    (types, grids, offsets, smoother settings) as a pickle inside the same
    file.  Load with ``load_pytree``, from TRUSTED files only (the
    structure channel is pickle)."""
    buf = io.BytesIO()
    pickler = _Leaves(buf)
    pickler.dump(tree)
    payload = {f"leaf_{i}": a for i, a in enumerate(pickler.leaves)}
    payload["__treedef__"] = np.frombuffer(buf.getvalue(), dtype=np.uint8)
    _atomic_savez(path, compressed=True, **payload)


def load_pytree(path: str, device=None):
    """Load a tree saved by ``save_pytree``: its tensors on ``device``
    (``None``: the card when there is one, as ``core.formats.
    default_device``), its numpy arrays as numpy.  Only open files you
    trust (see ``save_pytree``)."""
    from conjugategradient_tpu_torch.core.formats import default_device

    with np.load(path, allow_pickle=False) as z:
        structure = z["__treedef__"].tobytes()
        leaves = [z[f"leaf_{i}"] for i in range(len(z.files) - 1)]
    return _Unleaves(io.BytesIO(structure), leaves, default_device(device)).load()
