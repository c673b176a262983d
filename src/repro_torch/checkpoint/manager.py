"""Checkpoints of the port with async writes, atomic publish and retention:
the reference's ``repro/checkpoint/manager.py``.

Format (the reference's): ``step_%09d/host0.npz`` holding every leaf by
its key, plus ``meta.json`` with the step and a dtype sidecar; bf16 is
stored as a ``uint16`` view (npz has no bf16). A write goes to
``step_%09d.tmp`` and is published by an atomic rename; ``keep_n`` steps
are kept. ``save`` takes host copies of every leaf before its writer thread
starts, so later in-place steps cannot change what is written.

Keys are the port's own: containers' keys, NamedTuple field names and
sequence indices joined by ``|``, and a module's tensors by their dotted
names (``params|layers.0.attn.q.w``, ``opt|mu|layers.0.attn.q.w``,
``opt|count``). :meth:`CheckpointManager.restore_like` writes a module's
tensors in place and makes every other leaf anew.

Sharded state (DTensors, ``launch.train``'s sharded step) keeps the
single-host format: ``save`` gathers each DTensor whole on every rank (a
collective: every rank calls it) before the writer thread starts, and rank
0 writes. ``restore_like(..., shardings=...)`` is the reference's elastic
restore: each leaf is laid out with its placements on the current mesh,
which may differ from the one that saved it. Every rank reads the step
after a barrier, so that none reads a step that rank 0 has not published.
"""

from __future__ import annotations

import json
import re
import shutil
import threading
import zipfile
import zlib
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Any, Optional

import numpy as np
import torch

__all__ = ["CheckpointManager", "flatten", "from_host", "host_copies", "read_members",
           "restore_into", "to_host"]

_SEP = "|"
_READERS = 4  # threads reading a checkpoint's members at once


def _module_tensors(mod: torch.nn.Module) -> dict:
    named = dict(mod.named_parameters())
    named.update(mod.named_buffers())
    return named


def _items(tree: Any):
    """(key, child) pairs of a container, in a fixed order."""
    if isinstance(tree, torch.nn.Module):
        return list(_module_tensors(tree).items())
    if isinstance(tree, dict):
        return list(tree.items())
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return list(zip(tree._fields, tree))
    if isinstance(tree, (list, tuple)):
        return list(enumerate(tree))
    return None


def flatten(tree: Any, prefix: str = "") -> dict:
    """Leaves by key (None leaves dropped). A module's tensors are leaves
    under their dotted names."""
    if tree is None:
        return {}
    items = _items(tree)
    if items is None:
        return {prefix: tree}
    flat = {}
    for k, v in items:
        key = f"{prefix}{_SEP}{k}" if prefix else str(k)
        if isinstance(tree, torch.nn.Module):
            flat[key] = v
        else:
            flat.update(flatten(v, key))
    return flat


def _rank() -> int:
    import torch.distributed as dist

    return dist.get_rank() if dist.is_initialized() else 0


def _barrier() -> None:
    import torch.distributed as dist

    if dist.is_initialized() and dist.get_world_size() > 1:
        dist.barrier()


def to_host(v) -> tuple:
    """(C-contiguous numpy copy on the host, dtype sidecar or None) of a
    leaf, a DTensor gathered whole first. A CUDA tensor is copied into
    page-locked memory (a pageable copy runs at a small fraction of the
    link's rate)."""
    from torch.distributed.tensor import DTensor

    if isinstance(v, DTensor):
        v = v.full_tensor()
    if isinstance(v, torch.Tensor):
        if v.is_cuda:
            t = torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
            t.copy_(v.detach())
        else:
            t = v.detach().cpu().clone(memory_format=torch.contiguous_format)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        return t.numpy(), None
    return np.array(v, order="C"), None


def read_members(path: Path, keys: list) -> dict:
    """``{key: array}`` of an npz that ``np.savez`` wrote from C-contiguous
    arrays: each member's bytes read straight into its array, then its
    CRC-32 (over the ``.npy`` header and the data, as the zip records it)
    checked, the check ``np.load`` makes. A member stored any other way
    (compressed, Fortran order, object dtype, another ``.npy`` version)
    raises ``zipfile.BadZipFile``."""
    fmt = np.lib.format
    headers = {(1, 0): fmt.read_array_header_1_0, (2, 0): fmt.read_array_header_2_0}
    out = {}
    with zipfile.ZipFile(path) as z, open(path, "rb") as f:
        for k in keys:
            info = z.getinfo(k + ".npy")
            if info.compress_type != zipfile.ZIP_STORED:
                raise zipfile.BadZipFile(f"{path}: member {k} is compressed")
            f.seek(info.header_offset)
            local = f.read(30)  # the local file header, then its name and extra field
            start = (info.header_offset + 30 + int.from_bytes(local[26:28], "little")
                     + int.from_bytes(local[28:30], "little"))
            f.seek(start)
            version = fmt.read_magic(f)
            if version not in headers:
                raise zipfile.BadZipFile(f"{path}: member {k} is .npy version {version}")
            shape, fortran, dtype = headers[version](f)
            if fortran or dtype.hasobject:
                raise zipfile.BadZipFile(f"{path}: member {k} is Fortran-ordered or of objects")
            head = f.tell() - start
            f.seek(start)
            crc = zlib.crc32(f.read(head))
            a = np.empty(shape, dtype)
            view = memoryview(a.reshape(-1).view(np.uint8))
            got = 0
            while got < len(view):
                n = f.readinto(view[got:])
                if not n:
                    raise zipfile.BadZipFile(f"{path}: member {k} is short")
                got += n
            if zlib.crc32(view, crc) != info.CRC:
                raise zipfile.BadZipFile(f"{path}: bad CRC-32 for member {k}")
            out[k] = a
    return out


def host_copies(state: Any) -> tuple:
    """(``{key: numpy array}`` copied to the host, ``{key: "bfloat16"}``)
    of a state, bf16 leaves as ``uint16`` views: what a save writes."""
    arrays, dtypes = {}, {}
    for k, v in flatten(state).items():
        arrays[k], dt = to_host(v)
        if dt is not None:
            dtypes[k] = dt
    return arrays, dtypes


def from_host(arrays: dict, dtypes: dict) -> dict:
    """The flat ``{key: CPU tensor}`` of host arrays (a save's
    :func:`host_copies`, or a checkpoint's members), bf16 leaves as bf16."""
    return {k: torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
            if dtypes.get(k) == "bfloat16" else torch.from_numpy(a) for k, a in arrays.items()}


def restore_into(like: Any, flat: dict, device=None) -> Any:
    """``flat`` (by :func:`flatten`'s keys) in the structure of ``like``,
    as :meth:`CheckpointManager.restore_like` restores it."""
    return _restore(like, flat, "", device, {})


def _laid_out(a: torch.Tensor, like, layout, device) -> torch.Tensor:
    """The whole leaf ``a`` as ``like`` holds it: a DTensor on ``layout``
    (mesh, placements) or on ``like``'s own, else a tensor on ``device``
    (default ``like``'s)."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    if layout is None and isinstance(like, DTensor):
        layout = (like.device_mesh, like.placements)
    if layout is not None:
        mesh, pl = layout
        return distribute_tensor(a.to(mesh.device_type), mesh, pl)
    # a copy: ``flat`` may be kept and restored again
    return a.to(device if device is not None else like.device, copy=True)


class CheckpointManager:
    def __init__(self, directory: str | Path, keep_n: int = 3, async_save: bool = True):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep_n = keep_n
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------- save

    def save(self, step: int, state: Any) -> None:
        # host copies BEFORE going async: the state is updated in place later
        arrays, dtypes = host_copies(state)
        self.wait()
        if _rank():
            return  # rank 0 writes the gathered state
        if self.async_save:
            self._thread = threading.Thread(target=self._write, args=(step, arrays, dtypes),
                                            daemon=True)
            self._thread.start()
        else:
            self._write(step, arrays, dtypes)

    def _write(self, step: int, arrays: dict, dtypes: dict) -> None:
        tmp = self.dir / f"step_{step:09d}.tmp"
        final = self.dir / f"step_{step:09d}"
        tmp.mkdir(parents=True, exist_ok=True)
        np.savez(tmp / "host0.npz", **arrays)
        (tmp / "meta.json").write_text(json.dumps({"step": step, "dtypes": dtypes}))
        if final.exists():
            shutil.rmtree(final)
        tmp.rename(final)  # atomic publish
        self._gc()

    def _gc(self) -> None:
        steps = self.list_steps()
        for s in steps[: -self.keep_n]:
            shutil.rmtree(self.dir / f"step_{s:09d}", ignore_errors=True)

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    # ---------------------------------------------------------- restore

    def list_steps(self) -> list[int]:
        out = []
        for p in self.dir.iterdir():
            m = re.fullmatch(r"step_(\d+)", p.name)
            if m and (p / "meta.json").exists():
                out.append(int(m.group(1)))
        return sorted(out)

    def restore(self, step: int) -> dict:
        """The flat ``{key: CPU tensor}`` of a step, bf16 leaves as bf16.
        ``_READERS`` threads read the npz's members at once, the largest
        first, each member straight into its array (:func:`read_members`,
        the zip's CRC checked as ``np.load`` checks it)."""
        d = self.dir / f"step_{step:09d}"
        meta = json.loads((d / "meta.json").read_text())
        path = d / "host0.npz"
        with zipfile.ZipFile(path) as z:
            sizes = {i.filename[:-4]: i.file_size for i in z.infolist()}
        shares: list = [[] for _ in range(min(_READERS, max(1, len(sizes))))]
        loads = [0] * len(shares)
        for k in sorted(sizes, key=sizes.get, reverse=True):
            j = loads.index(min(loads))
            shares[j].append(k)
            loads[j] += sizes[k]
        with ThreadPoolExecutor(len(shares)) as ex:
            arrays = {k: a for part in ex.map(lambda ks: read_members(path, ks), shares)
                      for k, a in part.items()}
        return from_host(arrays, meta["dtypes"])

    def restore_like(self, step: int, like: Any, shardings: Optional[dict] = None,
                     device=None) -> Any:
        """Restore into the structure of ``like``: a module's tensors are
        overwritten in place (the module is returned), every other tensor
        leaf comes back new on ``device`` (default: the device of its leaf
        in ``like``), Python numbers as their type. A DTensor leaf keeps its
        mesh and placements; ``shardings`` ({key: (mesh, placements)} by
        :func:`flatten`'s keys) lays a leaf out anew, a module's parameter
        replaced by one in those placements."""
        self.wait()
        _barrier()
        return _restore(like, self.restore(step), "", device, shardings or {})

    def restore_latest(self, like: Any = None, device=None):
        self.wait()
        _barrier()
        steps = self.list_steps()
        if not steps:
            return None
        step = steps[-1]
        if like is not None:
            return step, self.restore_like(step, like, device=device)
        return step, self.restore(step)


@torch.no_grad()
def _restore(like: Any, flat: dict, prefix: str, device, shardings: dict) -> Any:
    from torch.distributed.tensor import DTensor

    if like is None:
        return None
    items = _items(like)
    if items is None:
        a = flat[prefix]
        if isinstance(like, torch.Tensor):
            return _laid_out(a, like, shardings.get(prefix), device)
        return type(like)(a.item())
    if isinstance(like, torch.nn.Module):
        for k, t in items:
            key = f"{prefix}{_SEP}{k}" if prefix else k
            if key in shardings:
                mod, _, leaf = k.rpartition(".")
                owner = like.get_submodule(mod) if mod else like
                new = _laid_out(flat[key], t, shardings[key], device)
                if leaf in owner._parameters:
                    owner._parameters[leaf] = torch.nn.Parameter(new, t.requires_grad)
                else:
                    owner._buffers[leaf] = new
            elif isinstance(t, DTensor):
                t.to_local().copy_(_laid_out(flat[key], t, None, device).to_local())
            else:
                t.copy_(flat[key])
        return like
    vals = [_restore(v, flat, f"{prefix}{_SEP}{k}" if prefix else str(k), device, shardings)
            for k, v in items]
    if isinstance(like, dict):
        return dict(zip(like.keys(), vals))
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        return type(like)(*vals)
    return type(like)(vals)
