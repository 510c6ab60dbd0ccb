"""Atomic, async, verified checkpointing of trees of tensors.

Port of :mod:`repro.checkpoint.checkpointer`, on the same on-disk format, so
that either package reads the other's steps. Layout per step::

    <dir>/step_00000123.tmp/      # written fully, fsync'd, then renamed
        manifest.json             # step, tree structure, shapes, dtypes, crcs
        leaf_0000.npy ...         # one file per leaf, in flattening order
    <dir>/step_00000123/
    <dir>/step_00000123.old/      # transient: the previous copy parked during
                                  # a same-step re-save; swept at startup

The manifest holds ``step``, ``treedef`` (a label, read by no one),
``leaves`` — one ``{path, file, shape, dtype, prng_key, crc32}`` per leaf —
and the caller's ``extra``. A leaf's ``path`` is spelled as the reference's
``jax.tree_util.keystr``: ``['k']`` for a dict key, ``.name`` for a
NamedTuple or dataclass field, ``[i]`` for a sequence index. The port
flattens dicts (keys sorted, as jax does), lists, tuples, NamedTuples and
dataclasses itself; ``None`` holds no leaf.

Properties, as the reference's:
  * **Atomic** — a step is visible only after the rename; a crash mid-write
    leaves a ``.tmp`` that restore ignores and the startup sweep removes.
  * **Durable** — every leaf file and the manifest are fsync'd, then the tmp
    directory, then the parent directory.
  * **Verified** — the manifest records a CRC-32 of each leaf FILE's bytes
    (header included); :meth:`Checkpointer.verify` reports every problem,
    :meth:`Checkpointer.restore` refuses a corrupt step
    (:class:`CheckpointCorruptError`) and, when no step is pinned, falls
    back to the newest intact one.
  * **Async** — ``save`` copies every leaf to host memory before it returns
    (a tensor written in place after ``save`` returns does not change what
    is stored; on the card the copy waits for the stream), then a worker
    thread writes; ``wait()`` joins and re-raises a failed write.
  * **Restore onto a device** — each tensor leaf goes to the device of its
    target leaf, or to ``device=`` when the caller gives one; a leaf whose
    target is a host value (int, float, bool, str) comes back as that
    Python type.
  * **Logical on disk, sharded in memory** — a sharded run saves with
    ``shardings=`` (a tree of :class:`~repro_torch.distributed.par.WSpec`
    mirroring the saved tree; a leaf without one is replicated) and
    ``mesh=``: the ranks' shards of each leaf are gathered to rank 0, and
    rank 0 writes the logical arrays, the files a single-device save of
    the same state writes. ``restore(shardings=, mesh=)`` gives each rank
    its slices, so a state saved on one mesh restores onto another mesh or
    onto one device (the reference's elastic restore).

Leaves: tensors (bfloat16 stored as its uint16 bits, its dtype recorded as
``"bfloat16"``), numpy arrays and host scalars. A reference-written
``prng_key`` leaf holds the raw uint32 key words; it restores into a
tensor target in that target's dtype (the port keeps key words in int64).

``_kill_hook`` lets the chaos harness (:mod:`repro_torch.testing.chaos`)
abort a write at the named points ``begin``, ``leaves_written``,
``manifest_written``, ``pre_rename``, ``parked`` and ``renamed``.
"""

from __future__ import annotations

import copy
import dataclasses
import io
import json
import math
import os
import shutil
import threading
import zlib
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.device import resolve_device

_HOST_SCALARS = (bool, int, float, str)


class CheckpointCorruptError(RuntimeError):
    """A checkpoint failed integrity verification.

    ``problems`` lists the findings per step (missing or torn manifest,
    missing or truncated leaf files, CRC mismatches). Raised by ``restore``
    when an explicitly requested step is corrupt, or when every on-disk step
    is.
    """

    def __init__(self, message: str, problems: list[str]):
        super().__init__(message + (": " + "; ".join(problems) if problems else ""))
        self.problems = problems


# ------------------------------------------------------------------ trees


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(type(x), "_fields")


def _is_dataclass_instance(x) -> bool:
    return dataclasses.is_dataclass(x) and not isinstance(x, type)


def _children(node) -> list[tuple[str, Any]] | None:
    """``[(key spelling, child)]`` of a container node, None for a leaf."""
    if isinstance(node, dict):
        return [(f"[{k!r}]", node[k]) for k in sorted(node)]
    if _is_namedtuple(node):
        return [(f".{name}", v) for name, v in zip(node._fields, node)]
    if isinstance(node, (list, tuple)):
        return [(f"[{i}]", v) for i, v in enumerate(node)]
    if _is_dataclass_instance(node):
        return [(f".{f.name}", getattr(node, f.name))
                for f in dataclasses.fields(node)]
    return None


def flatten_with_paths(tree, prefix: str = "",
                       is_leaf: Callable[[Any], bool] | None = None
                       ) -> list[tuple[str, Any]]:
    """``[(path, leaf)]`` in the reference's flattening order and spelling
    (``is_leaf``: a node to keep whole, e.g. a WSpec dataclass)."""
    if tree is None:
        return []
    kids = None if is_leaf is not None and is_leaf(tree) else _children(tree)
    if kids is None:
        return [(prefix, tree)]
    out = []
    for key, child in kids:
        out.extend(flatten_with_paths(child, prefix + key, is_leaf))
    return out


def _spec_paths(shardings) -> dict:
    """path → WSpec of a tree of WSpecs (None leaves: replicated)."""
    from repro_torch.distributed.par import WSpec

    return dict(flatten_with_paths(shardings,
                                   is_leaf=lambda x: isinstance(x, WSpec)))


def map_with_paths(fn, tree, prefix: str = ""):
    """``tree`` with each leaf replaced by ``fn(path, leaf)``; containers
    are rebuilt with their own types (a dataclass by a shallow copy whose
    fields are set, so that its ``__init__`` does not run again)."""
    if tree is None:
        return None
    kids = _children(tree)
    if kids is None:
        return fn(prefix, tree)
    new = {key: map_with_paths(fn, child, prefix + key) for key, child in kids}
    if isinstance(tree, dict):
        return {k: new[f"[{k!r}]"] for k in tree}
    if _is_namedtuple(tree):
        return type(tree)(*new.values())
    if isinstance(tree, (list, tuple)):
        return type(tree)(new.values())
    out = copy.copy(tree)
    for key, value in new.items():
        object.__setattr__(out, key[1:], value)
    return out


def _np_bits(t: torch.Tensor) -> np.ndarray:
    """A host tensor as numpy, without a copy (bfloat16 as its uint16
    bits)."""
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _host(leaf) -> tuple[np.ndarray, str]:
    """A host copy of one leaf, and the dtype name the manifest records."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        a = _np_bits(t.to("cpu", copy=True))
        return a, "bfloat16" if t.dtype == torch.bfloat16 else str(a.dtype)
    if isinstance(leaf, (np.ndarray, np.generic) + _HOST_SCALARS):
        a = np.array(leaf, copy=True)
        if a.dtype == object:
            raise TypeError(f"cannot checkpoint an object array ({leaf!r})")
        return a, str(a.dtype)
    raise TypeError(f"cannot checkpoint a leaf of type {type(leaf).__name__}")


def _write_npy(path: Path, a: np.ndarray):
    """``a`` as a ``.npy`` file, fsync'd."""
    with open(path, "wb") as f:
        np.save(f, a)
        f.flush()
        os.fsync(f.fileno())


def _fsync_path(p: Path):
    """fsync a file or directory by path (O_RDONLY works for both on Linux)."""
    fd = os.open(p, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _shape_of(leaf) -> tuple:
    if isinstance(leaf, (torch.Tensor, np.ndarray, np.generic)):
        return tuple(leaf.shape)
    return ()


def _dtype_name(leaf) -> str | None:
    """The manifest's spelling of an array leaf's dtype; None for a host
    value."""
    if isinstance(leaf, torch.Tensor):
        return str(leaf.dtype).removeprefix("torch.")
    if isinstance(leaf, (np.ndarray, np.generic)):
        return str(leaf.dtype)
    return None


def _restored_leaf(arr: np.ndarray, meta: dict, ref, device):
    """The stored array as the kind of leaf ``ref`` is."""
    if meta["dtype"] == "bfloat16":
        arr = arr.view(np.uint16)
    if isinstance(ref, torch.Tensor):
        if meta["dtype"] == "bfloat16":
            t = torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
        else:
            t = torch.from_numpy(arr.copy())
        if meta.get("prng_key"):
            t = t.to(ref.dtype)
        return t.to(ref.device if device is None else device)
    if isinstance(ref, np.ndarray):
        return arr.copy()
    if isinstance(ref, np.generic):
        return arr[()]
    if isinstance(ref, _HOST_SCALARS):
        return type(ref)(arr.item())
    raise TypeError(f"cannot restore into a leaf of type {type(ref).__name__}")


def _manifest(step, tree_label, metas, extra_metadata) -> dict:
    """A step's manifest before its checksums: ``metas`` is one (path,
    shape, dtype name) a leaf, in flattening order."""
    return {
        "step": int(step),
        "treedef": f"{tree_label} of {len(metas)} leaves",
        "leaves": [
            {"path": p, "file": f"leaf_{i:04d}.npy", "shape": list(shape),
             "dtype": dtype, "prng_key": False}
            for i, (p, shape, dtype) in enumerate(metas)
        ],
        "extra": extra_metadata or {},
    }


def _np_storage(t: torch.Tensor) -> np.dtype:
    """The numpy dtype a tensor is stored as (bfloat16 as its uint16
    bits)."""
    if t.dtype == torch.bfloat16:
        return np.dtype(np.uint16)
    return torch.empty((), dtype=t.dtype).numpy().dtype


class Checkpointer:
    def __init__(self, directory: str | os.PathLike, keep: int = 3,
                 keep_last: int | None = None):
        """``keep_last`` (alias ``keep``): retain the newest N completed
        checkpoints, removing older ones after every save; 0 keeps
        everything. Startup sweeps crash debris: stale ``step_*.tmp``
        directories, and half-finished same-step re-saves (a ``step_*.old``
        parking directory with no final directory is renamed back: the
        previous intact checkpoint wins over a tmp of unknown provenance)."""
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep if keep_last is None else keep_last
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None
        # Chaos seam: called with a named point during the write sequence;
        # raising from it simulates a crash at exactly that point.
        self._kill_hook: Callable[[str], None] | None = None
        # Steps skipped as corrupt by the most recent fallback scan.
        self.last_skipped: list[int] = []
        self._sweep_tmp()

    def _sweep_tmp(self):
        for p in sorted(self.dir.iterdir()):
            if not p.is_dir() or not p.name.startswith("step_"):
                continue
            if p.name.endswith(".old"):
                final = self.dir / p.name[:-4]
                if final.exists():
                    # The promote completed; the parked copy is redundant.
                    shutil.rmtree(p, ignore_errors=True)
                else:
                    # Crashed between parking and promote: roll the previous
                    # intact checkpoint back into place.
                    os.rename(p, final)
            elif p.name.endswith(".tmp"):
                shutil.rmtree(p, ignore_errors=True)

    def _kill(self, point: str):
        if self._kill_hook is not None:
            self._kill_hook(point)

    # ------------------------------------------------------------------ save

    def save(self, step: int, tree, extra_metadata: dict | None = None,
             blocking: bool = False, shardings=None, mesh=None):
        """Copy every leaf to host memory, then write, fsync and rename on a
        worker thread (``blocking``: on this thread). Write order (kill
        points in brackets): [begin] leaf files fsync'd one by one
        [leaves_written], manifest fsync'd [manifest_written], tmp dir
        fsync'd [pre_rename], any existing final parked to ``.old``
        [parked], tmp renamed to final and the parent dir fsync'd
        [renamed], parking dir removed, old steps removed. A crash at any
        point leaves either the old step or the new one intact.

        Sharded (``shardings``, ``mesh``; every rank of the mesh calls it):
        one leaf at a time, every rank's shard is gathered to rank 0
        (:func:`~repro_torch.distributed.comm.gather`), which assembles the
        logical array and writes and fsyncs its file on a writer thread
        while the next leaf is gathered; a leaf without a spec is rank
        0's. Rank 0 alone writes, so the save is the same on a local disk
        or a shared filesystem, and at most two logical leaves are in its
        host memory at a time. The files are written before ``save``
        returns; the checksums, manifest and rename follow on rank 0's
        worker thread, and with ``blocking`` every rank returns once the
        step is on disk."""
        self.wait()
        if shardings is not None:
            return self._save_sharded(step, tree, extra_metadata, blocking,
                                      shardings, mesh)
        host = [(p, *_host(a)) for p, a in flatten_with_paths(tree)]
        manifest = _manifest(step, type(tree).__name__,
                             [(p, a.shape, dtype) for p, a, dtype in host],
                             extra_metadata)

        def write():
            tmp = self._fresh_tmp(step)
            for i, (_, a, _) in enumerate(host):
                _write_npy(tmp / f"leaf_{i:04d}.npy", a)
            self._commit(step, manifest)

        self._run(write, blocking)

    def _save_sharded(self, step, tree, extra_metadata, blocking, shardings,
                      mesh):
        import torch.distributed as dist

        from repro_torch.distributed import comm
        from repro_torch.distributed.par import shard_index
        from repro_torch.launch.mesh import make_par

        group = mesh.group(mesh.axis_names)
        # every rank's Checkpointer has swept stale tmps from the directory
        # (its constructor) before rank 0 makes this step's
        dist.barrier(group=group)
        specs = _spec_paths(shardings)
        leaves = [(p, a, specs.get(p)) for p, a in flatten_with_paths(tree)]
        root = mesh.rank == 0
        if root:  # each rank's shard index and whether it is a first replica
            pars = [make_par(dataclasses.replace(mesh, rank=r))
                    for r in range(mesh.size)]
            tmp = self._fresh_tmp(step)
            writer = ThreadPoolExecutor(1)  # leaf i's write overlaps i + 1
            pending = writer.submit(lambda: None)
        metas = []
        for i, (p, a, spec) in enumerate(leaves):
            parts = None if spec is None else comm.gather(a, group)
            if not root:
                continue
            if spec is None:  # whole on every rank: rank 0 writes it
                arr, dtype = _host(a)
            else:
                arr = np.empty(spec.shape, _np_storage(a))
                dtype = _dtype_name(a)
                for q, part in zip(pars, parts):
                    if spec.sync and q.mesh.index(spec.sync):
                        continue  # a replica of a shard placed already
                    arr[shard_index(spec, q)] = _np_bits(part.cpu())
            metas.append((p, arr.shape, dtype))
            pending.result()  # at most two logical leaves in host memory
            pending = writer.submit(_write_npy, tmp / f"leaf_{i:04d}.npy",
                                    arr)
            del arr, parts
        if root:
            pending.result()
            writer.shutdown()
            manifest = _manifest(step, type(tree).__name__, metas,
                                 extra_metadata)
            self._run(lambda: self._commit(step, manifest), blocking)
        if blocking:
            dist.barrier(group=group)

    def _fresh_tmp(self, step) -> Path:
        """[begin], then an empty ``step_*.tmp`` directory."""
        tmp = self.dir / f"step_{step:08d}.tmp"
        self._kill("begin")
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        return tmp

    def _commit(self, step, manifest):
        """Checksum the tmp directory's leaf files (the FILE bytes, header
        included, read back after their fsync: a later single-bit flip
        anywhere in a file fails verify), then the manifest, the fsyncs and
        the rename of the save's write order."""
        tmp = self.dir / f"step_{step:08d}.tmp"
        final = self.dir / f"step_{step:08d}"
        old = self.dir / f"step_{step:08d}.old"
        for meta in manifest["leaves"]:
            meta["crc32"] = zlib.crc32((tmp / meta["file"]).read_bytes())
        self._kill("leaves_written")
        with open(tmp / "manifest.json", "w") as f:
            f.write(json.dumps(manifest, indent=1))
            f.flush()
            os.fsync(f.fileno())
        self._kill("manifest_written")
        _fsync_path(tmp)
        self._kill("pre_rename")
        if final.exists():
            if old.exists():
                shutil.rmtree(old)
            os.rename(final, old)
            self._kill("parked")
        os.rename(tmp, final)
        _fsync_path(self.dir)
        self._kill("renamed")
        if old.exists():
            shutil.rmtree(old, ignore_errors=True)
        self._gc()

    def _run(self, write, blocking):
        if blocking:
            write()
            return

        def runner():
            try:
                write()
            except BaseException as e:  # surfaced by the next wait()
                self._error = e

        self._thread = threading.Thread(target=runner, daemon=True)
        self._thread.start()

    def wait(self):
        """Join any in-flight write; re-raise its failure instead of letting
        a broken save pass as committed."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            e, self._error = self._error, None
            raise e

    def _gc(self):
        steps = sorted(self.all_steps())
        for s in steps[: -self.keep] if self.keep else []:
            shutil.rmtree(self.dir / f"step_{s:08d}", ignore_errors=True)

    # ---------------------------------------------------------------- verify

    def verify(self, step: int) -> list[str]:
        """Integrity-check one checkpoint; return its problems (empty means
        intact): a torn or unparseable manifest, missing leaf files,
        truncated arrays (unreadable, or a shape other than the manifest's)
        and any bit flip (per-file CRC-32). Manifests without checksums
        verify structurally only."""
        cdir = self.dir / f"step_{step:08d}"
        if not cdir.is_dir():
            return [f"step {step}: directory missing"]
        problems: list[str] = []
        try:
            manifest = json.loads((cdir / "manifest.json").read_text())
        except FileNotFoundError:
            return [f"step {step}: manifest.json missing"]
        except (json.JSONDecodeError, UnicodeDecodeError) as e:
            return [f"step {step}: manifest unreadable ({e})"]
        if manifest.get("step") != step:
            problems.append(
                f"step {step}: manifest claims step {manifest.get('step')}"
            )
        for meta in manifest.get("leaves", []):
            fpath = cdir / meta["file"]
            try:
                raw = fpath.read_bytes()
            except FileNotFoundError:
                problems.append(f"step {step}: {meta['file']} missing")
                continue
            want = meta.get("crc32")
            if want is not None and zlib.crc32(raw) != want:
                problems.append(
                    f"step {step}: {meta['file']} ({meta['path']}) crc32 "
                    f"{zlib.crc32(raw):#010x} != manifest {want:#010x}"
                )
                continue
            try:
                arr = np.load(io.BytesIO(raw))
            except Exception as e:  # any unreadable file is a finding
                problems.append(f"step {step}: {meta['file']} unreadable ({e})")
                continue
            if list(arr.shape) != list(meta["shape"]):
                problems.append(
                    f"step {step}: {meta['file']} shape {list(arr.shape)} "
                    f"!= manifest {meta['shape']}"
                )
        return problems

    def latest_intact_step(self) -> int | None:
        """Newest step that passes :meth:`verify`; corrupt steps skipped on
        the way down go to ``self.last_skipped`` (newest first), so that
        callers can report the fallback."""
        self.wait()
        skipped: list[int] = []
        for s in sorted(self.all_steps(), reverse=True):
            if not self.verify(s):
                self.last_skipped = skipped
                return s
            skipped.append(s)
        self.last_skipped = skipped
        return None

    # --------------------------------------------------------------- restore

    def all_steps(self) -> list[int]:
        out = []
        for p in self.dir.iterdir():
            if p.is_dir() and p.name.startswith("step_") and not p.name.endswith(".tmp"):
                try:
                    out.append(int(p.name[5:]))
                except ValueError:
                    continue
        return sorted(out)

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def _resolve(self, step: int | None, verify: bool) -> int | None:
        """An unpinned ``step``: the newest intact one (``verify``) or the
        newest; refuses loudly when every step on disk is corrupt."""
        if step is not None:
            return step
        if not verify:
            return self.latest_step()
        step = self.latest_intact_step()
        if step is None and self.all_steps():
            raise CheckpointCorruptError(
                f"no intact checkpoint under {self.dir}",
                [p for s in self.all_steps() for p in self.verify(s)],
            )
        return step

    def manifest(self, step: int | None = None, verify: bool = True) -> dict:
        """Parsed manifest.json of a checkpoint (by default the newest
        intact one). A service restart reads ``extra`` (its job registry)
        from here before it can build the restore target, and with
        ``verify`` the manifest it plans from is the one restore loads."""
        self.wait()
        step = self._resolve(step, verify)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.dir}")
        return json.loads(
            (self.dir / f"step_{step:08d}" / "manifest.json").read_text()
        )

    def restore(self, target_tree, step: int | None = None, shardings=None,
                verify: bool = True, device=None, mesh=None):
        """Restore into the structure of ``target_tree``; returns
        ``(tree, manifest)``.

        Each tensor leaf goes to its target leaf's device, or to ``device``
        when given (a card asked for and absent raises). Host-value targets
        come back as their Python types. Stored shapes, and the dtypes of
        tensor and numpy targets, must equal the target's (also with
        ``verify=False``); a ``prng_key`` leaf takes its target's dtype.

        ``verify`` (default True): an explicitly requested corrupt step
        raises :class:`CheckpointCorruptError`; with ``step=None`` the
        newest intact step is loaded (skipped corrupt steps land in
        ``self.last_skipped``), and if every step is corrupt the restore
        refuses.

        ``shardings`` (a tree of WSpecs mirroring the target; a leaf without
        one is replicated) with ``mesh``, this rank's mesh: restore onto a
        mesh. Every rank of the mesh calls it (after a barrier that lets
        rank 0's pending write finish); each stored leaf must have its
        spec's logical shape, and each rank gets its slice, whose shape
        must be its target leaf's. Without ``verify`` the files are memory
        mapped, so each rank reads only its blocks of each file."""
        dev = None if device is None else resolve_device(device)
        self.wait()
        specs, par = {}, None
        if shardings is not None:
            import torch.distributed as dist

            from repro_torch.launch.mesh import make_par

            dist.barrier(group=mesh.group(mesh.axis_names))
            specs, par = _spec_paths(shardings), make_par(mesh)
        self.last_skipped = []
        pinned = step is not None
        step = self._resolve(step, verify)
        if pinned and verify:
            problems = self.verify(step)
            if problems:
                raise CheckpointCorruptError(
                    f"checkpoint step {step} is corrupt", problems
                )
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.dir}")
        cdir = self.dir / f"step_{step:08d}"
        manifest = json.loads((cdir / "manifest.json").read_text())
        by_path = {m["path"]: m for m in manifest["leaves"]}

        def load(path, ref):
            if path not in by_path:
                raise KeyError(f"checkpoint missing leaf {path}")
            meta = by_path[path]
            spec = specs.get(path)
            if not verify and math.prod(meta["shape"]):
                # a memory map: a sharded restore reads only its blocks
                arr = np.load(cdir / meta["file"], mmap_mode="r")
            else:
                raw = (cdir / meta["file"]).read_bytes()
                want = meta.get("crc32")
                if verify and want is not None and zlib.crc32(raw) != want:
                    raise CheckpointCorruptError(
                        f"checkpoint step {step} is corrupt",
                        [f"step {step}: {meta['file']} ({path}) crc32 "
                         f"{zlib.crc32(raw):#010x} != manifest {want:#010x}"],
                    )
                arr = np.load(io.BytesIO(raw))
            if spec is not None:
                if tuple(arr.shape) != spec.shape:
                    raise ValueError(f"shape mismatch for {path}: "
                                     f"{arr.shape} vs logical {spec.shape}")
                from repro_torch.distributed.par import local_slice

                arr = local_slice(arr, spec, par)
            if tuple(arr.shape) != _shape_of(ref):
                raise ValueError(f"shape mismatch for {path}: {arr.shape} "
                                 f"vs {_shape_of(ref)}")
            want_dtype = _dtype_name(ref)
            if (want_dtype is not None and not meta.get("prng_key")
                    and meta["dtype"] != want_dtype):
                raise ValueError(f"dtype mismatch for {path}: "
                                 f"{meta['dtype']} vs {want_dtype}")
            return _restored_leaf(arr, meta, ref, dev)

        return map_with_paths(load, target_tree), manifest
