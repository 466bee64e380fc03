"""Verified checkpoints: atomic writes, CRC32 manifests, keep-last-K
rotation and corruption-tolerant restore (the port of
``mxtpu/resilience/checkpoint.py``, whole; its files and the
reference's verify under each other).

A crash mid-way through ``open(f, "wb"); f.write(...)`` leaves a
truncated file AT THE FINAL PATH, and the next restore misparses it.
Every write here goes tmp-file → flush → ``os.fsync`` → atomic
``os.replace``: the final path holds either the complete old bytes or
the complete new bytes, never a mixture.

Alongside every payload sits a JSON manifest (``<file>.mxmf``, the
reference's format byte for byte)::

    {"format": 1, "size": N, "crc32": C,
     "tensors": [{"name", "offset", "size", "crc32"}, ...]}

``verify()`` checks size and whole-file CRC and, when per-tensor entries
exist, attributes a mismatch to the first damaged tensor's byte offset.
Restore paths (the serving engines' ``adopt``) call it before parsing,
so truncation and bit-rot surface as a typed
:class:`CorruptCheckpointError` naming the file and offset — never a raw
unpickling error or silently wrong weights.

Two fault sites make every failure path deterministically testable:
``ckpt.write`` fires before any byte lands (an injected raise = a failed
write that leaves the previous checkpoint intact) and ``ckpt.verify``
fires at each verification.

:class:`CheckpointSet` adds step-indexed keep-last-K rotation with
``latest_verified()`` fallback: a corrupted newest checkpoint is
detected, counted (``ckpt_corruptions`` / ``ckpt_fallbacks``), and the
restore falls back to the previous good one.  ``rotate_history()`` is
the fixed-name (logrotate-style) variant.  ``MXTPU_CKPT_KEEP`` sets the
default K (default 3).
"""

from __future__ import annotations

import json
import os
import zlib
from typing import List, Optional, Tuple

from ..base import MXTPUError
from .counters import bump
from .faults import inject

__all__ = ["CorruptCheckpointError", "MANIFEST_SUFFIX", "default_keep",
           "atomic_bytes", "write_verified", "verify", "has_manifest",
           "stamp_save_event", "save_event",
           "write_dir_manifest", "verify_dir", "rotate_history",
           "move_with_manifest", "CheckpointSet"]

MANIFEST_SUFFIX = ".mxmf"


class CorruptCheckpointError(MXTPUError):
    """A checkpoint failed verification or parsing.  ``path`` names the
    file; ``offset`` is the byte offset of the damage when it could be
    attributed (the first failing tensor / the truncation point), else
    None."""

    def __init__(self, message: str, path: Optional[str] = None,
                 offset: Optional[int] = None):
        self.path = path
        self.offset = offset
        loc = ""
        if path is not None:
            loc = " [file %r%s]" % (
                path, "" if offset is None else ", byte offset %d" % offset)
        super().__init__(message + loc)


def _flight_corruption(path: str, step, exc) -> None:
    """Flight-recorder hook on a detected-and-survived corruption: the
    postmortem names the damaged file and generation.  Lazy import — this module is on the checkpoint hot
    path and the recorder is usually off.  Path basenames only: a
    postmortem must stay byte-identical across reruns in different
    temp dirs."""
    from ..observability.flight import get_flight
    fl = get_flight()
    if not fl.active:
        return
    fl.failure("ckpt_corruption", rids=("train",),
               file=os.path.basename(path), step=int(step),
               error=type(exc).__name__)


def default_keep() -> int:
    """Checkpoints retained by rotation (``MXTPU_CKPT_KEEP``, default 3)."""
    try:
        return max(1, int(os.environ.get("MXTPU_CKPT_KEEP", "3")))
    except ValueError:
        return 3


# -- atomic write -----------------------------------------------------------

def _fsync_dir(path: str) -> None:
    # fsync the directory so a rename itself survives power loss; some
    # filesystems refuse O_RDONLY dir fds — best-effort
    try:
        dfd = os.open(os.path.dirname(path) or ".", os.O_RDONLY)
        try:
            os.fsync(dfd)
        finally:
            os.close(dfd)
    except OSError:
        pass


def _write_tmp(path: str, chunks) -> Tuple[str, int, int]:
    """Stream an iterable of byte chunks into a same-directory tmp file
    (fsynced, NOT yet renamed), computing the running size and CRC32 as
    the bytes pass through — the payload is never held resident as one
    buffer.  Returns ``(tmp_path, size, crc32)``; the caller owns the
    rename (and the cleanup on failure)."""
    tmp = "%s.tmp.%d" % (path, os.getpid())
    size = 0
    crc = 0
    try:
        with open(tmp, "wb") as f:
            for b in chunks:
                f.write(b)
                size += len(b)
                crc = zlib.crc32(b, crc)
            f.flush()
            os.fsync(f.fileno())
    except BaseException:
        # a chunk generator that raises mid-stream (MemoryError
        # materializing a tensor) must not orphan a part-written multi-GB tmp — the caller's cleanup
        # never learns this path existed
        _discard_tmp(tmp)
        raise
    return tmp, size, crc & 0xFFFFFFFF


def _discard_tmp(tmp: Optional[str]) -> None:
    if tmp and os.path.exists(tmp):
        try:
            os.remove(tmp)
        except OSError:
            pass


def _atomic_write(path: str, chunks) -> Tuple[int, int]:
    """Single-pass atomic write: tmp file + fsync + ``os.replace``.  A
    crash at any point leaves the final path holding either the complete
    previous bytes or the complete new bytes.  Returns ``(size, crc32)``."""
    path = os.fspath(path)
    tmp = None
    try:
        tmp, size, crc = _write_tmp(path, chunks)
        os.replace(tmp, path)
    finally:
        _discard_tmp(tmp)
    _fsync_dir(path)
    return size, crc


def atomic_bytes(path: str, data: bytes) -> None:
    """Write ``data`` to ``path`` atomically (see :func:`_atomic_write`)."""
    _atomic_write(path, (data,))


def write_verified(path: str, data,
                   tensors: Optional[List[dict]] = None) -> None:
    """Atomically write ``data`` — bytes, or an iterable of byte chunks
    (streamed: a multi-GB checkpoint is never resident as one buffer) —
    plus its CRC32 manifest sidecar.  A chunk generator may append to
    ``tensors`` as it streams; the manifest is built only after the last
    chunk lands.  The ``ckpt.write`` fault site fires BEFORE any byte
    lands, so an injected failure models a write that never started —
    the previous checkpoint at ``path`` stays intact.

    Payload and manifest are two files, and two renames cannot commit
    atomically together — so the NEW manifest is staged as
    ``<file>.mxmf.next`` before the payload rename and committed to
    ``<file>.mxmf`` after it.  Every crash point then leaves a loadable
    pair: before the payload rename, the old payload + old manifest are
    untouched; between the two renames, the new payload pairs with the
    staged manifest, which :func:`verify` detects (CRC match) and
    promotes."""
    inject("ckpt.write", key=os.path.basename(path))
    if isinstance(data, (bytes, bytearray, memoryview)):
        data = (data,)
    path = os.fspath(path)
    mpath = path + MANIFEST_SUFFIX
    staged = mpath + ".next"
    tmp = None
    try:
        tmp, size, crc = _write_tmp(path, data)
        manifest = {"format": 1, "size": size, "crc32": crc,
                    "tensors": tensors or []}
        atomic_bytes(staged, json.dumps(manifest).encode("utf-8"))
        os.replace(tmp, path)
    finally:
        _discard_tmp(tmp)
    os.replace(staged, mpath)
    _fsync_dir(path)
    bump("ckpt_writes")


def has_manifest(path: str) -> bool:
    return os.path.exists(path + MANIFEST_SUFFIX)


def stamp_save_event(path: str, token: str) -> None:
    """Record a shared save-event token in ``path``'s manifest sidecar.
    A checkpoint that spans multiple files (a params and a states
    file) commits each file with a separate rename, and a crash between
    the renames pairs files from DIFFERENT save events — each passing
    its own CRC check.  Stamping every member of one save with the same
    token lets the restore path match files by provenance instead of
    trusting the rotation suffixes to stay aligned."""
    m = _read_manifest(path)
    if m is None:
        raise CorruptCheckpointError(
            "cannot stamp save event: no manifest sidecar", path=path)
    m["save_event"] = str(token)
    atomic_bytes(path + MANIFEST_SUFFIX, json.dumps(m).encode("utf-8"))


def save_event(path: str) -> Optional[str]:
    """The save-event token recorded in ``path``'s manifest, or None
    (no manifest / unstamped / unreadable — callers fall back to
    suffix-aligned pairing for checkpoints written before stamping)."""
    try:
        m = _read_manifest(path)
    except CorruptCheckpointError:
        return None
    if not isinstance(m, dict):
        return None
    t = m.get("save_event")
    return str(t) if t is not None else None


# -- verification -----------------------------------------------------------

def _promote_staged(path: str, data: bytes) -> Optional[dict]:
    """Rescue for a crash between write_verified's two renames: if a
    staged ``<file>.mxmf.next`` exists and matches ``data``, commit it
    as the real manifest and return it.  The CRC gate means a stale
    staged file (describing other bytes) can never be promoted."""
    staged = path + MANIFEST_SUFFIX + ".next"
    if not os.path.exists(staged):
        return None
    try:
        with open(staged, "rb") as f:
            m = json.loads(f.read())
    except (ValueError, OSError):
        return None
    if (not isinstance(m, dict) or m.get("size") != len(data)
            or m.get("crc32") != (zlib.crc32(data) & 0xFFFFFFFF)):
        return None
    os.replace(staged, path + MANIFEST_SUFFIX)
    return m


def _read_manifest(path: str) -> Optional[dict]:
    mpath = path + MANIFEST_SUFFIX
    if not os.path.exists(mpath):
        return None
    try:
        with open(mpath, "rb") as f:
            m = json.loads(f.read())
        if not isinstance(m, dict) or ("crc32" not in m
                                       and "files" not in m):
            raise ValueError("not a manifest")
        return m
    except (ValueError, OSError) as e:
        raise CorruptCheckpointError(
            "checkpoint manifest unreadable (%s)" % e, path=mpath,
            offset=0) from None


def verify(path: str, required: bool = False,
           data: Optional[bytes] = None) -> Optional[dict]:
    """Verify ``path`` against its manifest.  Returns the manifest dict
    on success, None when no manifest exists and ``required`` is False.
    Raises :class:`CorruptCheckpointError` on a missing file (when
    ``required``), size mismatch, or CRC mismatch — attributed to the
    first damaged tensor's byte offset when per-tensor entries exist.

    ``data``: the file's already-read contents.  Restore paths read the
    payload to parse it anyway — passing it here avoids a second full
    read of a potentially multi-GB checkpoint just for the CRC."""
    inject("ckpt.verify", key=os.path.basename(path))
    if data is None and not os.path.exists(path):
        if required or has_manifest(path):
            raise CorruptCheckpointError("checkpoint file missing",
                                         path=path)
        return None
    manifest = _read_manifest(path)
    if manifest is None:
        if os.path.exists(path + MANIFEST_SUFFIX + ".next"):
            if data is None:
                with open(path, "rb") as f:
                    data = f.read()
            manifest = _promote_staged(path, data)
        if manifest is None:
            if required:
                raise CorruptCheckpointError(
                    "checkpoint has no manifest (%s sidecar missing) but "
                    "verification was required" % MANIFEST_SUFFIX,
                    path=path)
            return None
        return manifest
    if data is None:
        with open(path, "rb") as f:
            data = f.read()
    if len(data) != manifest["size"]:
        promoted = _promote_staged(path, data)
        if promoted is not None:
            return promoted
        raise CorruptCheckpointError(
            "checkpoint size mismatch: %d bytes on disk, manifest says %d"
            % (len(data), manifest["size"]), path=path,
            offset=min(len(data), manifest["size"]))
    if (zlib.crc32(data) & 0xFFFFFFFF) != manifest["crc32"]:
        promoted = _promote_staged(path, data)
        if promoted is not None:
            return promoted
        # attribute to the first damaged tensor when we can
        for t in manifest.get("tensors") or []:
            seg = data[t["offset"]:t["offset"] + t["size"]]
            if (zlib.crc32(seg) & 0xFFFFFFFF) != t["crc32"]:
                raise CorruptCheckpointError(
                    "checkpoint CRC mismatch in tensor %r"
                    % t.get("name", "?"), path=path, offset=t["offset"])
        raise CorruptCheckpointError("checkpoint CRC mismatch", path=path,
                                     offset=0)
    return manifest


# -- directory manifests (directory-tree checkpoints) -----------------------

def _crc_file(path: str) -> Tuple[int, int]:
    """``(size, crc32)`` of a file, streamed in 1MB chunks — the one
    definition both the directory-manifest writer and verifier use."""
    size = 0
    crc = 0
    with open(path, "rb") as f:
        while True:
            chunk = f.read(1 << 20)
            if not chunk:
                break
            crc = zlib.crc32(chunk, crc)
            size += len(chunk)
    return size, crc & 0xFFFFFFFF


def write_dir_manifest(root: str) -> None:
    """Manifest for a directory-tree checkpoint (``<root>.mxmf``): every
    file's relative path, size, and CRC32."""
    inject("ckpt.write", key=os.path.basename(root))
    files = []
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames.sort()
        for fn in sorted(filenames):
            full = os.path.join(dirpath, fn)
            rel = os.path.relpath(full, root)
            size, crc = _crc_file(full)
            files.append({"path": rel, "size": size, "crc32": crc})
    manifest = {"format": 1, "dir": True, "files": files}
    atomic_bytes(root.rstrip(os.sep) + MANIFEST_SUFFIX,
                 json.dumps(manifest).encode("utf-8"))
    bump("ckpt_writes")


def verify_dir(root: str, required: bool = False) -> Optional[dict]:
    """Verify a directory-tree checkpoint against its manifest.  Same
    contract as :func:`verify`; a damaged entry is reported with the
    offending file's path (offset 0 within that file)."""
    inject("ckpt.verify", key=os.path.basename(root))
    mpath = root.rstrip(os.sep) + MANIFEST_SUFFIX
    if not os.path.isdir(root):
        if required or os.path.exists(mpath):
            raise CorruptCheckpointError("checkpoint directory missing",
                                         path=root)
        return None
    if not os.path.exists(mpath):
        if required:
            raise CorruptCheckpointError(
                "checkpoint directory has no manifest but verification "
                "was required", path=root)
        return None
    manifest = _read_manifest(root.rstrip(os.sep))
    for entry in manifest.get("files", []):
        full = os.path.join(root, entry["path"])
        if not os.path.exists(full):
            raise CorruptCheckpointError(
                "checkpoint member %r missing" % entry["path"], path=full)
        size, crc = _crc_file(full)
        if size != entry["size"] or crc != entry["crc32"]:
            raise CorruptCheckpointError(
                "checkpoint member %r damaged (size %d vs %d)"
                % (entry["path"], size, entry["size"]), path=full, offset=0)
    return manifest


# -- fixed-name rotation -----------------------------------------------------

def move_with_manifest(src: str, dst: str) -> None:
    """``os.replace`` a checkpoint payload together with its manifest
    sidecars (``.mxmf`` and a staged ``.mxmf.next``); stale sidecars at
    ``dst`` are removed so a payload can never pair with a manifest
    describing other bytes."""
    os.replace(src, dst)
    for suf in (MANIFEST_SUFFIX, MANIFEST_SUFFIX + ".next"):
        msrc, mdst = src + suf, dst + suf
        if os.path.exists(msrc):
            os.replace(msrc, mdst)
        elif os.path.exists(mdst):
            os.remove(mdst)  # dst must not keep a stale sidecar



def rotate_history(path: str, keep: Optional[int] = None) -> None:
    """Logrotate-style shift before overwriting a fixed-name checkpoint:
    ``path`` → ``path.1`` → ``path.2`` …, retaining ``keep`` total
    (current + keep-1 generations).  Manifests travel with their
    payloads."""
    keep = default_keep() if keep is None else max(1, int(keep))
    if not os.path.exists(path):
        return
    oldest = "%s.%d" % (path, keep - 1)
    if keep == 1:
        return  # nothing retained beyond the file about to be replaced
    for p in (oldest, oldest + MANIFEST_SUFFIX):
        if os.path.exists(p):
            os.remove(p)
    for g in range(keep - 2, 0, -1):
        src = "%s.%d" % (path, g)
        if os.path.exists(src):
            move_with_manifest(src, "%s.%d" % (path, g + 1))
    move_with_manifest(path, "%s.1" % path)


# -- step-indexed rotation ---------------------------------------------------

class CheckpointSet:
    """A rotated series of verified, step-indexed checkpoint blobs:
    ``<dir>/<name>-<step:08d>.ckpt`` (+ manifest sidecars), keep-last-K.

    ``latest_verified()`` is the restore entry point: it walks newest →
    oldest, verifies each, and returns the first intact one — a
    corrupted (or missing) newer checkpoint is counted
    (``ckpt_corruptions``) and skipped (``ckpt_fallbacks``): the
    automatic previous-good fallback."""

    def __init__(self, directory: str, name: str = "guardian",
                 keep: Optional[int] = None):
        self.directory = os.fspath(directory)
        self.name = name
        self.keep = default_keep() if keep is None else max(1, int(keep))
        os.makedirs(self.directory, exist_ok=True)

    def path(self, step: int) -> str:
        return os.path.join(self.directory,
                            "%s-%08d.ckpt" % (self.name, step))

    def steps(self) -> List[int]:
        """Steps with a checkpoint payload on disk, ascending."""
        pre, suf = self.name + "-", ".ckpt"
        out = []
        for fn in os.listdir(self.directory):
            if fn.startswith(pre) and fn.endswith(suf):
                try:
                    out.append(int(fn[len(pre):-len(suf)]))
                except ValueError:
                    continue
        return sorted(out)

    def save(self, step: int, data: bytes,
             tensors: Optional[List[dict]] = None) -> str:
        p = self.path(int(step))
        write_verified(p, data, tensors=tensors)
        self._prune()
        return p

    def _prune(self) -> None:
        steps = self.steps()
        for s in steps[:-self.keep] if len(steps) > self.keep else []:
            p = self.path(s)
            for f in (p, p + MANIFEST_SUFFIX):
                try:
                    os.remove(f)
                except OSError:
                    pass

    def latest_verified(self) -> Optional[Tuple[int, bytes]]:
        """(step, payload) of the newest checkpoint that verifies, or
        None.  A corrupt newer generation bumps ``ckpt_corruptions``; a
        merely missing file (raced away) is skipped without one; and
        ``ckpt_fallbacks`` is bumped only when a subsequent generation
        actually verifies — a walk that finds nothing counts zero
        fallbacks."""
        fell_past = False
        for s in reversed(self.steps()):
            p = self.path(s)
            try:
                with open(p, "rb") as f:
                    payload = f.read()
            except OSError:
                fell_past = True
                continue
            try:
                verify(p, required=True, data=payload)
            except CorruptCheckpointError as exc:
                bump("ckpt_corruptions")
                _flight_corruption(p, s, exc)
                fell_past = True
                continue
            if fell_past:
                bump("ckpt_fallbacks")
            return s, payload
        return None
