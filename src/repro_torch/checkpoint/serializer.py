"""Checkpoint files of the port: a magic header, a length-prefixed JSON
header, then the raw little-endian bytes of every array, in order.

On-disk format::

    b"REPROTORCHCKPT\\x01"                  # magic
    uint64 little-endian: n                 # bytes of the JSON header
    n bytes of UTF-8 JSON {
      "version": 1,
      "treedef": <the structure, as ``tree_structure`` writes it>,
      "leaves": [{"path": "params", "dtype": "float32", "shape": [..],
                  "nbytes": ..}, ...],
      "meta": {...},
    }
    leaf 0's bytes, leaf 1's bytes, ...

A tree is nested dicts (string keys, kept in sorted order), lists,
tuples and ``None`` (an empty subtree), with arrays as leaves: numpy
arrays or scalars, and tensors.  Tensors are written from contiguous
CPU copies and read back onto the device of the ``like`` leaf, or onto
``device`` when it is given (``like`` may then hold tensors on the
``"meta"`` device, which allocate nothing).  Numpy leaves come back as
numpy arrays.  No msgpack and no pickle: the header is JSON, and
``json`` carries no 128-bit integer, so a numpy bit generator's state
goes into the meta as a JSON string.

``load_checkpoint`` restores into the structure of a caller-supplied
``like`` tree and checks, loudly:

- the magic (a foreign or garbage file is rejected up front);
- the header's length prefix and JSON (a truncated file is an error, not
  a bare ``json`` exception);
- the format version;
- the structure against ``like``'s, the leaf count, and per leaf its
  dtype, its shape and its byte count against ``like``'s leaf, and the
  file's length against the header's byte counts: a dtype mismatch never
  reinterprets bytes.

A fault in the file itself raises ``CheckpointError``; a mismatch against
``like`` raises a plain ``ValueError``, so resume logic can fall back to
an older file on corruption without hiding a wrong experiment.

``save_checkpoint`` is crash-durable: it writes a sibling ``.tmp`` file,
fsyncs it, ``os.replace``-s it into place and fsyncs the directory, so a
crash at any point leaves the old checkpoint or the complete new one.

The port's files are its own: it does not read the JAX package's
checkpoints (pytrees of per-leaf parameters; the port keeps one flat
(P,) row).
"""

from __future__ import annotations

import json
import os
import struct
from typing import Any

import numpy as np
import torch

__all__ = [
    "save_checkpoint",
    "load_checkpoint",
    "load_meta",
    "tree_structure",
    "CheckpointError",
    "FORMAT_VERSION",
]

FORMAT_VERSION = 1
_MAGIC = b"REPROTORCHCKPT\x01"
_LEN = struct.Struct("<Q")


class CheckpointError(ValueError):
    """The checkpoint *file* is unusable — foreign, truncated or corrupt
    (bad magic, an unparseable header, a wrong format version, a payload
    whose length disagrees with the header).  Distinct from the plain
    ``ValueError`` raised for a mismatch against the caller's ``like`` or
    config."""


def _is_leaf(x: Any) -> bool:
    return isinstance(x, (torch.Tensor, np.ndarray, np.generic))


def tree_structure(tree: Any) -> str:
    """The structure of ``tree`` as a string: ``{k:..}`` for a dict (keys
    sorted), ``[..]`` for a list, ``(..)`` for a tuple, ``None`` and
    ``*`` for a leaf."""
    if tree is None:
        return "None"
    if _is_leaf(tree):
        return "*"
    if isinstance(tree, dict):
        for k in tree:
            if not isinstance(k, str):
                raise TypeError(f"checkpoint dict keys must be strings; got {k!r}")
        return "{" + ",".join(f"{json.dumps(k)}:{tree_structure(tree[k])}"
                              for k in sorted(tree)) + "}"
    if isinstance(tree, list):
        return "[" + ",".join(tree_structure(v) for v in tree) + "]"
    if isinstance(tree, tuple):
        return "(" + ",".join(tree_structure(v) for v in tree) + ")"
    raise TypeError(f"cannot checkpoint a {type(tree).__name__}: leaves are numpy arrays, "
                    "numpy scalars or tensors, inside dicts, lists and tuples")


def _flatten(tree: Any, path: str = "") -> list[tuple[str, Any]]:
    if tree is None:
        return []
    if _is_leaf(tree):
        return [(path, tree)]
    if isinstance(tree, dict):
        items = ((k, tree[k]) for k in sorted(tree))
    else:
        items = ((str(i), v) for i, v in enumerate(tree))
    out = []
    for k, v in items:
        out.extend(_flatten(v, f"{path}/{k}" if path else k))
    return out


def _unflatten(like: Any, leaves: list) -> Any:
    it = iter(leaves)

    def build(node):
        if node is None:
            return None
        if _is_leaf(node):
            return next(it)
        if isinstance(node, dict):  # leaves are stored in sorted key order
            built = {k: build(node[k]) for k in sorted(node)}
            return {k: built[k] for k in node}
        built = [build(v) for v in node]
        return built if isinstance(node, list) else tuple(built)

    return build(like)


def _dtype_name(leaf: Any) -> str:
    if isinstance(leaf, torch.Tensor):
        return str(leaf.dtype).removeprefix("torch.")
    return str(np.asarray(leaf).dtype)


def _leaf_bytes(leaf: Any) -> memoryview:
    """The leaf's bytes, contiguous and little-endian."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu").contiguous().reshape(-1)
        return memoryview(t.view(torch.uint8).numpy())
    arr = np.asarray(leaf)
    arr = np.ascontiguousarray(arr, dtype=arr.dtype.newbyteorder("<"))
    return memoryview(arr.reshape(-1).view(np.uint8))


def _fsync_dir(path: str) -> None:
    """fsync the directory holding ``path``, so the rename itself is
    durable (POSIX; skipped where a directory cannot be opened)."""
    dirname = os.path.dirname(os.path.abspath(path)) or "."
    try:
        fd = os.open(dirname, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def save_checkpoint(path: str, tree: Any, meta: dict | None = None) -> None:
    """Write ``tree`` and the JSON-safe ``meta`` to ``path``, atomically."""
    leaves = _flatten(tree)
    data = [_leaf_bytes(leaf) for _, leaf in leaves]
    header = {
        "version": FORMAT_VERSION,
        "treedef": tree_structure(tree),
        "leaves": [{"path": p, "dtype": _dtype_name(leaf), "shape": list(leaf.shape),
                    "nbytes": d.nbytes} for (p, leaf), d in zip(leaves, data)],
        "meta": meta or {},
    }
    raw = json.dumps(header, allow_nan=True).encode("utf-8")
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(_MAGIC)
        f.write(_LEN.pack(len(raw)))
        f.write(raw)
        for d in data:
            f.write(d)
        f.flush()
        os.fsync(f.fileno())  # the payload is on disk before the rename
    os.replace(tmp, path)     # atomic on POSIX
    _fsync_dir(path)          # and the rename survives a crash too


def _read_header(f, path: str) -> tuple[dict, int]:
    """The verified header (magic, length prefix, JSON, version) and the
    offset of the first leaf's bytes."""
    magic = f.read(len(_MAGIC))
    if magic != _MAGIC:
        raise CheckpointError(f"{path!r} is not a repro_torch checkpoint (bad magic header; "
                              f"expected it to start with {_MAGIC!r})")
    prefix = f.read(_LEN.size)
    if len(prefix) != _LEN.size:
        raise CheckpointError(f"checkpoint {path!r} is truncated (no header length)")
    (n,) = _LEN.unpack(prefix)
    raw = f.read(n)
    if len(raw) != n:
        raise CheckpointError(f"checkpoint {path!r} is truncated (header of {n} bytes, "
                              f"{len(raw)} present)")
    try:
        header = json.loads(raw.decode("utf-8"))
    except (UnicodeDecodeError, ValueError) as e:
        raise CheckpointError(f"checkpoint {path!r} is corrupt (its JSON header does not "
                              f"parse: {e})") from None
    if not isinstance(header, dict) or header.get("version") != FORMAT_VERSION:
        got = header.get("version") if isinstance(header, dict) else None
        raise CheckpointError(f"unsupported checkpoint version {got!r} in {path!r} (this "
                              f"reader supports version {FORMAT_VERSION})")
    for key in ("treedef", "leaves", "meta"):
        if key not in header:
            raise CheckpointError(f"checkpoint {path!r} is corrupt (its header has no "
                                  f"{key!r})")
    return header, len(_MAGIC) + _LEN.size + n


def load_meta(path: str) -> dict:
    """The meta dict of a checkpoint, without a ``like`` tree (the async
    engine learns the in-flight ledger's shape from it before it builds the
    ``like`` skeleton that ``load_checkpoint`` checks the arrays against)."""
    with open(path, "rb") as f:
        return _read_header(f, path)[0]["meta"]


def load_checkpoint(path: str, like: Any, device: str | torch.device | None = None):
    """Restore a checkpoint into the structure of ``like``; returns ``(tree,
    meta)``.  Tensor leaves land on ``device`` (default: the ``like`` leaf's
    device); numpy leaves come back as numpy arrays."""
    with open(path, "rb") as f:
        header, offset = _read_header(f, path)
        treedef = tree_structure(like)
        if header["treedef"] != treedef:
            raise ValueError(
                "checkpoint structure does not match the target structure — refusing to "
                f"restore into a different tree:\n  checkpoint: {header['treedef']}\n"
                f"  target:     {treedef}")
        like_leaves = _flatten(like)
        stored = header["leaves"]
        if len(stored) != len(like_leaves):
            raise ValueError(f"leaf count mismatch: checkpoint has {len(stored)}, target "
                             f"structure has {len(like_leaves)}")
        size = os.fstat(f.fileno()).st_size
        want_size = offset + sum(int(item["nbytes"]) for item in stored)
        out = []
        for i, ((p, ref), item) in enumerate(zip(like_leaves, stored)):
            dtype, ref_dtype = item["dtype"], _dtype_name(ref)
            if dtype != ref_dtype:
                raise ValueError(
                    f"dtype mismatch at leaf {i} ({p}): checkpoint stores {dtype}, target "
                    f"expects {ref_dtype} — refusing to reinterpret bytes")
            shape = tuple(item["shape"])
            if shape != tuple(ref.shape):
                raise ValueError(f"shape mismatch at leaf {i} ({p}): checkpoint stores "
                                 f"{shape}, target expects {tuple(ref.shape)}")
            itemsize = (ref.element_size() if isinstance(ref, torch.Tensor)
                        else np.asarray(ref).dtype.itemsize)
            n_expected = itemsize * int(np.prod(shape, dtype=np.int64))
            if int(item["nbytes"]) != n_expected:
                raise CheckpointError(
                    f"payload length mismatch at leaf {i} ({p}): the header says "
                    f"{item['nbytes']} bytes, {dtype} x {shape} is {n_expected} — the "
                    "checkpoint is corrupt")
            buf = bytearray(n_expected)
            if f.readinto(memoryview(buf)) != n_expected:
                raise CheckpointError(
                    f"payload length mismatch at leaf {i} ({p}): the file ends before its "
                    f"{n_expected} bytes ({size} bytes in all, the header describes "
                    f"{want_size}) — the checkpoint is truncated")
            if isinstance(ref, torch.Tensor):
                t = torch.frombuffer(buf, dtype=torch.uint8) if n_expected else \
                    torch.empty(0, dtype=torch.uint8)
                t = t.view(ref.dtype).reshape(shape)
                out.append(t.to(ref.device if device is None else device))
            else:
                arr = np.frombuffer(buf, dtype=np.dtype(dtype).newbyteorder("<"))
                out.append(arr.astype(np.dtype(dtype), copy=False).reshape(shape))
        if size != want_size:
            raise CheckpointError(
                f"payload length mismatch: {path!r} holds {size} bytes, its header "
                f"describes {want_size} — the checkpoint is corrupt")
    return _unflatten(like, out), header["meta"]
