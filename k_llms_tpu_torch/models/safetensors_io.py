"""The safetensors container, read and written with numpy and torch only.

A file is an 8-byte little-endian header length ``n``, then ``n`` bytes of
JSON (each tensor's ``dtype``, ``shape`` and ``data_offsets`` ``[begin,
end)`` relative to the end of the header, plus an optional ``__metadata__``
map of strings; the writer pads the JSON with spaces to a multiple of 8),
then the raw little-endian tensor bytes.

:class:`SafetensorsFile` maps a file with ``mmap`` and hands out tensors as
views of the mapping, so reading a shard makes no host copy of it: a loader
copies each tensor from the page cache straight to its destination.
:func:`save_file` writes tensors one at a time (each moved to the host only
while it is written). Six dtypes are handled: F32, F16, BF16, I8, I32 and
I64; any other dtype, a header that runs past the file, or a tensor whose
offsets fall outside the file or disagree with its shape raises
``ValueError``.
"""

from __future__ import annotations

import json
import mmap
import os
import struct
from typing import Dict, Iterable, Mapping, Optional, Tuple

import torch

#: safetensors dtype name -> (torch dtype, bytes per element).
DTYPES: Dict[str, Tuple[torch.dtype, int]] = {
    "F32": (torch.float32, 4),
    "F16": (torch.float16, 2),
    "BF16": (torch.bfloat16, 2),
    "I8": (torch.int8, 1),
    "I32": (torch.int32, 4),
    "I64": (torch.int64, 8),
}
_NAMES = {dt: name for name, (dt, _) in DTYPES.items()}
# Integer types of each width: the mapping's bytes are read as these and
# then viewed as the stored dtype (BF16 as int16, then ``.view(bfloat16)``).
_RAW = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}


class SafetensorsFile:
    """One safetensors file, mapped read-only (copy-on-write, so the views
    are writable without touching the file). ``keys()`` lists the tensors,
    ``get_tensor(key)`` returns a CPU tensor viewing the mapping, and
    ``metadata`` is the header's ``__metadata__`` (empty when absent). The
    mapping lives as long as the object or any tensor taken from it."""

    def __init__(self, path: str):
        self.path = path
        with open(path, "rb") as f:
            size = os.fstat(f.fileno()).st_size
            if size < 8:
                raise ValueError(f"{path}: {size} bytes is too short for a safetensors header")
            self._map = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY)
        (n,) = struct.unpack("<Q", self._map[:8])
        if 8 + n > size:
            raise ValueError(f"{path}: header of {n} bytes runs past the file ({size} bytes)")
        try:
            header = json.loads(bytes(self._map[8: 8 + n]))
        except ValueError as e:
            raise ValueError(f"{path}: unreadable header: {e}") from None
        self._base = 8 + n
        self.metadata: Dict[str, str] = header.pop("__metadata__", None) or {}
        data_len = size - self._base
        self._entries: Dict[str, Tuple[torch.dtype, int, Tuple[int, ...], int, int]] = {}
        for key, info in header.items():
            name = info.get("dtype")
            if name not in DTYPES:
                raise ValueError(f"{path}: tensor {key!r} has unsupported dtype {name!r}")
            dtype, itemsize = DTYPES[name]
            shape = tuple(int(d) for d in info["shape"])
            begin, end = (int(o) for o in info["data_offsets"])
            numel = 1
            for d in shape:
                numel *= d
            if not 0 <= begin <= end <= data_len:
                raise ValueError(
                    f"{path}: tensor {key!r} offsets [{begin}, {end}) fall outside the "
                    f"{data_len} data bytes"
                )
            if end - begin != numel * itemsize:
                raise ValueError(
                    f"{path}: tensor {key!r} spans {end - begin} bytes, its shape {list(shape)} "
                    f"of {name} needs {numel * itemsize}"
                )
            self._entries[key] = (dtype, itemsize, shape, begin, end)

    def keys(self) -> Iterable[str]:
        return list(self._entries)

    def shape(self, key: str) -> Tuple[int, ...]:
        return self._entries[key][2]

    def dtype(self, key: str) -> torch.dtype:
        return self._entries[key][0]

    def get_tensor(self, key: str) -> torch.Tensor:
        """The tensor ``key`` as a CPU view of the mapped file (no copy)."""
        dtype, itemsize, shape, begin, end = self._entries[key]
        if end == begin:
            return torch.empty(shape, dtype=dtype)
        raw = torch.frombuffer(self._map, dtype=_RAW[itemsize], count=(end - begin) // itemsize,
                               offset=self._base + begin)
        return raw.view(dtype).reshape(shape)


def _header(tensors: Mapping[str, torch.Tensor], metadata: Optional[Mapping[str, str]]):
    """(header bytes padded to 8, ordered keys): tensors laid out widest
    dtype first, then by name, so every tensor starts on a multiple of its
    element size."""
    order = sorted(tensors, key=lambda k: (-tensors[k].element_size(), k))
    header: Dict[str, object] = {}
    if metadata:
        header["__metadata__"] = {str(k): str(v) for k, v in metadata.items()}
    offset = 0
    for key in order:
        t = tensors[key]
        if t.dtype not in _NAMES:
            raise ValueError(f"tensor {key!r}: dtype {t.dtype} has no safetensors name here")
        nbytes = t.numel() * t.element_size()
        header[key] = {"dtype": _NAMES[t.dtype], "shape": list(t.shape),
                       "data_offsets": [offset, offset + nbytes]}
        offset += nbytes
    raw = json.dumps(header, separators=(",", ":")).encode("utf-8")
    raw += b" " * (-len(raw) % 8)
    return raw, order


def save_file(tensors: Mapping[str, torch.Tensor], path: str,
              metadata: Optional[Mapping[str, str]] = None) -> int:
    """Write ``tensors`` (on any device) as one safetensors file; each is
    moved to the host only while it is written. Returns the bytes written."""
    raw, order = _header(tensors, metadata)
    written = 8 + len(raw)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(raw)))
        f.write(raw)
        for key in order:
            t = tensors[key].detach()
            if t.numel() == 0:
                continue
            # Made contiguous where it lives (a card transposes its own
            # views), then moved: one tensor on the host at a time.
            host = t.contiguous().to("cpu").reshape(-1).view(torch.uint8)
            f.write(memoryview(host.numpy()))
            written += host.numel()
    return written
