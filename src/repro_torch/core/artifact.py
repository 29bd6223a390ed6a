"""DictArtifact — the train-once dictionary as a first-class storage object.

The paper's economics (§3.2–3.3) are train-once / use-many: one sequential
training pass produces a dictionary that then serves millions of independent
per-string encodes and decodes. Compressed string dictionaries in the
literature are likewise *storage artifacts* opened independently of training
(LZ-compressed string dictionaries, RLZ web-collection dictionaries), so the
dictionary here is an immutable, serializable value — not hidden mutable
state inside a compressor object.

On-disk container (shared by :class:`DictArtifact` and the corpus/store
persistence in :mod:`repro_torch.core.api` / :mod:`repro_torch.store.store`;
the bytes are the JAX package's, so either package opens what the other
wrote):

    magic  b"RPROART1"            (8 bytes)
    u32    container version
    u32    header length H
    bytes  header JSON            (codec name, config, stats, array table)
    pad    to 64-byte alignment
    data   arrays, each 64-byte aligned, raw little-endian

Array offsets in the header are *relative to the data region*, so the header
bytes are independent of their own length, and every array can be mapped
read-only straight off disk (``mmap=True`` load path) — opening a multi-MiB
dictionary costs page mapping, not parsing.
"""

from __future__ import annotations

import io
import json
import os
from dataclasses import dataclass, field
from functools import cached_property

import numpy as np

MAGIC = b"RPROART1"
CONTAINER_VERSION = 1
FORMAT_VERSION = 1  # DictArtifact schema version (header["format_version"])
_ALIGN = 64


def _aligned(n: int) -> int:
    return (n + _ALIGN - 1) // _ALIGN * _ALIGN


# --------------------------------------------------------------- container IO
def write_container(path: str, header: dict, arrays: dict[str, np.ndarray]) -> None:
    """Write one header + named-array container (atomic via temp rename)."""
    data = dump_container(header, arrays)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(data)
    os.replace(tmp, path)


def dump_container(header: dict, arrays: dict[str, np.ndarray]) -> bytes:
    contig = {name: np.ascontiguousarray(a) for name, a in arrays.items()}
    table: dict[str, dict] = {}
    rel = 0
    for name, a in contig.items():
        table[name] = {"dtype": a.dtype.str, "shape": list(a.shape),
                       "offset": rel, "nbytes": int(a.nbytes)}
        rel = _aligned(rel + a.nbytes)
    full_header = dict(header)
    full_header["arrays"] = table
    hjson = json.dumps(full_header, sort_keys=True).encode()
    data_start = _aligned(len(MAGIC) + 8 + len(hjson))
    buf = io.BytesIO()
    buf.write(MAGIC)
    buf.write(np.uint32(CONTAINER_VERSION).tobytes())
    buf.write(np.uint32(len(hjson)).tobytes())
    buf.write(hjson)
    buf.write(b"\0" * (data_start - buf.tell()))
    for name, a in contig.items():
        buf.write(b"\0" * (data_start + table[name]["offset"] - buf.tell()))
        buf.write(a.tobytes())
    out = buf.getvalue()
    return out + b"\0" * (_aligned(len(out)) - len(out))


def read_container(path: str, mmap: bool = True) -> tuple[dict, dict[str, np.ndarray]]:
    """Read a container; with ``mmap=True`` arrays are read-only disk maps."""
    if not mmap:
        with open(path, "rb") as f:
            return load_container(f.read())
    with open(path, "rb") as f:
        head = f.read(len(MAGIC) + 8)
        if head[: len(MAGIC)] != MAGIC:
            raise ValueError(f"{path}: not a repro artifact container")
        hlen = int(np.frombuffer(head[len(MAGIC) + 4 :], dtype="<u4")[0])
        header = json.loads(f.read(hlen).decode())
    data_start = _aligned(len(MAGIC) + 8 + hlen)
    arrays: dict[str, np.ndarray] = {}
    for name, at in header.pop("arrays").items():
        if at["nbytes"] == 0:  # mmap cannot map zero bytes
            arrays[name] = np.zeros(at["shape"], dtype=np.dtype(at["dtype"]))
            continue
        arrays[name] = np.memmap(path, dtype=np.dtype(at["dtype"]), mode="r",
                                 offset=data_start + at["offset"],
                                 shape=tuple(at["shape"]))
    return header, arrays


def load_container(data: bytes) -> tuple[dict, dict[str, np.ndarray]]:
    if data[: len(MAGIC)] != MAGIC:
        raise ValueError("not a repro artifact container")
    hlen = int(np.frombuffer(data[len(MAGIC) + 4 : len(MAGIC) + 8], dtype="<u4")[0])
    header = json.loads(data[len(MAGIC) + 8 : len(MAGIC) + 8 + hlen].decode())
    data_start = _aligned(len(MAGIC) + 8 + hlen)
    arrays: dict[str, np.ndarray] = {}
    for name, at in header.pop("arrays").items():
        a = np.frombuffer(data, dtype=np.dtype(at["dtype"]),
                          count=at["nbytes"] // np.dtype(at["dtype"]).itemsize,
                          offset=data_start + at["offset"])
        arrays[name] = a.reshape(at["shape"])
    return header, arrays


# ----------------------------------------------------------------- DictArtifact
@dataclass(frozen=True)
class DictArtifact:
    """Immutable, serializable dictionary: token table + config + version.

    A store's ``artifact`` produces one; :class:`~repro_torch.core.codec.Encoder`
    / :class:`~repro_torch.core.codec.Decoder` consume one — on any host,
    without retraining. The port's kernels take ``"onpair16"`` artifacts;
    every other codec's runs on its host codec (``registry``).
    """

    codec: str                                  # codec name, e.g. "onpair16"
    config: dict = field(default_factory=dict)  # codec construction config
    arrays: dict = field(default_factory=dict)  # "blob" u8 + "offsets" u32
    stats: dict = field(default_factory=dict)   # train-time stats (informational)
    version: int = FORMAT_VERSION

    # ------------------------------------------------------------ constructors
    @classmethod
    def from_entries(cls, codec: str, entries: list[bytes],
                     config: dict | None = None,
                     stats: dict | None = None) -> "DictArtifact":
        arrays: dict[str, np.ndarray] = {}
        if entries:
            lens = np.fromiter((len(e) for e in entries), dtype=np.int64,
                               count=len(entries))
            offsets = np.zeros(len(entries) + 1, dtype=np.uint32)
            np.cumsum(lens, out=offsets[1:])
            arrays["blob"] = np.frombuffer(b"".join(entries), dtype=np.uint8)
            arrays["offsets"] = offsets
        return cls(codec=codec, config=dict(config or {}), arrays=arrays,
                   stats=dict(stats or {}))

    @classmethod
    def from_config(cls, codec: str, config: dict | None = None) -> "DictArtifact":
        return cls(codec=codec, config=dict(config or {}))

    # --------------------------------------------------------------- accessors
    @cached_property
    def entries(self) -> list[bytes]:
        """The token table as a list of byte strings (ids = positions)."""
        if "blob" not in self.arrays:
            return []
        raw = np.asarray(self.arrays["blob"]).tobytes()
        off = self.arrays["offsets"]
        return [raw[int(off[i]) : int(off[i + 1])] for i in range(len(off) - 1)]

    @property
    def num_entries(self) -> int:
        return max(0, len(self.arrays.get("offsets", ())) - 1)

    @property
    def data_bytes(self) -> int:
        """Raw bytes of all table entries (paper Table 4 'Data')."""
        blob = self.arrays.get("blob")
        return int(blob.size) if blob is not None else 0

    # ------------------------------------------------------------- persistence
    def _header(self) -> dict:
        return {"kind": "dict_artifact", "format_version": self.version,
                "codec": self.codec, "config": self.config, "stats": self.stats}

    def save(self, path: str) -> None:
        """Write the artifact to ``path`` (compact aligned binary container)."""
        write_container(path, self._header(), self.arrays)

    def to_bytes(self) -> bytes:
        return dump_container(self._header(), self.arrays)

    @classmethod
    def _from_parsed(cls, header: dict, arrays: dict) -> "DictArtifact":
        if header.get("kind") != "dict_artifact":
            raise ValueError(f"container holds {header.get('kind')!r}, "
                             "not a dict_artifact")
        return cls(codec=header["codec"], config=header.get("config", {}),
                   arrays=arrays, stats=header.get("stats", {}),
                   version=header.get("format_version", FORMAT_VERSION))

    @classmethod
    def load(cls, path: str, mmap: bool = True) -> "DictArtifact":
        header, arrays = read_container(path, mmap=mmap)
        return cls._from_parsed(header, arrays)

    @classmethod
    def from_bytes(cls, data: bytes) -> "DictArtifact":
        header, arrays = load_container(data)
        return cls._from_parsed(header, arrays)
