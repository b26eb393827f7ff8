"""On-disk compiled-program cache: the restart-warm layer of recovery.

Port of ``foundationdb_tpu/core/progcache.py``: the same keys, file format
(`FBPC` magic, one crc frame, tmp + atomic rename), verify-before-publish,
quarantine of a poisoned entry, `stats` keys, process-global installation
and knob selection. A restarted, failed-over or spare resolver asks the
cache before it builds a (bucket, scan-size) program, and a build is
stored back so the next restart can load it.

What a port program is, and why nothing of it loads today: on the card a
program (ops/host_engine.py `_Program`, ops/device_loop.py `_LoopProgram`)
is up to two captured CUDA graphs over its engine's static buffers. CUDA
has no serialized form of an instantiated graph (torch.cuda.CUDAGraph
offers a DOT `debug_dump` only), and a graph is bound to the buffers of
the engine that captured it. So `serialize_program` refuses every port
program: `store` counts the build under `errors` and publishes nothing
(the reference's path for a program that will not serialize), `load`
misses, and the engine captures as it would without the cache. A hit
can therefore never hand back a graph bound to another engine's
buffers. `load_program`, the decode step, refuses any payload for the
same reason, so an entry planted in the directory is quarantined, never
run. The nvcc-built kernel libraries are cached apart from
this, by source hash (native/build.py `_build/`).

Keying: `(backend fingerprint, engine kind, bucket, n_chunks, search
mode, dispatch mode)` plus the mesh, variant and history-structure
fingerprints — the tuple the perf ledger files builds under. The backend
fingerprint folds in torch's and CUDA's versions, the card's name and
compute capability and the visible device count ("cpu" for a CPU
engine), so an artifact of another toolchain or card never loads: a
stale key is a clean miss.

Cost discipline: no cache installed = one list-index check in
`_build_and_record`; hits/misses/bytes are filed through the engine's
perf ledger (core/perfledger.py `record_progcache`), NOT the compile
counters.
"""
from __future__ import annotations

import hashlib
import os
import pickle
import struct
import time
import zlib
from typing import Any, Dict, List, Optional

#: entry file header: magic + format version
MAGIC = b"FBPC"
FORMAT_VERSION = 1
_HEADER = MAGIC + bytes([FORMAT_VERSION])
#: per-entry frame: little-endian (payload length, crc32 of payload)
_FRAME = struct.Struct("<II")


def backend_fingerprint(device=None) -> str:
    """The toolchain + device identity a built artifact is only valid
    for: torch's version, CUDA's, the card's name and compute capability
    and the visible device count — or "cpu" for a CPU engine (`device` a
    CPU torch.device) or a process without a card. Folded into every
    cache key so a toolchain upgrade or another card turns every entry
    into a clean miss, never a wrong-artifact load."""
    import torch

    if (device is not None and torch.device(device).type != "cuda") \
            or not torch.cuda.is_available():
        return "|".join((torch.__version__, "cpu"))
    idx = torch.device(device).index if device is not None else None
    idx = torch.cuda.current_device() if idx is None else idx
    major, minor = torch.cuda.get_device_capability(idx)
    return "|".join((torch.__version__, f"cuda{torch.version.cuda}",
                     torch.cuda.get_device_name(idx), f"sm{major}{minor}",
                     f"ndev{torch.cuda.device_count()}"))


def serialize_program(prog):
    """(payload, in_tree, out_tree) of a built program — the triple the
    reference's serialize_executable gives. A port program is captured
    CUDA graphs over its engine's static buffers, and CUDA has no
    serialized form of an instantiated graph: this raises TypeError for
    every program, and `store` counts the build under `errors`."""
    raise TypeError(f"a {type(prog).__name__} cannot be written to disk: CUDA has no "
                    "serialized form of an instantiated graph, and a graph is bound to the "
                    "static buffers of the engine that captured it")


def load_program(payload, in_tree, out_tree):
    """The decode half: a callable program from a serialized triple. No
    port program has a serialized form (`serialize_program`), so this
    raises for any payload: `load` quarantines the entry and misses."""
    raise ValueError(f"a {in_tree} cannot be loaded from disk: CUDA has no serialized "
                     "form of an instantiated graph")


class ProgramCache:
    """Content-addressed directory of serialized built programs."""

    def __init__(self, directory: str, disk: Optional[Any] = None):
        self.directory = str(directory)
        os.makedirs(self.directory, exist_ok=True)
        #: optional DiskFaults hook (fault/inject.py) — the nemesis'
        #: entry point into the cache's writes
        self.disk = disk
        self.stats: Dict[str, Any] = {
            "hits": 0, "misses": 0, "stores": 0, "poisoned": 0,
            "unverifiable": 0, "errors": 0, "hit_bytes": 0,
            "store_bytes": 0, "load_ms": 0.0, "store_ms": 0.0,
        }

    # -- keying ---------------------------------------------------------------
    def key(self, *, engine: str, bucket: int, n_chunks: int,
            search_mode: str, dispatch_mode: str, mesh: str = "",
            variant: str = "", structure: str = "", device=None) -> str:
        """`mesh` is the engine's sharding-layout fingerprint
        (RoutedConflictEngineBase._progcache_fingerprint): "" for the
        single-device families, "mesh:<S>/<ndev>"-shaped for engines whose
        programs bake a device mesh — two engines whose programs differ
        only in mesh topology must never share an entry. `variant` names
        one program of a multi-program dispatch unit (the mesh engine's
        split "scan" / "exchange" pair under one (bucket, n_chunks)).
        `structure` is the history-structure fingerprint
        (RoutedConflictEngineBase._history_fingerprint): "" for the
        monolithic table (so pre-existing entries keep their hashes),
        "tiered:<runs>x<rows>"-shaped when the program bakes the tiered
        sorted-run planes — a structure flip must be a clean miss, never
        a poisoned hit against mismatched state trees. `device` is the
        engine's torch.device (backend_fingerprint)."""
        blob = "|".join(map(str, (backend_fingerprint(device), engine, bucket,
                                  n_chunks, search_mode, dispatch_mode,
                                  mesh, variant)))
        if structure:
            blob += "|" + structure
        return hashlib.sha256(blob.encode()).hexdigest()[:40]

    def _path(self, key: str) -> str:
        return os.path.join(self.directory, f"{key}.prog")

    # -- load -----------------------------------------------------------------
    def load(self, key: str):
        """The loaded, immediately-callable program for `key`, or None
        (miss). Any corruption — bad magic, torn frame, crc mismatch,
        deserialize failure — quarantines the entry (unlinks it, counts
        `poisoned`) and reports a miss: the caller compiles."""
        path = self._path(key)
        t0 = time.perf_counter()
        try:
            with open(path, "rb") as f:
                data = f.read()
        except OSError:
            self.stats["misses"] += 1
            return None
        try:
            prog = self._decode(data)
        except Exception:                       # poisoned entry, any shape
            self.stats["poisoned"] += 1
            self.stats["misses"] += 1
            try:
                os.remove(path)
            except OSError:
                pass
            return None
        self.stats["hits"] += 1
        self.stats["hit_bytes"] += len(data)
        self.stats["load_ms"] += (time.perf_counter() - t0) * 1e3
        return prog

    @staticmethod
    def _decode(data: bytes):
        if len(data) < len(_HEADER) + _FRAME.size or \
                data[:len(_HEADER)] != _HEADER:
            raise ValueError("bad progcache header")
        length, crc = _FRAME.unpack_from(data, len(_HEADER))
        raw = data[len(_HEADER) + _FRAME.size:
                   len(_HEADER) + _FRAME.size + length]
        if len(raw) != length or zlib.crc32(raw) != crc:
            raise ValueError("torn or rotted progcache entry")
        payload, in_tree, out_tree = pickle.loads(raw)
        return load_program(payload, in_tree, out_tree)

    # -- store ----------------------------------------------------------------
    def store(self, key: str, compiled) -> bool:
        """Serialize `compiled` under `key` (tmp + atomic rename). Never
        raises: a full disk, an unserializable program or an injected
        disk fault degrade to a future build, not a crash.

        Every artifact is VERIFIED by decoding it back before it is
        published: an entry that does not load would poison every future
        restart's rewarm. An unverifiable artifact is counted and dropped
        (the next boot builds). No port program gets this far: a captured
        CUDA graph does not serialize (`serialize_program`). Verification runs on the pre-fault bytes, so injected bit rot is
        still discovered at read time by the crc, the quarantine path the
        nemesis exercises."""
        t0 = time.perf_counter()
        try:
            payload, in_tree, out_tree = serialize_program(compiled)
            raw = pickle.dumps((payload, in_tree, out_tree))
        except Exception:
            self.stats["errors"] += 1
            return False
        data = _HEADER + _FRAME.pack(len(raw), zlib.crc32(raw)) + raw
        try:
            self._decode(data)
        except Exception:
            self.stats["unverifiable"] += 1
            self.stats["errors"] += 1
            return False
        path = self._path(key)
        tmp = path + ".tmp"
        try:
            if self.disk is not None:
                data = self.disk.apply("progcache", data)
            with open(tmp, "wb") as f:
                f.write(data)
            os.replace(tmp, path)
        except OSError:
            self.stats["errors"] += 1
            try:
                os.remove(tmp)
            except OSError:
                pass
            return False
        self.stats["stores"] += 1
        self.stats["store_bytes"] += len(data)
        self.stats["store_ms"] += (time.perf_counter() - t0) * 1e3
        return True

    # -- read model -----------------------------------------------------------
    def entries(self) -> List[str]:
        try:
            return sorted(n for n in os.listdir(self.directory)
                          if n.endswith(".prog"))
        except OSError:
            return []

    def summary(self) -> dict:
        s = dict(self.stats)
        s["load_ms"] = round(s["load_ms"], 3)
        s["store_ms"] = round(s["store_ms"], 3)
        return {"dir": self.directory, "entries": len(self.entries()), **s}


# -- process-global installation ----------------------------------------------
#: the one installed cache (None = disabled: `_build_and_record` pays one
#: list-index check and builds exactly as before)
_g: List[Optional[ProgramCache]] = [None]


def enabled() -> bool:
    return _g[0] is not None


def active() -> Optional[ProgramCache]:
    return _g[0]


def install(cache: ProgramCache) -> ProgramCache:
    _g[0] = cache
    return cache


def uninstall() -> Optional[ProgramCache]:
    c, _g[0] = _g[0], None
    return c


def knob_directory() -> Optional[str]:
    """The cache directory the `resolver_progcache` knob selects: None
    when off ("" / "off"); `resolver_progcache_dir` when "on"; any other
    value is itself the directory (the resolver_blackbox pattern)."""
    from .knobs import SERVER_KNOBS

    sel = str(SERVER_KNOBS.resolver_progcache or "").strip()
    if not sel or sel.lower() == "off":
        return None
    return (str(SERVER_KNOBS.resolver_progcache_dir)
            if sel.lower() == "on" else sel)


def cache_from_knobs(disk: Optional[Any] = None) -> Optional[ProgramCache]:
    directory = knob_directory()
    if directory is None:
        return None
    return ProgramCache(directory, disk=disk)
