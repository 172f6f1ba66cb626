"""ctypes binding for the shared-memory slot ring (``csrc/shm_ring.cc``).

Counterpart of ``paddle_tpu/io/shm_ring.py``, with the same slot wire
format and the same C interface.  DataLoader workers serialize each batch
with pickle protocol 5 and ship the bulk array buffers out of band through
a shm slot: the pickle stream holds only structure and small scalars, every
ndarray payload is one memcpy into shared memory.  A batch that does not
fit a slot goes by queue pickling (:meth:`ShmRing.put` returns None).

Slot wire format: [u64 pickle_len][pickle bytes][u64 nbuf]
                  ([u64 buf_len][raw bytes]) * nbuf

One change from the reference: the ring reserves its pages when it is made
(``posix_fallocate``), and :meth:`ShmRing.create` raises OSError when they
do not fit ``/dev/shm``, where the reference's ring was made and its first
write past the free space died with SIGBUS.
"""

from __future__ import annotations

import ctypes
import os
import pickle
import struct
from typing import Optional

_LIB = None
_LIB_PATH: Optional[str] = None
_BUILD_ERR: Optional[str] = None


def _source_path() -> str:
    return os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "csrc", "shm_ring.cc")


def _build() -> Optional[str]:
    """Compile (content-hash cached) and return the .so path, or None when
    there is no compiler or the compile fails; a failed build is not
    retried in this process."""
    global _BUILD_ERR
    if _BUILD_ERR is not None:
        return None
    from ..utils.cpp_extension import compile_cached

    try:
        return compile_cached("shm_ring", [_source_path()],
                              extra_ldflags=["-lrt"])
    except (RuntimeError, OSError) as e:  # no g++ / compile failure
        _BUILD_ERR = str(e)[-1000:]
        return None


def _bind(path: str):
    lib = ctypes.CDLL(path, use_errno=True)
    lib.srb_create.restype = ctypes.c_void_p
    lib.srb_create.argtypes = [ctypes.c_char_p, ctypes.c_uint32,
                               ctypes.c_uint64]
    lib.srb_attach.restype = ctypes.c_void_p
    lib.srb_attach.argtypes = [ctypes.c_char_p]
    lib.srb_acquire.restype = ctypes.c_int
    lib.srb_acquire.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.srb_data.restype = ctypes.POINTER(ctypes.c_ubyte)
    lib.srb_data.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.srb_slot_bytes.restype = ctypes.c_uint64
    lib.srb_slot_bytes.argtypes = [ctypes.c_void_p]
    lib.srb_nslots.restype = ctypes.c_uint32
    lib.srb_nslots.argtypes = [ctypes.c_void_p]
    lib.srb_release.restype = None
    lib.srb_release.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.srb_close.restype = None
    lib.srb_close.argtypes = [ctypes.c_void_p]
    lib.srb_unlink.restype = None
    lib.srb_unlink.argtypes = [ctypes.c_char_p]
    return lib


def get_lib(path: Optional[str] = None):
    """Load (building if needed) the ring library; None if unavailable."""
    global _LIB, _LIB_PATH
    if _LIB is not None:
        return _LIB
    p = path or _LIB_PATH or _build()
    if p is None:
        return None
    try:
        _LIB = _bind(p)
        _LIB_PATH = p
    except OSError:
        return None
    return _LIB


def lib_path() -> Optional[str]:
    """The built .so path (for handing to spawned workers)."""
    if _LIB_PATH is None:
        get_lib()
    return _LIB_PATH


class ShmRing:
    """One shm slot arena (any number of producers, one consumer)."""

    def __init__(self, name: str, handle, lib, owner: bool):
        self.name = name
        self._h = handle
        self._lib = lib
        self._owner = owner
        self.slot_bytes = int(lib.srb_slot_bytes(handle))

    # -- lifecycle --------------------------------------------------------
    @classmethod
    def create(cls, name: str, nslots: int, slot_bytes: int,
               lib=None) -> Optional["ShmRing"]:
        """A new arena of ``nslots`` slots of ``slot_bytes``; None when the
        library is unavailable.  Raises OSError when the arena cannot be
        made, ENOSPC when its pages do not fit ``/dev/shm``."""
        lib = lib or get_lib()
        if lib is None:
            return None
        h = lib.srb_create(name.encode(), nslots, slot_bytes)
        if not h:
            err = ctypes.get_errno()
            raise OSError(err, f"cannot make the shared-memory ring {name} "
                          f"({nslots} slots of {slot_bytes} bytes): "
                          f"{os.strerror(err)}")
        return cls(name, h, lib, owner=True)

    @classmethod
    def attach(cls, name: str, so_path: Optional[str] = None
               ) -> Optional["ShmRing"]:
        lib = get_lib(so_path)
        if lib is None:
            return None
        h = lib.srb_attach(name.encode())
        return cls(name, h, lib, owner=False) if h else None

    def close(self):
        if self._h:
            self._lib.srb_close(self._h)
            if self._owner:
                self._lib.srb_unlink(self.name.encode())
            self._h = None

    # -- transport --------------------------------------------------------
    def put(self, obj, timeout_ms: int = 10000) -> Optional[int]:
        """Serialize ``obj`` into a free slot; returns the slot index, or
        None when the payload does not fit or no slot frees up in time (the
        caller then pickles it through the queue)."""
        try:
            bufs = []
            pick = pickle.dumps(obj, protocol=5, buffer_callback=bufs.append)
            views = [b.raw() for b in bufs]
        except (BufferError, pickle.PicklingError):
            return None  # non-contiguous / unpicklable: queue instead
        total = (8 + len(pick) + 8
                 + sum(8 + v.nbytes for v in views))
        if total > self.slot_bytes:
            return None
        slot = self._lib.srb_acquire(self._h, timeout_ms)
        if slot < 0:
            return None
        dst = self._lib.srb_data(self._h, slot)
        mv = memoryview(ctypes.cast(
            dst, ctypes.POINTER(ctypes.c_ubyte * self.slot_bytes)).contents
        ).cast("B")
        off = 0
        mv[off:off + 8] = struct.pack("<Q", len(pick))
        off += 8
        mv[off:off + len(pick)] = pick
        off += len(pick)
        mv[off:off + 8] = struct.pack("<Q", len(views))
        off += 8
        for v in views:
            flat = v.cast("B") if v.ndim != 1 or v.format != "B" else v
            n = flat.nbytes
            mv[off:off + 8] = struct.pack("<Q", n)
            off += 8
            mv[off:off + n] = flat
            off += n
        return slot

    def release(self, slot: int):
        """Free ``slot`` without deserializing it (stale-message discard)."""
        self._lib.srb_release(self._h, slot)

    def get(self, slot: int):
        """Deserialize the object in ``slot`` and free the slot."""
        src = self._lib.srb_data(self._h, slot)
        mv = memoryview(ctypes.cast(
            src, ctypes.POINTER(ctypes.c_ubyte * self.slot_bytes)).contents
        ).cast("B")
        try:
            off = 0
            (plen,) = struct.unpack_from("<Q", mv, off)
            off += 8
            pick = bytes(mv[off:off + plen])
            off += plen
            (nbuf,) = struct.unpack_from("<Q", mv, off)
            off += 8
            bufs = []
            for _ in range(nbuf):
                (n,) = struct.unpack_from("<Q", mv, off)
                off += 8
                # copied out, so the slot recycles at once, into a
                # bytearray: the arrays rebuilt from it are writeable, as
                # those pickled through the queue are
                bufs.append(bytearray(mv[off:off + n]))
                off += n
            return pickle.loads(pick, buffers=bufs)
        finally:
            del mv
            self._lib.srb_release(self._h, slot)
