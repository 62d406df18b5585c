"""Same-host shared-memory ring for broker↔client tensor transfer (port of
``analytics_zoo_tpu/serving/shm.py``, which needs no JAX: a copy, so the JAX
broker and the port's negotiate a ring with each other's clients).

When both ends of a serving connection live on one host, large tensor buffers
do not need to cross the socket at all: the sender places the bytes in a
``multiprocessing.shared_memory`` segment and the binary frame (wire.py)
carries only ``(offset, nbytes)``. The segment is created by the CLIENT side
of a connection and split into two half-duplex rings:

    [0, size/2)        client writes, broker reads   (requests)
    [size/2, size)     broker writes, client reads   (results)

Negotiation: the client sends the JSON control message
``["SHMOPEN", name, size, host_identity]``; a broker that can attach AND
whose own :func:`host_identity` matches the client's replies ``"OK"`` and
both sides start placing large buffers in their ring. Any failure — remote
broker, a containerized peer with its own ``/dev/shm`` (identity mismatch),
``/dev/shm`` unavailable, an old broker answering ``{"error": ...}`` —
simply leaves the connection on the socket path (fallback-to-socket rule:
shm is an optimisation, never a requirement; see docs/serving_protocol.md).
Three-element ``SHMOPEN`` from older clients keeps the legacy attach-only
check.

Ring discipline: the serving protocol is strict request/response per
connection (the client lock serialises calls), so at most one message is in
flight per direction. Each message therefore resets its ring cursor to zero
and allocates sequentially; a buffer that does not fit in the ring falls back
to inline socket bytes (per-buffer, not per-message). No reader/writer
synchronisation is needed beyond the protocol's own alternation.
"""

from __future__ import annotations

import os
import secrets
from typing import Optional

DEFAULT_SEGMENT_BYTES = int(os.environ.get("ZOO_SERVING_SHM_BYTES",
                                           str(16 * 1024 * 1024)))
# buffers below this ride inline on the socket (header+copy cost beats a ring
# round trip for small tensors)
MIN_SHM_BUFFER_BYTES = int(os.environ.get("ZOO_SERVING_SHM_MIN_BYTES",
                                          str(64 * 1024)))


def shm_enabled() -> bool:
    return os.environ.get("ZOO_SERVING_SHM", "1") != "0"


def host_identity() -> str:
    """A token that is equal iff two processes share a kernel (and therefore
    a ``/dev/shm``). The boot id distinguishes containers and distinct
    machines even when hostnames collide (two pods both named ``localhost``);
    hostname is the fallback on kernels without it. ``ZOO_HOST_IDENTITY``
    overrides for tests and for deployments that KNOW two namespaces share an
    IPC mount."""
    env = os.environ.get("ZOO_HOST_IDENTITY")
    if env:
        return env
    try:
        with open("/proc/sys/kernel/random/boot_id") as f:
            return f.read().strip()
    except OSError:
        import socket

        return socket.gethostname()


def _shared_memory():
    from multiprocessing import shared_memory

    return shared_memory


# segments created by THIS process — attach() must not unregister those from
# the resource tracker (the creator's registration is the one that garbage-
# collects a leaked segment), only segments created by a peer process
_OWNED_NAMES: set = set()


class ShmChannel:
    """One end of the half-duplex ring pair inside a shared segment."""

    def __init__(self, seg, tx_base: int, tx_size: int,
                 rx_base: int, rx_size: int, owner: bool):
        self._seg = seg
        self._tx_base, self._tx_size = tx_base, tx_size
        self._rx_base, self._rx_size = rx_base, rx_size
        self._owner = owner
        self._cursor = 0
        self.min_buffer_bytes = MIN_SHM_BUFFER_BYTES

    # -- construction ---------------------------------------------------------
    @classmethod
    def create(cls, size: int = DEFAULT_SEGMENT_BYTES) -> "ShmChannel":
        """Client side: create the segment; tx = first half."""
        shared_memory = _shared_memory()
        name = f"zoo_serve_{secrets.token_hex(8)}"
        seg = shared_memory.SharedMemory(name=name, create=True, size=size)
        _OWNED_NAMES.add(seg.name)
        half = size // 2
        return cls(seg, 0, half, half, size - half, owner=True)

    @classmethod
    def attach(cls, name: str, size: int) -> "ShmChannel":
        """Broker side: attach to a client-created segment; tx = second half."""
        shared_memory = _shared_memory()
        seg = shared_memory.SharedMemory(name=name)
        # Python <3.13 registers attached segments with the resource tracker,
        # which unlinks them when THIS process exits — stealing the segment
        # from its owner. Unregister (unless WE created it in-process: then
        # the registration belongs to the creator-side unlink).
        if seg.name not in _OWNED_NAMES:
            try:
                from multiprocessing import resource_tracker

                resource_tracker.unregister(seg._name, "shared_memory")
            except Exception:
                pass
        half = size // 2
        return cls(seg, half, size - half, 0, half, owner=False)

    @property
    def name(self) -> str:
        return self._seg.name

    @property
    def size(self) -> int:
        return self._seg.size

    # -- ring I/O -------------------------------------------------------------
    def begin_message(self) -> None:
        """The previous message in this direction is fully consumed (protocol
        alternation guarantees it), so the whole ring is free again."""
        self._cursor = 0

    def try_write(self, mv: memoryview) -> Optional[int]:
        """Place ``mv`` in this end's tx ring; returns the absolute segment
        offset, or None when the buffer is too small to benefit or too large
        to fit (caller sends it inline)."""
        n = len(mv)
        if n < self.min_buffer_bytes or self._cursor + n > self._tx_size:
            return None
        off = self._tx_base + self._cursor
        self._seg.buf[off:off + n] = mv
        self._cursor += n
        return off

    def read(self, off: int, nbytes: int) -> memoryview:
        """View ``nbytes`` at absolute offset ``off`` (the peer's tx ring).
        The caller must copy out before its next send (wire.recv_msg does)."""
        if off < 0 or off + nbytes > self._seg.size:
            raise ValueError(f"shm read [{off}, {off + nbytes}) outside "
                             f"segment of {self._seg.size} bytes")
        return self._seg.buf[off:off + nbytes]

    # -- lifecycle ------------------------------------------------------------
    def close(self) -> None:
        try:
            self._seg.close()
        except (OSError, BufferError):
            pass
        if self._owner:
            try:
                self._seg.unlink()
            except (OSError, FileNotFoundError):
                pass
            _OWNED_NAMES.discard(self._seg.name)
