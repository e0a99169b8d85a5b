"""Native (C++) runtime: ring buffer, IQ file IO, threaded block pipeline.

Equivalents of the reference's runtime-side components:

* :class:`CircularBuffer` — reference ``src/circular_buffer/mod.rs:55-628``
  (push/append/pop/release/linearized read + over/underflow errors), here a
  lock-free C++ SPSC ring sized in samples of any numpy dtype.
* :class:`IQFile` / :func:`read_iq` / :func:`write_iq` — IQ recordings in
  the common SDR interleaved formats (cf32, ci16, ci8, cf64), converted to
  complex64 in native code.
* :class:`StreamPump` — a C++ reader thread that prefetches and converts
  file blocks into the ring while the Python/JAX consumer computes: the
  host-side half of a double-buffered block pipeline feeding the device.

The compute path stays JAX/XLA; this layer keeps the host IO off the
critical path, which is what the reference's mutable-state streaming objects
did implicitly by being embedded in the caller's thread.
"""

from __future__ import annotations

import ctypes as C
import os

import numpy as np

from .build import ensure_built

__all__ = [
    "CircularBuffer", "BufferError_", "StreamPump", "UdpSource",
    "TcpSource", "RtlTcpSource", "read_iq", "write_iq",
    "IQ_FORMATS",
]

IQ_FORMATS = {"cf32": 0, "ci16": 1, "ci8": 2, "cf64": 3, "cu8": 4}

_lib = C.CDLL(ensure_built())

_lib.sdsp_ring_create.restype = C.c_void_p
_lib.sdsp_ring_create.argtypes = [C.c_size_t]
_lib.sdsp_ring_destroy.argtypes = [C.c_void_p]
for _f in ("sdsp_ring_capacity", "sdsp_ring_size", "sdsp_ring_space"):
    getattr(_lib, _f).restype = C.c_size_t
    getattr(_lib, _f).argtypes = [C.c_void_p]
_lib.sdsp_ring_push.restype = C.c_size_t
_lib.sdsp_ring_push.argtypes = [C.c_void_p, C.c_void_p, C.c_size_t]
_lib.sdsp_ring_pop.restype = C.c_size_t
_lib.sdsp_ring_pop.argtypes = [C.c_void_p, C.c_void_p, C.c_size_t]
_lib.sdsp_ring_peek.restype = C.c_size_t
_lib.sdsp_ring_peek.argtypes = [C.c_void_p, C.c_void_p, C.c_size_t]
_lib.sdsp_ring_release.restype = C.c_size_t
_lib.sdsp_ring_release.argtypes = [C.c_void_p, C.c_size_t]
_lib.sdsp_ring_reset.argtypes = [C.c_void_p]
_lib.sdsp_iq_read.restype = C.c_long
_lib.sdsp_iq_read.argtypes = [C.c_char_p, C.c_int, C.c_long, C.c_long,
                              C.c_void_p]
_lib.sdsp_iq_write.restype = C.c_long
_lib.sdsp_iq_write.argtypes = [C.c_char_p, C.c_int, C.c_void_p, C.c_long,
                               C.c_int]
_lib.sdsp_pump_create.restype = C.c_void_p
_lib.sdsp_pump_create.argtypes = [C.c_char_p, C.c_int, C.c_size_t]
_lib.sdsp_pump_destroy.argtypes = [C.c_void_p]
_lib.sdsp_pump_next.restype = C.c_long
_lib.sdsp_pump_next.argtypes = [C.c_void_p, C.c_void_p, C.c_long]
_lib.sdsp_pump_eof.restype = C.c_int
_lib.sdsp_pump_eof.argtypes = [C.c_void_p]
_lib.sdsp_udp_create.restype = C.c_void_p
_lib.sdsp_udp_create.argtypes = [C.c_char_p, C.c_int, C.c_int, C.c_size_t]
_lib.sdsp_udp_destroy.argtypes = [C.c_void_p]
_lib.sdsp_udp_read.restype = C.c_long
_lib.sdsp_udp_read.argtypes = [C.c_void_p, C.c_void_p, C.c_long]
_lib.sdsp_udp_available.restype = C.c_size_t
_lib.sdsp_udp_available.argtypes = [C.c_void_p]
_lib.sdsp_udp_dropped.restype = C.c_ulonglong
_lib.sdsp_udp_dropped.argtypes = [C.c_void_p]
_lib.sdsp_tcp_create.restype = C.c_void_p
_lib.sdsp_tcp_create.argtypes = [C.c_char_p, C.c_int, C.c_int, C.c_size_t,
                                 C.c_int]
_lib.sdsp_tcp_destroy.argtypes = [C.c_void_p]
_lib.sdsp_tcp_read.restype = C.c_long
_lib.sdsp_tcp_read.argtypes = [C.c_void_p, C.c_void_p, C.c_long]
_lib.sdsp_tcp_available.restype = C.c_size_t
_lib.sdsp_tcp_available.argtypes = [C.c_void_p]
_lib.sdsp_tcp_dropped.restype = C.c_ulonglong
_lib.sdsp_tcp_dropped.argtypes = [C.c_void_p]
_lib.sdsp_tcp_eof.restype = C.c_int
_lib.sdsp_tcp_eof.argtypes = [C.c_void_p]
_lib.sdsp_tcp_tuner_type.restype = C.c_uint
_lib.sdsp_tcp_tuner_type.argtypes = [C.c_void_p]
_lib.sdsp_tcp_command.restype = C.c_int
_lib.sdsp_tcp_command.argtypes = [C.c_void_p, C.c_int, C.c_uint]


class BufferError_(RuntimeError):
    """Over/underflow — reference BufferErrorCode (circular_buffer:27-33)."""


class CircularBuffer:
    """Sample ring buffer over the native SPSC ring.

    Reference-parity API (src/circular_buffer/mod.rs): ``push`` (one
    sample, errors when full), ``append`` (block, errors if it does not
    fully fit), ``pop``, ``read``/``release`` (linearized view + consume),
    ``reset``; plus numpy in/out.
    """

    def __init__(self, max_size: int, dtype=np.complex64):
        self.dtype = np.dtype(dtype)
        self._ptr = _lib.sdsp_ring_create(max_size * self.dtype.itemsize)
        if not self._ptr:
            raise MemoryError("ring allocation failed")
        self._max = max_size
        # captured so __del__ works during interpreter shutdown, when
        # the module global _lib may already be torn down
        self._destroy = _lib.sdsp_ring_destroy

    def __del__(self):
        if getattr(self, "_ptr", None):
            self._destroy(self._ptr)
            self._ptr = None

    def __len__(self):
        return _lib.sdsp_ring_size(self._ptr) // self.dtype.itemsize

    def is_empty(self) -> bool:
        return len(self) == 0

    def is_full(self) -> bool:
        return self.space() == 0

    def capacity(self) -> int:
        return self._max

    def space(self) -> int:
        cap_extra = (_lib.sdsp_ring_capacity(self._ptr)
                     // self.dtype.itemsize) - self._max
        free = _lib.sdsp_ring_space(self._ptr) // self.dtype.itemsize
        return max(free - cap_extra, 0)

    def push(self, sample) -> None:
        if self.space() < 1:
            raise BufferError_("buffer full")
        a = np.asarray([sample], dtype=self.dtype)
        _lib.sdsp_ring_push(self._ptr, a.ctypes.data_as(C.c_void_p), a.nbytes)

    def append(self, samples) -> None:
        a = np.ascontiguousarray(samples, dtype=self.dtype)
        if self.space() < a.size:
            raise BufferError_("buffer full")
        _lib.sdsp_ring_push(self._ptr, a.ctypes.data_as(C.c_void_p), a.nbytes)

    def pop(self):
        if len(self) == 0:
            raise BufferError_("buffer empty")
        out = np.empty(1, dtype=self.dtype)
        _lib.sdsp_ring_pop(self._ptr, out.ctypes.data_as(C.c_void_p),
                           out.nbytes)
        return out[0]

    def read(self, n: int | None = None) -> np.ndarray:
        """Linearized non-consuming view of the first n samples."""
        n = len(self) if n is None else min(n, len(self))
        out = np.empty(n, dtype=self.dtype)
        _lib.sdsp_ring_peek(self._ptr, out.ctypes.data_as(C.c_void_p),
                            out.nbytes)
        return out

    def release(self, n: int) -> None:
        if n > len(self):
            raise BufferError_("releasing more than is committed")
        _lib.sdsp_ring_release(self._ptr, n * self.dtype.itemsize)

    def pop_block(self, n: int) -> np.ndarray:
        if n > len(self):
            raise BufferError_("buffer empty")
        out = np.empty(n, dtype=self.dtype)
        _lib.sdsp_ring_pop(self._ptr, out.ctypes.data_as(C.c_void_p),
                           out.nbytes)
        return out

    def reset(self) -> None:
        _lib.sdsp_ring_reset(self._ptr)


def _fmt_code(fmt: str) -> int:
    try:
        return IQ_FORMATS[fmt]
    except KeyError:
        raise ValueError(f"unknown IQ format {fmt!r}; "
                         f"one of {sorted(IQ_FORMATS)}") from None


def read_iq(path: str, fmt: str = "cf32", offset: int = 0,
            count: int = -1) -> np.ndarray:
    """Read an interleaved IQ recording -> complex64 (native conversion)."""
    code = _fmt_code(fmt)
    if count < 0:
        sb = _lib.sdsp_iq_sample_bytes(code)
        count = max(os.path.getsize(path) // sb - offset, 0)
    out = np.empty(count, dtype=np.complex64)
    got = _lib.sdsp_iq_read(path.encode(), code, offset, count,
                            out.ctypes.data_as(C.c_void_p))
    if got < 0:
        raise OSError(f"failed reading {path}")
    return out[:got]


def write_iq(path: str, samples, fmt: str = "cf32",
             append: bool = False) -> int:
    """Write complex samples as an interleaved IQ recording."""
    code = _fmt_code(fmt)
    a = np.ascontiguousarray(samples, dtype=np.complex64)
    got = _lib.sdsp_iq_write(path.encode(), code,
                             a.ctypes.data_as(C.c_void_p), a.size,
                             1 if append else 0)
    if got < 0:
        raise OSError(f"failed writing {path}")
    return int(got)


class StreamPump:
    """Threaded IQ-file prefetcher: C++ reader thread keeps a ring of
    converted complex64 samples full while Python consumes blocks.

    Usage::

        with StreamPump(path, fmt="ci16", block=1 << 20) as pump:
            for block in pump:          # np.complex64 arrays
                out = chain.execute_block(block)
    """

    def __init__(self, path: str, fmt: str = "cf32", block: int = 1 << 20,
                 ring_samples: int | None = None):
        code = _fmt_code(fmt)
        self.block = int(block)
        ring_samples = ring_samples or 4 * self.block
        self._destroy = _lib.sdsp_pump_destroy
        self._ptr = _lib.sdsp_pump_create(path.encode(), code, ring_samples)
        if not self._ptr:
            raise OSError(f"cannot open {path}")

    def close(self):
        if getattr(self, "_ptr", None):
            self._destroy(self._ptr)
            self._ptr = None

    __del__ = close

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def next_block(self) -> np.ndarray | None:
        """Blocking: next block (complex64); short at EOF; None when done."""
        out = np.empty(self.block, dtype=np.complex64)
        got = _lib.sdsp_pump_next(self._ptr, out.ctypes.data_as(C.c_void_p),
                                  self.block)
        if got < 0:
            raise OSError("IO error in pump reader thread")
        if got == 0:
            return None
        return out[:got]

    def __iter__(self):
        while True:
            b = self.next_block()
            if b is None:
                return
            yield b


class UdpSource:
    """Live UDP IQ receiver: the C++ thread converts datagrams (ci8/ci16/
    cf32/cf64) to complex64 into a lock-free ring; Python drains blocks
    non-blockingly.  A full ring DROPS datagrams (counted via .dropped) —
    live-radio semantics, never back-pressure.

    Usage::

        with UdpSource(port=5000, fmt="ci16") as src:
            while True:
                block = src.read(1 << 16)     # up to N samples, no blocking
                if block.size:
                    out = chain.execute_block(block)
    """

    def __init__(self, port: int, fmt: str = "ci16",
                 bind_addr: str = "0.0.0.0", ring_samples: int = 1 << 22):
        code = _fmt_code(fmt)
        self._destroy = _lib.sdsp_udp_destroy
        self._ptr = _lib.sdsp_udp_create(bind_addr.encode(), int(port),
                                         code, ring_samples)
        if not self._ptr:
            raise OSError(f"cannot bind UDP {bind_addr}:{port}")

    def close(self):
        if getattr(self, "_ptr", None):
            self._destroy(self._ptr)
            self._ptr = None

    __del__ = close

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def read(self, max_samples: int) -> np.ndarray:
        """Non-blocking: up to max_samples complex64 (possibly empty)."""
        out = np.empty(max_samples, dtype=np.complex64)
        got = _lib.sdsp_udp_read(self._ptr, out.ctypes.data_as(C.c_void_p),
                                 max_samples)
        if got < 0:
            raise OSError("IO error in UDP receiver thread")
        return out[:got]

    @property
    def available(self) -> int:
        return int(_lib.sdsp_udp_available(self._ptr))

    @property
    def dropped(self) -> int:
        """Datagrams dropped because the ring was full."""
        return int(_lib.sdsp_udp_dropped(self._ptr))


class TcpSource:
    """TCP-stream IQ receiver (raw stream in any IQ_FORMAT).

    Same live-source semantics as UdpSource: the C++ reader thread
    converts the byte stream to complex64 into a lock-free ring (partial
    samples carried across recv boundaries) and a full ring drops bytes
    (counted) rather than back-pressuring the sender's TCP window.
    ``eof`` turns True after the remote closes AND the ring drains.
    """

    _CREATE_RTL = 0

    def __init__(self, host: str, port: int, fmt: str = "ci16",
                 ring_samples: int = 1 << 22):
        code = _fmt_code(fmt)
        self._destroy = _lib.sdsp_tcp_destroy
        self._ptr = _lib.sdsp_tcp_create(host.encode(), int(port), code,
                                         ring_samples, self._CREATE_RTL)
        if not self._ptr:
            raise OSError(f"cannot connect TCP {host}:{port}")

    def close(self):
        if getattr(self, "_ptr", None):
            self._destroy(self._ptr)
            self._ptr = None

    __del__ = close

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def read(self, max_samples: int) -> np.ndarray:
        """Non-blocking: up to max_samples complex64 (possibly empty)."""
        out = np.empty(max_samples, dtype=np.complex64)
        got = _lib.sdsp_tcp_read(self._ptr, out.ctypes.data_as(C.c_void_p),
                                 max_samples)
        if got == -1:
            raise OSError("IO error in TCP receiver thread")
        if got < 0:                      # -2: orderly EOF, drained
            return out[:0]
        return out[:got]

    @property
    def available(self) -> int:
        return int(_lib.sdsp_tcp_available(self._ptr))

    @property
    def dropped(self) -> int:
        """Bytes dropped because the ring was full."""
        return int(_lib.sdsp_tcp_dropped(self._ptr))

    @property
    def eof(self) -> bool:
        return bool(_lib.sdsp_tcp_eof(self._ptr))


class RtlTcpSource(TcpSource):
    """rtl_tcp client: THE standard SDR network protocol.

    Connects to an ``rtl_tcp`` server, validates the 12-byte "RTL0"
    greeting, streams the u8 offset-127.5 IQ (converted to complex64 in
    the C++ thread), and exposes the 5-byte big-endian command channel
    (set_center_freq / set_sample_rate / set_gain)::

        with RtlTcpSource("127.0.0.1", 1234) as sdr:
            sdr.set_center_freq(100_300_000)
            sdr.set_sample_rate(2_048_000)
            block = sdr.read(1 << 18)
    """

    _CREATE_RTL = 1

    def __init__(self, host: str, port: int = 1234,
                 ring_samples: int = 1 << 22):
        super().__init__(host, port, fmt="cu8", ring_samples=ring_samples)

    @property
    def tuner_type(self) -> int:
        return int(_lib.sdsp_tcp_tuner_type(self._ptr))

    def command(self, cmd: int, param: int) -> None:
        if _lib.sdsp_tcp_command(self._ptr, int(cmd),
                                 int(param) & 0xFFFFFFFF) != 0:
            raise OSError("rtl_tcp command send failed")

    def set_center_freq(self, hz: int) -> None:
        self.command(0x01, hz)

    def set_sample_rate(self, hz: int) -> None:
        self.command(0x02, hz)

    def set_gain_mode(self, manual: bool) -> None:
        self.command(0x03, 1 if manual else 0)

    def set_gain(self, tenth_db: int) -> None:
        self.command(0x04, tenth_db)

    def set_agc(self, on: bool) -> None:
        self.command(0x08, 1 if on else 0)


# SigMF interop sits on read_iq/write_iq, so it imports from this module —
# bind it at the end to avoid a circular import at package load.
from .sigmf import read_sigmf, sigmf_paths, write_sigmf  # noqa: E402

__all__ += ["read_sigmf", "write_sigmf", "sigmf_paths"]
