"""Streaming zstd IO over the system libzstd via ctypes (no pip deps).

The reference reads and writes zstd transparently (reference
src/util/io/zstd_stream.cpp); this module provides the same capability:
`zstd_open(path, "rb"/"wb"/"rt"/"wt")` returns a file-like streaming
(de)compressor.  Input auto-detection lives in data/fasta._open_raw via
the 0xFD2FB528 magic.
"""
from __future__ import annotations

import ctypes
import ctypes.util
import io

_lib = None
_tried = False

ZSTD_e_continue = 0
ZSTD_e_end = 2


class _Buf(ctypes.Structure):
    _fields_ = [("dst", ctypes.c_void_p), ("size", ctypes.c_size_t),
                ("pos", ctypes.c_size_t)]


def lib():
    global _lib, _tried
    if _tried:
        return _lib
    _tried = True
    name = ctypes.util.find_library("zstd") or "libzstd.so.1"
    try:
        z = ctypes.CDLL(name)
        z.ZSTD_createDStream.restype = ctypes.c_void_p
        z.ZSTD_createCStream.restype = ctypes.c_void_p
        z.ZSTD_decompressStream.restype = ctypes.c_size_t
        z.ZSTD_decompressStream.argtypes = [ctypes.c_void_p,
                                            ctypes.POINTER(_Buf),
                                            ctypes.POINTER(_Buf)]
        z.ZSTD_compressStream2.restype = ctypes.c_size_t
        z.ZSTD_compressStream2.argtypes = [ctypes.c_void_p,
                                           ctypes.POINTER(_Buf),
                                           ctypes.POINTER(_Buf),
                                           ctypes.c_int]
        z.ZSTD_isError.restype = ctypes.c_uint
        z.ZSTD_isError.argtypes = [ctypes.c_size_t]
        z.ZSTD_freeDStream.argtypes = [ctypes.c_void_p]
        z.ZSTD_freeCStream.argtypes = [ctypes.c_void_p]
        _lib = z
    except OSError:
        _lib = None
    return _lib


_CHUNK = 1 << 17


class ZstdReader(io.RawIOBase):
    """Streaming zstd decompressor (binary read)."""

    def __init__(self, path: str):
        z = lib()
        if z is None:
            raise RuntimeError("libzstd not available")
        self._z = z
        self._f = open(path, "rb")
        self._ds = z.ZSTD_createDStream()
        self._in = b""
        self._in_pos = 0
        self._eof = False

    def readable(self):
        return True

    def readinto(self, b):
        z = self._z
        out = _Buf(ctypes.cast(ctypes.addressof(
            (ctypes.c_char * len(b)).from_buffer(b)), ctypes.c_void_p),
            len(b), 0)
        while out.pos == 0 and not self._eof:
            if self._in_pos >= len(self._in):
                self._in = self._f.read(_CHUNK)
                self._in_pos = 0
                if not self._in:
                    self._eof = True
                    break
            src = ctypes.create_string_buffer(self._in[self._in_pos:],
                                              len(self._in) - self._in_pos)
            inb = _Buf(ctypes.cast(src, ctypes.c_void_p),
                       len(self._in) - self._in_pos, 0)
            r = z.ZSTD_decompressStream(self._ds, ctypes.byref(out),
                                        ctypes.byref(inb))
            if z.ZSTD_isError(r):
                raise OSError("zstd decompression error")
            self._in_pos += inb.pos
            if r == 0 and inb.pos == 0 and out.pos == 0:
                self._eof = True
        return out.pos

    def close(self):
        if not self.closed:
            self._z.ZSTD_freeDStream(self._ds)
            self._f.close()
        super().close()


class ZstdWriter(io.RawIOBase):
    """Streaming zstd compressor (binary write)."""

    def __init__(self, path: str):
        z = lib()
        if z is None:
            raise RuntimeError("libzstd not available")
        self._z = z
        self._f = open(path, "wb")
        self._cs = z.ZSTD_createCStream()
        self._outbuf = ctypes.create_string_buffer(_CHUNK)

    def writable(self):
        return True

    def _pump(self, data: bytes, mode: int):
        z = self._z
        src = ctypes.create_string_buffer(data, len(data)) if data else None
        inb = _Buf(ctypes.cast(src, ctypes.c_void_p) if src else None,
                   len(data), 0)
        while True:
            out = _Buf(ctypes.cast(self._outbuf, ctypes.c_void_p), _CHUNK, 0)
            r = z.ZSTD_compressStream2(self._cs, ctypes.byref(out),
                                       ctypes.byref(inb), mode)
            if z.ZSTD_isError(r):
                raise OSError("zstd compression error")
            if out.pos:
                self._f.write(self._outbuf.raw[: out.pos])
            if mode == ZSTD_e_end:
                if r == 0:
                    break
            elif inb.pos >= len(data):
                break
        return len(data)

    def write(self, data):
        return self._pump(bytes(data), ZSTD_e_continue)

    def close(self):
        if not self.closed:
            self._pump(b"", ZSTD_e_end)
            self._z.ZSTD_freeCStream(self._cs)
            self._f.close()
        super().close()


def zstd_open(path: str, mode: str = "rb"):
    """Open a zstd stream; 'rt'/'wt' wrap in a text layer."""
    if "r" in mode:
        raw = io.BufferedReader(ZstdReader(path))
        return io.TextIOWrapper(raw) if "t" in mode else raw
    raw = io.BufferedWriter(ZstdWriter(path))
    return io.TextIOWrapper(raw) if "t" in mode else raw
