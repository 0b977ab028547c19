"""Growable POD byte buffer (reference ``imageio/buffer.d:43-194``).

``Buffer`` reproduces the reference's stream container semantics — a
backing array with a live ``[start, start + count)`` window, doubling
growth on write, and typed reads that ADVANCE the window — and is the
byte-stream backend of the BMP codec (`imageio/bmp.py`), exactly the role
``UntypedBuffer`` plays for ``bmp.d``.  The byte-level results are pinned
by the Wikipedia golden-byte fixtures in ``tests/test_bmp.py``.

Differences from D are idiomatic only: element type is fixed to bytes
(the ``Buffer!void``/``UntypedBuffer`` instantiation — the only one the
reference ever uses), and typed reads take a ``struct`` format instead of
a template type parameter.
"""

from __future__ import annotations

import struct


class Buffer:
    """``UntypedBuffer``: data + (start, count) window over it.

    * ``write`` appends at the window end, doubling the backing store
      while capacity is short (buffer.d:170-186).
    * ``read``/``read_array`` return the next bytes AND advance the
      window (buffer.d:115-150).
    * ``seek``/``skip``/``clear``/``capacity`` mirror buffer.d:57-90.
    """

    def __init__(self, initial_capacity: int = 0, wrap: bytes | bytearray | None = None):
        if wrap is not None:
            # this(T[] data_to_wrap) — buffer.d:100-105.  Copy-on-write:
            # immutable bytes are kept as-is (the BMP decoder wraps whole
            # multi-MB files just to stream a ~70-byte header + palette);
            # write() converts to a bytearray on first mutation.
            self.data = wrap
            self.start = 0
            self.count = len(self.data)
        else:
            self.data = bytearray(initial_capacity)
            self.start = 0
            self.count = 0

    @property
    def capacity(self) -> int:
        return len(self.data) - (self.start + self.count)

    def clear(self) -> None:
        self.start = 0
        self.count = 0

    def seek(self, position: int) -> None:
        if not position < self.start + self.count:
            raise AssertionError("Position out-of-range!")
        self.count = (self.start + self.count) - position
        self.start = position

    def __bytes__(self) -> bytes:
        """opSlice: the live window (buffer.d:75-78)."""
        return bytes(self.data[self.start : self.start + self.count])

    def __len__(self) -> int:
        return self.count

    def skip(self, skip_count: int) -> "Buffer":
        self.start += skip_count
        self.count -= skip_count
        return self

    def read(self, fmt: str):
        """Read one scalar/struct by ``struct`` format, advancing the
        window (buffer.d read!U; endianness comes from the format's
        ``<``/``>`` prefix like adjustEndianness's template parameter).
        Returns a tuple for multi-field formats, a scalar otherwise."""
        size = struct.calcsize(fmt)
        if size > self.count:
            raise AssertionError("read past the buffer window")
        out = struct.unpack_from(fmt, self.data, self.start)
        self.skip(size)
        return out if len(out) > 1 else out[0]

    def read_array(self, count: int) -> bytes:
        """readArray!ubyte (buffer.d:143-150)."""
        if count > self.count:
            raise AssertionError("read past the buffer window")
        out = bytes(self.data[self.start : self.start + count])
        self.skip(count)
        return out

    def consume(self, size: int, sink) -> None:
        """consume(size, sink) — buffer.d:161-168."""
        assert size <= self.count
        sink(bytes(self.data[self.start : self.start + size]))
        self.start += size
        self.count -= size

    def write(self, to_write: bytes | bytearray) -> None:
        """Append at the window end with doubling growth (buffer.d:170-186)."""
        if not isinstance(self.data, bytearray):  # copy-on-write (see __init__)
            self.data = bytearray(self.data)
        end = self.start + self.count
        n = len(to_write)
        while self.capacity < n:
            new_len = len(self.data) * 2 if self.data else n
            self.data.extend(bytearray(new_len - len(self.data)))
        self.data[end : end + n] = to_write
        self.count += n

    def write_struct(self, fmt: str, *values) -> None:
        """writeStruct!U (buffer.d:152-158), by ``struct`` format."""
        self.write(struct.pack(fmt, *values))
