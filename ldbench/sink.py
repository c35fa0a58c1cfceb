"""The output of a job: rows kept in memory, nothing written to disk."""

from __future__ import annotations

import io


class RowSink(io.RawIOBase):
    """A seekable binary file whose bytes live in a bytearray. write()
    appends at C speed and does nothing else; a str raises TypeError, on
    which the port's writer encodes it. take() hands over the job's rows
    and starts an empty buffer for the next job."""

    def __init__(self):
        super().__init__()
        self.buf = bytearray()

    def writable(self) -> bool:
        return True

    def seekable(self) -> bool:
        return True

    def write(self, data) -> int:
        self.buf += data
        return len(data)

    def tell(self) -> int:
        return len(self.buf)

    def seek(self, offset: int, whence: int = 0) -> int:
        # the port seeks only to rewind a failed run's rows (seek(0),
        # truncate()); appends always go to the end
        if (offset, whence) not in ((0, 0), (0, 2)):
            raise io.UnsupportedOperation("RowSink seeks to 0 or the end")
        return 0 if whence == 0 else len(self.buf)

    def truncate(self, size=None) -> int:
        del self.buf[0 if size is None else size:]
        return len(self.buf)

    def take(self) -> bytearray:
        rows, self.buf = self.buf, bytearray()
        return rows
