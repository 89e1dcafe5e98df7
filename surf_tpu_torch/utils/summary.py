"""TensorBoard scalars without ``tensorboardX``: the JAX runner's writer
(surf_tpu/runner.py:47-58, 119-122) and ``save_scalars``
(surf_tpu/utils/tools.py:37-41), for the loops' ``train``,
``train_avg``, ``val_img_avg`` and ``finetune`` streams.

``SummaryWriter(log_dir)`` writes ``<log_dir>/events.out.tfevents.<unix
time>.<host>`` at its first scalar.  Each record is TFRecord-framed: the
data's length as a little-endian u64, the masked CRC-32C of those 8
bytes, the data, the masked CRC-32C of the data.  The data is an
``Event`` protobuf, encoded here by hand: the first carries
``wall_time`` and ``file_version = "brain.Event:2"``, each later one
``wall_time``, ``step`` and a ``Summary`` of one ``value { tag,
simple_value }``.  Every record is flushed as it is written.

``scalar_writer(log_dir)`` gives such a writer on the first rank and a
writer that drops everything on the others or without a directory.
"""

from __future__ import annotations

import os
import socket
import struct
import time

import numpy as np

from ..parallel.distribute import is_main_process

FILE_VERSION = "brain.Event:2"


def _crc32c_table():
    table = []
    for n in range(256):
        c = n
        for _ in range(8):
            c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
        table.append(c)
    return table


_CRC32C = _crc32c_table()


def crc32c(data):
    """CRC-32C (Castagnoli) of ``data``."""
    c = 0xFFFFFFFF
    for b in data:
        c = _CRC32C[(c ^ b) & 0xFF] ^ (c >> 8)
    return c ^ 0xFFFFFFFF


def masked_crc32c(data):
    """TFRecord's masked CRC: the CRC-32C rotated right by 15, plus a
    constant."""
    c = crc32c(data)
    return (((c >> 15) | (c << 17)) + 0xA282EAD8) & 0xFFFFFFFF


def _varint(n):
    n &= (1 << 64) - 1              # int64 as protobuf's two's complement
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _bytes_field(number, data):
    return _varint(number << 3 | 2) + _varint(len(data)) + data


def encode_event(wall_time, step=0, file_version=None, tag=None, value=None):
    """An ``Event``: wall_time (1, double), step (2, int64, left out at 0
    as proto3 leaves it), then file_version (3) or a summary (5) of one
    value with its tag (1) and simple_value (2, float)."""
    out = _varint(1 << 3 | 1) + struct.pack("<d", wall_time)
    if step:
        out += _varint(2 << 3) + _varint(int(step))
    if file_version is not None:
        out += _bytes_field(3, file_version.encode())
    else:
        # float32 as protobuf rounds it (beyond its range: inf)
        f32 = np.asarray(value, np.float64).astype("<f4").tobytes()
        v = _bytes_field(1, tag.encode()) + _varint(2 << 3 | 5) + f32
        out += _bytes_field(5, _bytes_field(1, v))
    return out


def frame_record(data):
    """One TFRecord: length, its masked CRC, the data, the data's masked
    CRC."""
    head = struct.pack("<Q", len(data))
    return (head + struct.pack("<I", masked_crc32c(head)) + data
            + struct.pack("<I", masked_crc32c(data)))


class SummaryWriter:
    """Scalars into one TensorBoard event file under ``log_dir``, opened
    (with its ``file_version`` record) at the first scalar."""

    def __init__(self, log_dir):
        self.log_dir = log_dir
        self.path = None
        self._file = None

    def _open(self):
        os.makedirs(self.log_dir, exist_ok=True)
        base = os.path.join(self.log_dir, f"events.out.tfevents.{int(time.time())}."
                                          f"{socket.gethostname()}")
        path, n = base, 0
        while os.path.exists(path):         # another writer in the same second
            n += 1
            path = f"{base}.{n}"
        self.path = path
        self._file = open(path, "xb")
        self._write(encode_event(time.time(), file_version=FILE_VERSION))

    def _write(self, data):
        self._file.write(frame_record(data))
        self._file.flush()

    def add_scalar(self, tag, value, step):
        if self._file is None:
            self._open()
        self._write(encode_event(time.time(), step, tag=tag, value=float(value)))

    def flush(self):
        if self._file is not None:
            self._file.flush()

    def close(self):
        if self._file is not None:
            self._file.close()
            self._file = None


class NullWriter:
    """What ranks other than the first, and runs without a log directory,
    write: nothing."""

    def add_scalar(self, tag, value, step):
        pass

    def flush(self):
        pass

    def close(self):
        pass


def scalar_writer(log_dir):
    """A ``SummaryWriter`` into ``log_dir`` on the first rank; else (or with
    no ``log_dir``) a ``NullWriter``."""
    if log_dir is None or not is_main_process():
        return NullWriter()
    return SummaryWriter(log_dir)


def save_scalars(writer, mode, scalars, step):
    """Each ``int`` or ``float`` entry of ``scalars`` as ``<mode>/<key>`` at
    ``step``; other values are skipped."""
    for k, v in scalars.items():
        if isinstance(v, (int, float)):
            writer.add_scalar(f"{mode}/{k}", v, step)


def mean_scalars(rows):
    """The running means the JAX runner's ``DictAverageMeter`` keeps over
    ``rows`` (dicts): each ``int`` / ``float`` key's sum over the number of
    rows up to the last one that holds it, keys in order of first
    appearance."""
    sums, means = {}, {}
    for count, row in enumerate(rows, 1):
        for k, v in row.items():
            if isinstance(v, (int, float)):
                sums[k] = sums.get(k, 0.0) + v
                means[k] = sums[k] / count
    return means
