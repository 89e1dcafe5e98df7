"""Print the ``train_avg/*`` and ``val_img_avg/*`` scalars of a training
run's TensorBoard event file, by epoch, without tensorboardX (which the
card's machine does not have):

    python3 scripts/tb_scalars.py <log_dir>

``<log_dir>`` holds one ``events.out.tfevents.*`` file, as the port's
``utils.summary.SummaryWriter`` writes it; each record's length and data
are checked against their masked CRC-32C."""

import glob
import os
import struct
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from surf_tpu_torch.utils.summary import masked_crc32c  # noqa: E402


def proto_fields(buf):
    """(field number, wire type, value) of a protobuf message: varints,
    fixed64 / fixed32 as bytes, length-delimited as bytes."""
    pos, out = 0, []

    def varint():
        nonlocal pos
        n = shift = 0
        while True:
            b = buf[pos]
            pos += 1
            n |= (b & 0x7F) << shift
            shift += 7
            if not b & 0x80:
                return n
    while pos < len(buf):
        key = varint()
        num, wire = key >> 3, key & 7
        if wire == 0:
            v = varint()
        elif wire == 1:
            v, pos = buf[pos:pos + 8], pos + 8
        elif wire == 5:
            v, pos = buf[pos:pos + 4], pos + 4
        elif wire == 2:
            n = varint()
            v, pos = buf[pos:pos + n], pos + n
        else:
            raise ValueError(f"wire type {wire}")
        out.append((num, wire, v))
    return out


def read_events(path):
    """The records of a TensorBoard event file: returns (file_version,
    [(tag, step, simple_value)])."""
    buf = open(path, "rb").read()
    pos, version, scalars = 0, None, []
    while pos < len(buf):
        head = buf[pos:pos + 8]
        n, = struct.unpack("<Q", head)
        if struct.unpack("<I", buf[pos + 8:pos + 12])[0] != masked_crc32c(head):
            raise ValueError(f"{path}: bad length CRC at byte {pos}")
        data = buf[pos + 12:pos + 12 + n]
        if len(data) != n or struct.unpack("<I", buf[pos + 12 + n:pos + 16 + n])[0] \
                != masked_crc32c(data):
            raise ValueError(f"{path}: bad data CRC at byte {pos}")
        pos += 16 + n
        ev = {num: v for num, _, v in proto_fields(data)}
        if 3 in ev:
            version = ev[3].decode()
            continue
        step = ev.get(2, 0)
        step = step - (1 << 64) if step >= 1 << 63 else step
        (value,) = [v for num, _, v in proto_fields(ev[5]) if num == 1]
        fields = {num: v for num, _, v in proto_fields(value)}
        scalars.append((fields[1].decode(), step, struct.unpack("<f", fields[2])[0]))
    return version, scalars


def main(log_dir):
    (path,) = glob.glob(os.path.join(log_dir, "events.out.tfevents.*"))
    _, scalars = read_events(path)
    for prefix in ("train_avg/", "val_img_avg/"):
        for e in sorted({s for tag, s, _ in scalars if tag.startswith(prefix)}):
            print(f"{prefix} epoch {e}: " + " ".join(
                f"{tag[len(prefix):]} {v:.6g}" for tag, s, v in scalars
                if s == e and tag.startswith(prefix)))


if __name__ == "__main__":
    main(sys.argv[1])
