"""PFM depth-map IO (the format DTU's GT and pseudo depths ship in); a copy
of the JAX package's reader and writer (surf_tpu/io/pfm.py:11, :35)."""

from __future__ import annotations

import re

import numpy as np


def read_pfm(path):
    """Returns (data (H,W) or (H,W,3) float32, scale)."""
    with open(path, "rb") as f:
        header = f.readline().decode("utf-8").rstrip()
        if header == "PF":
            color = True
        elif header == "Pf":
            color = False
        else:
            raise ValueError("Not a PFM file.")
        dim_line = f.readline().decode("utf-8")
        m = re.match(r"^(\d+)\s(\d+)\s*$", dim_line)
        if not m:
            raise ValueError("Malformed PFM header.")
        width, height = map(int, m.groups())
        scale = float(f.readline().rstrip())
        endian = "<" if scale < 0 else ">"
        scale = abs(scale)
        data = np.fromfile(f, endian + "f")
    shape = (height, width, 3) if color else (height, width)
    data = np.reshape(data, shape)
    return np.flipud(data).astype(np.float32), scale


def write_pfm(path, data, scale=1.0):
    data = np.asarray(data, dtype=np.float32)
    if data.ndim == 3 and data.shape[2] == 3:
        color = True
    elif data.ndim == 2 or (data.ndim == 3 and data.shape[2] == 1):
        color = False
        data = data.reshape(data.shape[0], data.shape[1])
    else:
        raise ValueError("data must be HxW or HxWx3")
    with open(path, "wb") as f:
        f.write(b"PF\n" if color else b"Pf\n")
        f.write(f"{data.shape[1]} {data.shape[0]}\n".encode("ascii"))
        f.write(f"{-scale}\n".encode("ascii"))  # little-endian
        np.flipud(data).astype("<f4").tofile(f)
