"""The card the port runs on: the numeric settings every entry point uses
there, and the card's name and power limit for the record."""

from __future__ import annotations

import subprocess

import torch


def set_numerics():
    """Full f32 on the card: TF32 off for matmuls and cuDNN convolutions
    (cuDNN takes TF32 by default).  Bit-reproducible runs need nothing
    here: the transposed convolutions, whose default cuDNN algorithms are
    not deterministic, see to it themselves (``nn/core.py``)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def nvidia_smi_line():
    """``name, power.limit`` of the first card, as
    ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
    prints it."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip().splitlines()
    return out[0] if out else "nvidia-smi: no output"
