"""A conf derived from a shipped one, with some of its keys set:

    python -m surf_tpu_torch.derive_conf <conf> <out> key=value [key=value ...]

Each key is a dotted path (``train.epochs``) that must already name a
value in the shipped conf: a key the conf lacks, or one that names a
block, raises, so a renamed or moved key stops the caller instead of
leaving the shipped value in place.  Each value is read as a HOCON value
(``60``, ``false``, ``[1e-1, 1e-2]``).  The derived conf is written to
``<out>`` as HOCON text that ``config.parse_file`` reads back to the same
tree.  ``scripts/torch_finetune_runs.sh`` derives its ``--load_vol``
resume's conf this way.
"""

from __future__ import annotations

import argparse
import os

from .config import ConfigMissingException, ConfigTree, dump_string, parse_file, parse_string


def write(conf_path, out_path, overrides):
    """The conf at ``conf_path`` with each ``{dotted key: value}`` of
    ``overrides`` set, written to ``out_path``; returns the derived tree.
    Raises, writing nothing, on a key the conf lacks or one that names a
    block."""
    conf = parse_file(conf_path)
    for key, value in overrides.items():
        if key not in conf:
            raise ConfigMissingException(f"{conf_path} has no key '{key}' to set")
        if isinstance(conf[key], ConfigTree):
            raise ValueError(f"'{key}' names a block of {conf_path}, not a value")
        conf[key] = value
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    with open(out_path, "w") as f:
        f.write(dump_string(conf) + "\n")
    return conf


def parse_assignment(text):
    """``key=value`` -> (key, the value read as HOCON)."""
    key, sep, value = text.partition("=")
    if not sep or not key.strip():
        raise ValueError(f"expected key=value, got {text!r}")
    return key.strip(), parse_string(f"v = {value.strip()}")["v"]


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("conf")
    p.add_argument("out")
    p.add_argument("assignments", nargs="+", metavar="key=value")
    args = p.parse_args(argv)
    write(args.conf, args.out, dict(parse_assignment(a) for a in args.assignments))
    print(f"{args.out}: {args.conf} with " + " ".join(args.assignments))


if __name__ == "__main__":
    main()
