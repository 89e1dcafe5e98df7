"""A configuration file's ``model`` and ``train`` sections as the two sides
read them.

The reference reads them through ``Conf``, a small stand-in for the HOCON
tree's getters; the program gets the same dict as HOCON text
(``to_hocon``), which its own parser reads.
"""

from __future__ import annotations

import json

_MISSING = object()


class Conf:
    """Dotted-key getters over a nested dict (``get_int("a.b")``)."""

    def __init__(self, tree):
        self.tree = tree

    def get(self, key, default=_MISSING):
        node = self.tree
        for part in key.split("."):
            if not isinstance(node, dict) or part not in node:
                if default is _MISSING:
                    raise KeyError(key)
                return default
            node = node[part]
        return Conf(node) if isinstance(node, dict) else node

    def __getitem__(self, key):
        return self.get(key)

    def get_int(self, key, default=_MISSING):
        v = self.get(key, default)
        return v if v is None else int(v)

    def get_float(self, key, default=_MISSING):
        v = self.get(key, default)
        return v if v is None else float(v)

    def get_bool(self, key, default=_MISSING):
        v = self.get(key, default)
        return v if v is None else bool(v)

    def get_string(self, key, default=_MISSING):
        v = self.get(key, default)
        return v if v is None else str(v)

    def get_list(self, key, default=_MISSING):
        v = self.get(key, default)
        return v if v is None else list(v)



def _value(v):
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, (int, float)):
        return repr(v)
    if isinstance(v, str):
        return json.dumps(v)
    if isinstance(v, list):
        return "[" + ", ".join(_value(x) for x in v) + "]"
    raise TypeError(f"no HOCON form for {type(v).__name__}")


def to_hocon(tree, indent=0):
    """A nested dict of numbers, strings, booleans and lists as HOCON."""
    pad = "    " * indent
    out = []
    for k, v in tree.items():
        if isinstance(v, dict):
            out += [f"{pad}{k} {{", to_hocon(v, indent + 1), f"{pad}}}"]
        else:
            out.append(f"{pad}{k} = {_value(v)}")
    return "\n".join(out)
