"""Minimal HOCON parser + ConfigTree, API-compatible with the subset of
pyhocon that the reference uses (``ConfigFactory.parse_file`` at
the reference runner.py:35 and the ``get_*``/``[]`` accessors used across
models/ and datasets/).

Supported syntax (everything appearing in confs/surf*.conf):
  * ``#`` and ``//`` line comments
  * nested objects ``name { ... }`` (with or without ``=``/``:``)
  * ``key = value`` / ``key : value``
  * lists ``[a, b, c]`` incl. nested lists ``[[-1, 1], [-1, 1]]``
  * ints, floats (incl. ``5e-4``), booleans (``true``/``True``/...),
    quoted strings, and unquoted strings running to end-of-line
    (e.g. ``<your output save path>`` or ``datasets/dtu_split/train.txt``)

ConfigTree supports dotted-path access: ``conf["train.lr_conf"]``,
``conf.get_int("train.epochs")``, ``conf.get_list(...)``,
``conf.get_float(...)``, ``conf.get_bool(key, default)``,
``conf.get_string(...)``, ``get(key, default)``, ``in``, and item
assignment (used by the runner to override finetune scene/ref_view,
the reference runner.py:42-43).
"""

from __future__ import annotations

import re


_MISSING = object()


class ConfigMissingException(KeyError):
    pass


class ConfigTree(dict):
    """A dict with dotted-path access and typed getters."""

    # ---- path helpers -------------------------------------------------
    def _resolve(self, path, default=_MISSING):
        node = self
        parts = path.split(".") if isinstance(path, str) else [path]
        for part in parts:
            if isinstance(node, dict) and dict.__contains__(node, part):
                node = dict.__getitem__(node, part)
            else:
                if default is _MISSING:
                    raise ConfigMissingException(f"No configuration setting found for key '{path}'")
                return default
        return node

    def __getitem__(self, path):
        return self._resolve(path)

    def __setitem__(self, path, value):
        parts = path.split(".") if isinstance(path, str) else [path]
        node = self
        for part in parts[:-1]:
            nxt = dict.get(node, part)
            if not isinstance(nxt, ConfigTree):
                nxt = ConfigTree()
                dict.__setitem__(node, part, nxt)
            node = nxt
        dict.__setitem__(node, parts[-1], value)

    def __contains__(self, path):
        sentinel = object()
        return self._resolve(path, sentinel) is not sentinel

    def get(self, path, default=None):
        return self._resolve(path, default)

    # ---- typed getters (pyhocon-compatible surface) --------------------
    def get_string(self, path, default=_MISSING):
        v = self._resolve(path, default)
        if v is default and default is not _MISSING:
            return v
        return str(v)

    def get_int(self, path, default=_MISSING):
        v = self._resolve(path, default)
        if v is default and default is not _MISSING:
            return v
        return int(v)

    def get_float(self, path, default=_MISSING):
        v = self._resolve(path, default)
        if v is default and default is not _MISSING:
            return v
        return float(v)

    def get_bool(self, path, default=_MISSING):
        v = self._resolve(path, default)
        if v is default and default is not _MISSING:
            return v
        if isinstance(v, bool):
            return v
        if isinstance(v, str):
            lv = v.strip().lower()
            if lv in ("true", "yes", "on", "1"):
                return True
            if lv in ("false", "no", "off", "0"):
                return False
        raise ValueError(f"Cannot interpret {v!r} as bool for key '{path}'")

    def get_list(self, path, default=_MISSING):
        v = self._resolve(path, default)
        if v is default and default is not _MISSING:
            return v
        if not isinstance(v, list):
            raise ValueError(f"Key '{path}' is not a list: {v!r}")
        return v

    def get_config(self, path, default=_MISSING):
        v = self._resolve(path, default)
        if v is default and default is not _MISSING:
            return v
        if not isinstance(v, ConfigTree):
            raise ValueError(f"Key '{path}' is not a config object")
        return v

    def as_plain_dict(self):
        out = {}
        for k, v in self.items():
            if isinstance(v, ConfigTree):
                out[k] = v.as_plain_dict()
            else:
                out[k] = v
        return out


# ---------------------------------------------------------------------------
# Tokenizer / parser
# ---------------------------------------------------------------------------

_NUM_RE = re.compile(r"^[+-]?(\d+\.?\d*|\.\d+)([eE][+-]?\d+)?$")
_INT_RE = re.compile(r"^[+-]?\d+$")


def _strip_comment(line: str) -> str:
    """Strip # / // comments, respecting quoted strings."""
    out = []
    in_str = None
    i = 0
    while i < len(line):
        ch = line[i]
        if in_str:
            out.append(ch)
            if ch == in_str:
                in_str = None
            i += 1
            continue
        if ch in ("\"", "'"):
            in_str = ch
            out.append(ch)
            i += 1
            continue
        if ch == "#":
            break
        if ch == "/" and i + 1 < len(line) and line[i + 1] == "/":
            break
        out.append(ch)
        i += 1
    return "".join(out)


def _coerce_scalar(tok: str):
    tok = tok.strip()
    if tok == "":
        return ""
    if tok.startswith('"') and tok.endswith('"') and len(tok) >= 2:
        return tok[1:-1]
    if tok.startswith("'") and tok.endswith("'") and len(tok) >= 2:
        return tok[1:-1]
    low = tok.lower()
    if low in ("true", "yes", "on"):
        return True
    if low in ("false", "no", "off"):
        return False
    if low in ("null", "none"):
        return None
    if _INT_RE.match(tok):
        return int(tok)
    if _NUM_RE.match(tok):
        return float(tok)
    return tok


def _parse_value(text: str):
    """Parse a value expression (scalar or bracketed list)."""
    text = text.strip()
    if text.startswith("["):
        val, rest = _parse_list(text)
        if rest.strip():
            raise ValueError(f"Trailing content after list: {rest!r}")
        return val
    return _coerce_scalar(text)


def _parse_list(text: str):
    """Parse '[...]' returning (list, remainder). Handles nesting."""
    assert text[0] == "["
    items = []
    i = 1
    buf = ""

    def flush():
        nonlocal buf
        s = buf.strip()
        if s:
            items.append(_coerce_scalar(s))
        buf = ""

    while i < len(text):
        ch = text[i]
        if ch == "[":
            sub, rest = _parse_list(text[i:])
            items.append(sub)
            text = text[:i] + rest
            # after substitution, continue at same i over `rest`
            continue
        if ch == "]":
            flush()
            return items, text[i + 1:]
        if ch == ",":
            flush()
            i += 1
            continue
        buf += ch
        i += 1
    raise ValueError("Unterminated list")


_KEY_RE = re.compile(r"^\s*([A-Za-z0-9_\-.\"']+)\s*([:={[]|\{)?")

_INLINE_KEY_RE = re.compile(r"([A-Za-z0-9_\-.]+)\s*[:=]")


def _split_inline_pairs(body: str):
    """Split 'a = 1  b = [1, 2]' into [('a','1'), ('b','[1, 2]')]."""
    matches = list(_INLINE_KEY_RE.finditer(body))
    pairs = []
    for i, m in enumerate(matches):
        end = matches[i + 1].start() if i + 1 < len(matches) else len(body)
        pairs.append((m.group(1), body[m.end():end].strip().rstrip(",")))
    return pairs


def parse_string(content: str) -> ConfigTree:
    # Normalize: join lists that span multiple lines by tracking bracket depth.
    raw_lines = content.split("\n")
    lines = []
    buf = ""
    depth = 0
    for raw in raw_lines:
        line = _strip_comment(raw)
        buf = (buf + " " + line) if buf else line
        depth = buf.count("[") - buf.count("]")
        if depth > 0:
            continue
        lines.append(buf)
        buf = ""
    if buf.strip():
        lines.append(buf)

    root = ConfigTree()
    stack = [root]
    for line in lines:
        s = line.strip()
        if not s:
            continue
        # closing braces (possibly with trailing content like '}')
        while s.startswith("}"):
            if len(stack) == 1:
                raise ValueError("Unbalanced '}'")
            stack.pop()
            s = s[1:].strip()
        if not s:
            continue
        m = _KEY_RE.match(s)
        if not m:
            raise ValueError(f"Cannot parse line: {line!r}")
        key = m.group(1).strip("\"'")
        rest = s[m.end(1):].strip()
        if rest.startswith(("=", ":")):
            rest = rest[1:].strip()
        if rest.startswith("{"):
            sub = ConfigTree()
            dict.__setitem__(stack[-1], key, sub)
            stack.append(sub)
            inner = rest[1:].strip()
            if inner.endswith("}") and inner.count("{") == 0:
                # one-line object: 'k { a = 1  b = [1, 2] }'
                inner_body = inner[:-1].strip()
                if inner_body:
                    for kk, vv in _split_inline_pairs(inner_body):
                        dict.__setitem__(sub, kk, _parse_value(vv))
                stack.pop()
            continue
        # plain value (may end with '}' closing parent on same line — rare)
        closes = 0
        while rest.endswith("}") and rest.count("[") == rest.count("]"):
            rest = rest[:-1].strip()
            closes += 1
        # multiple `key = value` assignments on one line: split them
        extra = [m for m in _INLINE_KEY_RE.finditer(rest)]
        if extra:
            pairs = _split_inline_pairs(f"{key} = {rest}")
            for kk, vv in pairs:
                dict.__setitem__(stack[-1], kk, _parse_value(vv))
        else:
            dict.__setitem__(stack[-1], key, _parse_value(rest))
        for _ in range(closes):
            if len(stack) == 1:
                raise ValueError("Unbalanced '}'")
            stack.pop()
    return root


def parse_file(path: str) -> ConfigTree:
    with open(path, "r") as f:
        return parse_string(f.read())


def _dump_value(v) -> str:
    if isinstance(v, bool):
        return "true" if v else "false"
    if v is None:
        return "null"
    if isinstance(v, (int, float)):
        return repr(v)
    if isinstance(v, list):
        return "[" + ", ".join(_dump_value(x) for x in v) + "]"
    s = str(v)
    if '"' in s or "\n" in s:
        raise ValueError(f"cannot write {s!r} as a quoted HOCON string")
    return f'"{s}"'


def dump_string(tree, indent: int = 0) -> str:
    """``tree`` as HOCON text that ``parse_string`` reads back to an equal
    tree: one key a line, blocks indented, strings quoted."""
    pad = "    " * indent
    lines = []
    for k, v in tree.items():
        if isinstance(v, dict):
            lines += [f"{pad}{k} {{", dump_string(v, indent + 1), f"{pad}}}"]
        else:
            lines.append(f"{pad}{k} = {_dump_value(v)}")
    return "\n".join(line for line in lines if line)


class ConfigFactory:
    """pyhocon-compatible entry point (reference: runner.py:35)."""

    @staticmethod
    def parse_file(path: str) -> ConfigTree:
        return parse_file(path)

    @staticmethod
    def parse_string(content: str) -> ConfigTree:
        return parse_string(content)
