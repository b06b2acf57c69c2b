"""HOCON-subset config system, schema-compatible with the reference confs
(this package's own copy of nicer_slam_tpu/config.py, stdlib only).

The reference (cvg/nicer-slam) drives every experiment from pyhocon ``.conf``
files (e.g. ``code/confs/replica/runconf_replica_2.conf``) and copies the conf
verbatim into the run dir as the reproducibility record
(``code/training/volsdf_train.py:90-92``).  pyhocon is not available in this
environment, so this module implements the HOCON subset those confs use:

  * nested blocks:         ``key { ... }``
  * assignments:           ``key = value`` (also ``key : value``)
  * values: ints, floats, booleans, quoted strings, bare strings,
    and (possibly multi-line, comma-optional) lists ``[ a b c ]``
  * comments: ``//`` and ``#`` to end of line
  * dotted keys:           ``a.b.c = 1``

The accessor API mirrors the pyhocon surface the reference uses:
``get_int/get_float/get_bool/get_string/get_list/get_config`` with dotted
paths and optional defaults.
"""

from __future__ import annotations

import copy
import io
import os
from typing import Any, Dict, List, Optional, Union


class ConfigMissingError(KeyError):
    pass


_MISSING = object()


class Config:
    """Nested-dict config with dotted-path accessors (pyhocon-like)."""

    def __init__(self, data: Optional[Dict[str, Any]] = None):
        self._data: Dict[str, Any] = data if data is not None else {}

    # -- generic access ----------------------------------------------------
    def get(self, path: str, default: Any = _MISSING) -> Any:
        node: Any = self._data
        for part in path.split("."):
            if isinstance(node, Config):
                node = node._data
            if not isinstance(node, dict) or part not in node:
                if default is _MISSING:
                    raise ConfigMissingError(path)
                return default
            node = node[part]
        if isinstance(node, dict):
            return Config(node)
        return node

    def put(self, path: str, value: Any) -> None:
        node = self._data
        parts = path.split(".")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = value

    def __contains__(self, path: str) -> bool:
        return self.get(path, None) is not None

    def __getitem__(self, path: str) -> Any:
        return self.get(path)

    # -- typed accessors (reference API surface) ---------------------------
    def get_int(self, path: str, default: Any = _MISSING) -> int:
        v = self.get(path, default)
        return int(v)

    def get_float(self, path: str, default: Any = _MISSING) -> float:
        v = self.get(path, default)
        return float(v)

    def get_bool(self, path: str, default: Any = _MISSING) -> bool:
        v = self.get(path, default)
        if isinstance(v, str):
            return v.lower() in ("true", "yes", "on", "1")
        return bool(v)

    def get_string(self, path: str, default: Any = _MISSING) -> str:
        v = self.get(path, default)
        return str(v)

    def get_list(self, path: str, default: Any = _MISSING) -> List[Any]:
        v = self.get(path, default)
        if isinstance(v, Config):
            raise TypeError(f"{path} is a config block, not a list")
        return list(v) if v is not None else v

    def get_config(self, path: str, default: Any = _MISSING) -> "Config":
        v = self.get(path, default)
        if isinstance(v, dict):
            return Config(v)
        if isinstance(v, Config) or v is default:
            return v
        raise TypeError(f"{path} is not a config block")

    def as_dict(self) -> Dict[str, Any]:
        return copy.deepcopy(self._data)

    def keys(self):
        return self._data.keys()

    def items(self):
        for k, v in self._data.items():
            yield k, (Config(v) if isinstance(v, dict) else v)

    # kwargs-style expansion used by the reference's **conf.get_config(...)
    def as_plain_dict(self) -> Dict[str, Any]:
        """Shallow dict with nested blocks kept as Config objects."""
        return {k: (Config(v) if isinstance(v, dict) else v) for k, v in self._data.items()}

    # -- serialization ------------------------------------------------------
    def dumps(self) -> str:
        out = io.StringIO()
        _dump_block(self._data, out, indent=0)
        return out.getvalue()

    def dump(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.dumps())

    def __repr__(self) -> str:
        return f"Config({self._data!r})"


def _dump_value(v: Any, out: io.StringIO, indent: int) -> None:
    pad = "    " * indent
    if isinstance(v, dict):
        out.write("{\n")
        _dump_block(v, out, indent + 1)
        out.write(pad + "}")
    elif isinstance(v, (list, tuple)):
        out.write("[\n")
        for item in v:
            out.write(pad + "    ")
            _dump_value(item, out, indent + 1)
            out.write("\n")
        out.write(pad + "]")
    elif isinstance(v, bool):
        out.write("true" if v else "false")
    elif isinstance(v, str):
        out.write(f'"{v}"')
    else:
        out.write(repr(v))


def _dump_block(d: Dict[str, Any], out: io.StringIO, indent: int) -> None:
    pad = "    " * indent
    for k, v in d.items():
        if isinstance(v, dict):
            out.write(f"{pad}{k} ")
            _dump_value(v, out, indent)
            out.write("\n")
        else:
            out.write(f"{pad}{k} = ")
            _dump_value(v, out, indent)
            out.write("\n")


# ---------------------------------------------------------------------------
# Tokenizer + parser
# ---------------------------------------------------------------------------

class _Tokenizer:
    def __init__(self, text: str):
        self.text = text
        self.pos = 0
        self.n = len(text)

    def _skip_ws_and_comments(self, skip_newlines: bool = True):
        while self.pos < self.n:
            c = self.text[self.pos]
            if c in " \t\r" or (skip_newlines and c == "\n"):
                self.pos += 1
            elif c == "#" or self.text.startswith("//", self.pos):
                while self.pos < self.n and self.text[self.pos] != "\n":
                    self.pos += 1
            else:
                break

    def peek(self) -> Optional[str]:
        self._skip_ws_and_comments()
        return self.text[self.pos] if self.pos < self.n else None

    def next_token(self) -> Optional[str]:
        """Return the next structural char or atom."""
        self._skip_ws_and_comments()
        if self.pos >= self.n:
            return None
        c = self.text[self.pos]
        if c in "{}[]=,:":
            self.pos += 1
            return c
        if c == '"':
            return self._read_quoted()
        return self._read_bare()

    def _read_quoted(self) -> str:
        assert self.text[self.pos] == '"'
        self.pos += 1
        start = self.pos
        buf = []
        while self.pos < self.n:
            c = self.text[self.pos]
            if c == "\\" and self.pos + 1 < self.n:
                buf.append(self.text[start:self.pos])
                esc = self.text[self.pos + 1]
                buf.append({"n": "\n", "t": "\t", '"': '"', "\\": "\\"}.get(esc, esc))
                self.pos += 2
                start = self.pos
            elif c == '"':
                buf.append(self.text[start:self.pos])
                self.pos += 1
                return "\x00STR\x00" + "".join(buf)
            else:
                self.pos += 1
        raise ValueError("unterminated string")

    def _read_bare(self) -> str:
        start = self.pos
        while self.pos < self.n and self.text[self.pos] not in " \t\r\n{}[]=,:#\"":
            # handle // comment start inside bare run
            if self.text.startswith("//", self.pos):
                break
            self.pos += 1
        return self.text[start:self.pos]


def _coerce(atom: str) -> Any:
    if atom.startswith("\x00STR\x00"):
        return atom[len("\x00STR\x00"):]
    low = atom.lower()
    if low in ("true", "yes", "on"):
        return True
    if low in ("false", "no", "off"):
        return False
    if low in ("null", "none"):
        return None
    try:
        return int(atom)
    except ValueError:
        pass
    try:
        return float(atom)
    except ValueError:
        pass
    return atom


class _Parser:
    def __init__(self, text: str):
        self.tok = _Tokenizer(text)

    def parse(self) -> Dict[str, Any]:
        root: Dict[str, Any] = {}
        self._parse_block_items(root, top_level=True)
        return root

    def _parse_block_items(self, target: Dict[str, Any], top_level: bool = False):
        while True:
            t = self.tok.next_token()
            if t is None:
                if top_level:
                    return
                raise ValueError("unexpected EOF inside block")
            if t == "}":
                if top_level:
                    raise ValueError("unmatched '}'")
                return
            if t == ",":
                continue
            key = _coerce(t) if t.startswith("\x00STR\x00") else t
            if not isinstance(key, str):
                raise ValueError(f"invalid key {key!r}")
            nxt = self.tok.next_token()
            if nxt in ("=", ":"):
                value = self._parse_value()
            elif nxt == "{":
                value = {}
                self._parse_block_items(value)
            else:
                raise ValueError(f"expected '=' or '{{' after key {key!r}, got {nxt!r}")
            self._assign(target, key, value)

    def _assign(self, target: Dict[str, Any], dotted_key: str, value: Any):
        parts = dotted_key.split(".")
        node = target
        for p in parts[:-1]:
            nxt = node.get(p)
            if not isinstance(nxt, dict):
                nxt = {}
                node[p] = nxt
            node = nxt
        last = parts[-1]
        if isinstance(value, dict) and isinstance(node.get(last), dict):
            node[last].update(value)  # HOCON object merge
        else:
            node[last] = value

    def _parse_value(self) -> Any:
        t = self.tok.next_token()
        if t is None:
            raise ValueError("expected value, got EOF")
        if t == "{":
            block: Dict[str, Any] = {}
            self._parse_block_items(block)
            return block
        if t == "[":
            return self._parse_list()
        return _coerce(t)

    def _parse_list(self) -> List[Any]:
        items: List[Any] = []
        while True:
            c = self.tok.peek()
            if c is None:
                raise ValueError("unterminated list")
            if c == "]":
                self.tok.next_token()
                return items
            if c == ",":
                self.tok.next_token()
                continue
            items.append(self._parse_value())


def parse_string(text: str) -> Config:
    return Config(_Parser(text).parse())


def parse_file(path: Union[str, os.PathLike]) -> Config:
    with open(path, "r") as f:
        return parse_string(f.read())
