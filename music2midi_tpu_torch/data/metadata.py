"""Per-song metadata files, read and written without yaml.

The prep stages keep each song's metadata in ``metadata/{id}.yaml``: a
mapping whose values are scalars (str, int, float, bool, None) or mappings
of scalars, as ``data/download_youtube.py`` and the JAX package's stages
write it with ``yaml.safe_dump``.  The port has no yaml, so:

  * ``read_metadata`` gives the value ``yaml.safe_load`` gives for such a
    file, and raises ValueError on any other YAML;
  * ``dump_metadata`` writes the bytes ``yaml.safe_dump(meta)`` (or, with
    ``sort_keys=False``, ``yaml.safe_dump(meta, sort_keys=False)``) writes
    for such a value, by PyYAML's emitter rules at its defaults (block
    style, indent 2, width 80, ASCII only, ``{}`` for an empty mapping),
    and raises ValueError on any other value.
"""

from __future__ import annotations

import math
import re
from typing import List, Mapping

# YAML 1.1 plain-scalar resolution, as PyYAML's SafeLoader resolves it,
# for the forms yaml.safe_dump writes (null, bools, decimal ints, floats);
# a plain scalar of another resolvable form (octal, hex, binary or
# sexagesimal numbers, timestamps, merge keys) raises
_NULL = re.compile(r"^(?:~|null|Null|NULL|)$")
_BOOL = re.compile(r"^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False"
                   r"|FALSE|on|On|ON|off|Off|OFF)$")
_DECIMAL = re.compile(r"^[-+]?(?:0|[1-9][0-9_]*)$")
_FLOAT = re.compile(r"""^(?:[-+]?[0-9][0-9_]*\.[0-9_]*(?:[eE][-+][0-9]+)?
                    |\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?)$""", re.X)
_INF_NAN = re.compile(r"^(?:[-+]?\.(?:inf|Inf|INF)|\.(?:nan|NaN|NAN))$")
_UNSUPPORTED = re.compile(r"""^(?:[-+]?0b[0-1_]+|[-+]?0[0-7_]+
                          |[-+]?0x[0-9a-fA-F_]+
                          |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+(?:\.[0-9_]*)?
                          |[0-9]{4}-[0-9]{1,2}-[0-9]{1,2}.*|<<|=)$""", re.X)
_ESCAPES = {"0": "\0", "a": "\a", "b": "\b", "t": "\t", "\t": "\t",
            "n": "\n", "v": "\v", "f": "\f", "r": "\r", "e": "\x1b",
            " ": " ", '"': '"', "/": "/", "\\": "\\", "N": "\x85",
            "_": "\xa0", "L": "\u2028", "P": "\u2029"}
_HEX_ESCAPES = {"x": 2, "u": 4, "U": 8}


def _plain_scalar(text: str):
    """A plain scalar -> None / bool / int / float / str (YAML 1.1)."""
    if _NULL.match(text):
        return None
    if _BOOL.match(text):
        return text.lower() in ("yes", "true", "on")
    if _DECIMAL.match(text):
        return int(text.replace("_", ""))
    if _FLOAT.match(text):
        return float(text.replace("_", ""))
    if _INF_NAN.match(text):
        return float(text.lower().replace(".", ""))
    if _UNSUPPORTED.match(text):
        raise ValueError(f"unsupported YAML scalar {text!r}")
    return text


def _double_quoted(body: str) -> str:
    out, i = [], 0
    while i < len(body):
        ch = body[i]
        if ch != "\\":
            out.append(ch)
            i += 1
            continue
        code = body[i + 1]
        if code in _HEX_ESCAPES:
            n = _HEX_ESCAPES[code]
            out.append(chr(int(body[i + 2:i + 2 + n], 16)))
            i += 2 + n
        elif code in _ESCAPES:
            out.append(_ESCAPES[code])
            i += 2
        else:
            raise ValueError(f"unsupported YAML escape \\{code}")
    return "".join(out)


def _fold(lines: List[str], quote: str) -> str:
    """Join a scalar's lines by YAML line folding: a line break is a
    space, each empty line a newline; in double quotes a break after an
    unescaped backslash joins the lines."""
    text, breaks = lines[0], 0
    for line in lines[1:]:
        if not line:
            breaks += 1
            continue
        trailing = len(text) - len(text.rstrip("\\"))
        if quote == '"' and not breaks and trailing % 2 == 1:
            text = text[:-1] + line
        else:
            text += "\n" * breaks if breaks else " "
            text += line
        breaks = 0
    return text


def _scalar(lines: List[str]):
    """The lines of one scalar (the first after ``key:``, then its
    continuation lines, stripped; "" for an empty line) -> its value."""
    first = lines[0]
    quote = first[0] if first[0] in "'\"" else ""
    text = _fold(lines, quote)
    if quote:
        if len(text) < 2 or not text.endswith(quote):
            raise ValueError(f"unterminated YAML scalar {text!r}")
        body = text[1:-1]
        return body.replace("''", "'") if quote == "'" \
            else _double_quoted(body)
    if text == "{}":
        return {}
    if first[0] in "[{|>&*!%@`#" or first in ("-", "?") \
            or first.startswith(("- ", "? ")) or " #" in text \
            or any(line.startswith("#") for line in lines):
        raise ValueError(f"unsupported YAML value {text!r}")
    return _plain_scalar(text)


_ENTRY = re.compile(r"""^('(?:[^']|'')*'   # single-quoted key
                     |"(?:[^"\\]|\\.)*"    # double-quoted key
                     |[^'"\s#](?:[^:]|:(?=\S))*?)  # plain key
                     :(?:\s+(.*))?$""", re.X)


def read_metadata(text: str) -> dict:
    """A metadata file as ``yaml.safe_dump`` writes it -> the same value
    ``yaml.safe_load`` gives: a mapping whose values are scalars or
    mappings of scalars (``{}`` for an empty one).  Raises ValueError on
    any other YAML (sequences, flow collections, block scalars, anchors,
    tags, deeper nesting)."""
    rows = [(len(line) - len(line.lstrip(" ")), line.strip())
            for line in text.splitlines()]
    while rows and not rows[-1][1]:
        rows.pop()
    while rows and not rows[0][1]:
        rows.pop(0)
    if [r[1] for r in rows] == ["{}"]:
        return {}

    def entries(i: int, indent: int, into: dict, depth: int) -> int:
        while i < len(rows) and rows[i][0] == indent and rows[i][1]:
            m = _ENTRY.match(rows[i][1])
            if m is None:
                raise ValueError(f"unsupported YAML line {rows[i][1]!r}")
            key = m.group(1)
            key = _scalar([key]) if key[0] in "'\"" else key
            value = (m.group(2) or "").strip()
            i += 1
            j = i  # the value's continuation lines (and empty lines)
            while j < len(rows) and (not rows[j][1] or rows[j][0] > indent):
                j += 1
            while j > i and not rows[j - 1][1]:
                j -= 1
            if value:
                into[key] = _scalar([value] + [r[1] for r in rows[i:j]])
                i = j
            elif j > i:
                if depth == 2:
                    raise ValueError("YAML nested deeper than two levels")
                into[key] = {}
                i = entries(i, rows[i][0], into[key], depth + 1)
            else:
                into[key] = None
        return i

    out: dict = {}
    if entries(0, 0, out, 1) != len(rows):
        raise ValueError("unsupported YAML layout")
    return out


# PyYAML's implicit resolvers (yaml/resolver.py), each tried only on a
# scalar whose first character is one of its own: a str whose plain form
# one of them takes is quoted on output
_RESOLVERS = (
    ("yYnNtTfFoO", re.compile(r"""^(?:yes|Yes|YES|no|No|NO
                    |true|True|TRUE|false|False|FALSE
                    |on|On|ON|off|Off|OFF)$""", re.X)),
    ("-+0123456789.", re.compile(
        r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
                    |\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?
                    |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
                    |[-+]?\.(?:inf|Inf|INF)
                    |\.(?:nan|NaN|NAN))$""", re.X)),
    ("-+0123456789", re.compile(r"""^(?:[-+]?0b[0-1_]+
                    |[-+]?0[0-7_]+
                    |[-+]?(?:0|[1-9][0-9_]*)
                    |[-+]?0x[0-9a-fA-F_]+
                    |[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$""", re.X)),
    ("<", re.compile(r"^(?:<<)$")),
    (("~", "n", "N", ""), re.compile(r"""^(?: ~
                    |null|Null|NULL
                    | )$""", re.X)),
    ("0123456789", re.compile(
        r"""^(?:[0-9][0-9][0-9][0-9]-[0-9][0-9]-[0-9][0-9]
                    |[0-9][0-9][0-9][0-9] -[0-9][0-9]? -[0-9][0-9]?
                     (?:[Tt]|[ \t]+)[0-9][0-9]?
                     :[0-9][0-9] :[0-9][0-9] (?:\.[0-9]*)?
                     (?:[ \t]*(?:Z|[-+][0-9][0-9]?(?::[0-9][0-9])?))?)$""",
        re.X)),
    ("=", re.compile(r"^(?:=)$")),
    ("!&*", re.compile(r"^(?:!|&|\*)$")),
)
_BREAKS = "\n\x85\u2028\u2029"
_BLANK = "\0 \t\r\n\x85\u2028\u2029"
_WRITE_ESCAPES = {"\0": "0", "\x07": "a", "\x08": "b", "\t": "t",
                  "\n": "n", "\x0b": "v", "\x0c": "f", "\r": "r",
                  "\x1b": "e", '"': '"', "\\": "\\", "\x85": "N",
                  "\xa0": "_", "\u2028": "L", "\u2029": "P"}
_WIDTH, _INDENT = 80, 2  # PyYAML's best_width and best_indent


def _resolves_to_str(value: str) -> bool:
    first = value[0] if value else ""
    return not any(first in chars and rx.match(value)
                   for chars, rx in _RESOLVERS)


def _styles(text: str) -> tuple:
    """PyYAML's ``analyze_scalar`` at allow_unicode=False -> (multiline,
    plain allowed in a block, single quotes allowed)."""
    if not text:
        return False, True, True
    block_ind = text.startswith(("---", "..."))
    line_breaks = special = False
    leading = trailing = break_space = space_break = False
    prev_space = prev_break = False
    preceded_ws = True
    followed_ws = len(text) == 1 or text[1] in _BLANK
    for i, ch in enumerate(text):
        if i == 0:
            if ch in "#,[]{}&*!|>'\"%@`" or (ch in "?:-" and followed_ws):
                block_ind = True
        elif (ch == ":" and followed_ws) or (ch == "#" and preceded_ws):
            block_ind = True
        if ch in _BREAKS:
            line_breaks = True
        if not (ch == "\n" or "\x20" <= ch <= "\x7e"):
            special = True  # ASCII only: escaped in double quotes
        if ch == " ":
            leading |= i == 0
            trailing |= i == len(text) - 1
            break_space |= prev_break
            prev_space, prev_break = True, False
        elif ch in _BREAKS:
            leading |= i == 0
            trailing |= i == len(text) - 1
            space_break |= prev_space
            prev_space, prev_break = False, True
        else:
            prev_space = prev_break = False
        preceded_ws = ch in _BLANK
        followed_ws = i + 2 >= len(text) or text[i + 2] in _BLANK
    plain = not (leading or trailing or break_space or space_break
                 or special or line_breaks or block_ind)
    single = not (break_space or space_break or special)
    return line_breaks, plain, single


class _Emitter:
    """The slice of PyYAML's ``Emitter`` that block mappings of scalars
    need: its column, whitespace and indention state, and its writers of
    plain, single-quoted and double-quoted scalars."""

    def __init__(self):
        self.out: List[str] = []
        self.column = 0
        self.indent = 0
        self.whitespace = self.indention = True

    def write(self, data: str) -> None:
        self.column += len(data)
        self.out.append(data)

    def line_break(self, data: str = "\n") -> None:
        self.whitespace = self.indention = True
        self.column = 0
        self.out.append(data)

    def write_indent(self) -> None:
        if (not self.indention or self.column > self.indent
                or (self.column == self.indent and not self.whitespace)):
            self.line_break()
        if self.column < self.indent:
            self.whitespace = True
            self.write(" " * (self.indent - self.column))

    def indicator(self, text: str, need_whitespace: bool,
                  whitespace: bool = False) -> None:
        self.write(text if self.whitespace or not need_whitespace
                   else " " + text)
        self.whitespace = whitespace
        self.indention = False

    def breaks(self, text: str) -> None:
        if text[0] == "\n":
            self.line_break()
        for br in text:
            self.line_break(br)
        self.write_indent()

    def plain(self, text: str, split: bool) -> None:
        if not text:
            return
        if not self.whitespace:
            self.write(" ")
        self.whitespace = self.indention = False
        spaces = breaks = False
        start = 0
        for end in range(len(text) + 1):
            ch = text[end] if end < len(text) else None
            if spaces:
                if ch != " ":
                    if start + 1 == end and self.column > _WIDTH and split:
                        self.write_indent()
                        self.whitespace = self.indention = False
                    else:
                        self.write(text[start:end])
                    start = end
            elif breaks:
                if ch is None or ch not in _BREAKS:
                    self.breaks(text[start:end])
                    self.whitespace = self.indention = False
                    start = end
            elif ch is None or ch in " " + _BREAKS:
                self.write(text[start:end])
                start = end
            if ch is not None:
                spaces, breaks = ch == " ", ch in _BREAKS

    def single_quoted(self, text: str, split: bool) -> None:
        self.indicator("'", True)
        spaces = breaks = False
        start = 0
        for end in range(len(text) + 1):
            ch = text[end] if end < len(text) else None
            if spaces:
                if ch is None or ch != " ":
                    if (start + 1 == end and self.column > _WIDTH and split
                            and start != 0 and end != len(text)):
                        self.write_indent()
                    else:
                        self.write(text[start:end])
                    start = end
            elif breaks:
                if ch is None or ch not in _BREAKS:
                    self.breaks(text[start:end])
                    start = end
            elif ch is None or ch in " '" + _BREAKS:
                if start < end:
                    self.write(text[start:end])
                    start = end
            if ch == "'":
                self.write("''")
                start = end + 1
            if ch is not None:
                spaces, breaks = ch == " ", ch in _BREAKS
        self.indicator("'", False)

    def double_quoted(self, text: str, split: bool) -> None:
        self.indicator('"', True)
        start = 0
        for end in range(len(text) + 1):
            ch = text[end] if end < len(text) else None
            if ch is None or ch in '"\\\x85\u2028\u2029\ufeff' \
                    or not "\x20" <= ch <= "\x7e":
                if start < end:
                    self.write(text[start:end])
                    start = end
                if ch is not None:
                    if ch in _WRITE_ESCAPES:
                        self.write("\\" + _WRITE_ESCAPES[ch])
                    elif ch <= "\xff":
                        self.write("\\x%02X" % ord(ch))
                    elif ch <= "\uffff":
                        self.write("\\u%04X" % ord(ch))
                    else:
                        self.write("\\U%08X" % ord(ch))
                    start = end + 1
            if (0 < end < len(text) - 1 and (ch == " " or start >= end)
                    and self.column + (end - start) > _WIDTH and split):
                self.write(text[start:end] + "\\")
                start = max(start, end)
                self.write_indent()
                self.whitespace = self.indention = False
                if text[start] == " ":
                    self.write("\\")
        self.indicator('"', False)

    def scalar(self, value, key: bool) -> None:
        """One scalar as a simple key (``key``) or a block mapping's value,
        with PyYAML's SafeRepresenter text and choice of style."""
        if value is None:
            text, implicit = "null", True
        elif type(value) is bool:
            text, implicit = ("true" if value else "false"), True
        elif type(value) is int:
            text, implicit = str(value), True
        elif type(value) is float:
            if math.isnan(value):
                text = ".nan"
            elif math.isinf(value):
                text = ".inf" if value > 0 else "-.inf"
            else:
                text = repr(value).lower()
                if "." not in text and "e" in text:
                    text = text.replace("e", ".0e", 1)
            implicit = True
        elif type(value) is str:
            text, implicit = value, _resolves_to_str(value)
        else:
            raise ValueError(f"unsupported metadata value {value!r} "
                             f"({type(value).__name__})")
        multiline, plain, single = _styles(text)
        if key and (not text or multiline or len(text) >= 128):
            raise ValueError(f"unsupported metadata key {value!r}")
        self.indent += _INDENT  # a scalar node's indent (increase_indent)
        if implicit and plain and not (key and not text):
            self.plain(text, split=not key)
        elif single:
            self.single_quoted(text, split=not key)
        else:
            self.double_quoted(text, split=not key)
        self.indent -= _INDENT

    def mapping(self, meta: Mapping, sort_keys: bool, depth: int) -> None:
        items = sorted(meta.items()) if sort_keys else list(meta.items())
        for key, value in items:
            if type(key) is not str:
                raise ValueError(f"unsupported metadata key {key!r}")
            self.write_indent()
            self.scalar(key, key=True)
            self.indicator(":", False)
            if isinstance(value, Mapping):
                if depth == 2 and value:
                    raise ValueError("metadata nested deeper than two levels")
                self.block(value, sort_keys, depth + 1)
            else:
                self.scalar(value, key=False)

    def block(self, meta: Mapping, sort_keys: bool, depth: int) -> None:
        """A mapping node: ``{}`` when empty, else a block mapping one
        indent in from its parent's (at 0 for the document's root)."""
        if not meta:
            self.indicator("{", True, whitespace=True)
            self.indicator("}", False)
            return
        outer = self.indent
        self.indent = 0 if depth == 1 else outer + _INDENT
        self.mapping(meta, sort_keys, depth)
        self.indent = outer


def dump_metadata(meta: Mapping, sort_keys: bool = True) -> str:
    """The text ``yaml.safe_dump(meta, sort_keys=sort_keys)`` writes, for a
    mapping of str keys to scalars (str, int, float, bool, None) or to
    mappings of such scalars.  Raises ValueError on anything else (other
    types, deeper nesting, empty / multiline / 128+-character keys, one
    mapping object at two places, which PyYAML would write as an
    anchor)."""
    if not isinstance(meta, Mapping):
        raise ValueError(f"metadata must be a mapping, got {type(meta)}")
    nested = [id(v) for v in meta.values() if isinstance(v, Mapping)]
    if len(set(nested)) != len(nested) or id(meta) in nested:
        raise ValueError("one mapping at two places in the metadata")
    em = _Emitter()
    em.block(meta, sort_keys, 1)
    em.indent = 0
    em.write_indent()  # the document's end
    return "".join(em.out)
