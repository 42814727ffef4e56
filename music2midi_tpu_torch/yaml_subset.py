"""A subset of YAML, read and written without yaml.

The configs (``config.yaml``, ``configs/*.yaml``) and the prep stages'
per-song metadata files are YAML, and the card's machine has no PyYAML.
This module reads the subset of YAML those files use and writes what
``yaml.safe_dump`` writes for such values:

  * ``load(text)`` gives the value ``yaml.safe_load(text) or {}`` gives for
    a document in the subset, and raises ValueError, with the line, on any
    other YAML.  The subset: block mappings (plain or quoted keys) at any
    depth; values that are plain scalars (YAML 1.1 resolution, as PyYAML's
    SafeLoader resolves them), single- or double-quoted scalars (over
    several lines too), ``{}``, block sequences of scalars and flow
    sequences (``[...]``) of scalars; ``#`` comments, whole-line and
    trailing; an empty document.  Refused: anchors and aliases, tags,
    several documents and document markers, directives, block scalars
    (``|``, ``>``), complex keys, flow mappings other than ``{}``, nested
    or mapping items in a sequence, tabs outside quotes, and the octal,
    hex, binary, sexagesimal, timestamp and merge forms of a plain scalar.
    A document whose first character is ``{`` is JSON, read as
    ``safe_load`` reads JSON: a number without a dot, or with an unsigned
    exponent, is a string there (``1e-3``), as are ``NaN`` and
    ``Infinity``.
  * ``dump(tree, sort_keys)`` writes the bytes
    ``yaml.safe_dump(tree, sort_keys=sort_keys)`` writes for a mapping of
    str keys to scalars (str, int, float, bool, None), to lists of such
    scalars and to such mappings, by PyYAML's emitter rules at its
    defaults (block style, indent 2, width 80, ASCII only, ``{}`` and
    ``[]`` when empty), and raises ValueError on any other value.

``max_depth`` and ``sequences`` narrow both to a smaller subset (the
metadata files: two levels of mappings, no sequences), and ``comments``
turns the reader's comments off.
"""

from __future__ import annotations

import json
import math
import re
from typing import List, Mapping, Optional, Tuple

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
# what PyYAML's reader refuses in a stream
_NON_PRINTABLE = re.compile("[^\x09\x0A\x0D\x20-\x7E\x85\xA0-\uD7FF"
                            "\uE000-\uFFFD\U00010000-\U0010FFFF]")
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


def _quoted(lines: List[str]) -> str:
    """The lines of one quoted scalar, its quotes included -> its str."""
    quote = lines[0][0]
    text = _fold(lines, quote)
    body = text[1:-1]
    return body.replace("''", "'") if quote == "'" else _double_quoted(body)


def _quote_end(line: str, start: int, quote: str) -> int:
    """The index of the quote that closes a quoted scalar in `line`,
    scanning from `start`, or -1 when it goes on past the line."""
    i = start
    while i < len(line):
        ch = line[i]
        if quote == '"' and ch == "\\":
            i += 2
            continue
        if ch == quote:
            if quote == "'" and line[i + 1:i + 2] == "'":
                i += 2
                continue
            return i
        i += 1
    return -1


def _fail(line: int, what: str):
    raise ValueError(f"line {line}: {what}")


# a mapping entry: its key (quoted or plain) and the text after ": "
_ENTRY = re.compile(r"""^('(?:[^']|'')*'   # single-quoted key
                     |"(?:[^"\\]|\\.)*"    # double-quoted key
                     |[^'"\s#](?:[^:]|:(?=\S))*?)  # plain key
                     :(?:[ ]+(.*))?$""", re.X)
_INDICATORS = "[]{}|>&*!%@`,"


class _Reader:
    """Block structure by indentation over the document's rows."""

    def __init__(self, text: str, comments: bool, sequences: bool,
                 max_depth: Optional[int]):
        self.comments, self.sequences = comments, sequences
        self.max_depth = max_depth
        self.rows: List[Tuple[int, int, str]] = []  # (line, indent, text)
        for n, line in enumerate(text.splitlines(), 1):
            body = line.lstrip(" ")
            row = body.rstrip(" ")
            if not row.strip("\t"):
                row = ""  # a blank row
            elif body.startswith("\t"):
                _fail(n, "a tab in the indentation")
            self.rows.append((n, len(line) - len(body), row))

    def comment(self, text: str) -> bool:
        return self.comments and text.startswith("#")

    def significant(self, i: int) -> bool:
        """Whether row i holds content (not blank, not a comment)."""
        n, _, text = self.rows[i]
        if text.startswith("#") and not self.comments:
            _fail(n, "a comment (outside this subset)")
        return bool(text) and not self.comment(text)

    def next_row(self, i: int) -> int:
        while i < len(self.rows) and not self.significant(i):
            i += 1
        return i

    def block_end(self, i: int, indent: int) -> int:
        """The end of the rows that continue row i's value: blank rows and
        rows indented past `indent`."""
        j = i + 1
        while j < len(self.rows) and (not self.rows[j][2]
                                      or self.rows[j][1] > indent):
            j += 1
        return j

    def is_item(self, i: int) -> bool:
        text = self.rows[i][2]
        return text.startswith("- ") or text == "-"

    def document(self):
        for n, indent, text in self.rows:
            if indent == 0 and text.startswith(("---", "...", "%")):
                _fail(n, f"{text[:3]!r}: document markers and directives "
                         "are outside the subset")
        i = self.next_row(0)
        if i == len(self.rows):
            return {}
        n, indent, text = self.rows[i]
        if self.is_item(i) or text.startswith("? ") or text == "?":
            _fail(n, "the document is not a mapping")
        if _ENTRY.match(text) is None:
            # a document that is one scalar: safe_load's value "or {}"
            if self.value(i, len(self.rows)):
                _fail(n, "the document is not a mapping")
            return {}
        out, i = self.mapping(i, indent, 1)
        if i < len(self.rows):
            _fail(self.rows[i][0], "bad indentation")
        return out

    def mapping(self, i: int, indent: int, depth: int) -> tuple:
        """The block mapping whose keys sit at `indent` from row i on ->
        (its dict, the first row after it)."""
        if self.max_depth is not None and depth > self.max_depth:
            _fail(self.rows[i][0],
                  f"YAML nested deeper than {self.max_depth} levels")
        out: dict = {}
        while True:
            i = self.next_row(i)
            if i == len(self.rows) or self.rows[i][1] < indent:
                return out, i
            n, ind, text = self.rows[i]
            if ind > indent:
                _fail(n, "bad indentation")
            if self.is_item(i):
                _fail(n, "a sequence item where a mapping key was expected")
            m = _ENTRY.match(text)
            if m is None:
                _fail(n, f"unsupported YAML line {text!r}")
            key = self.key(n, m.group(1))
            value = (m.group(2) or "").strip(" ")
            j = self.block_end(i, indent)
            if value and not self.comment(value):
                out[key] = self.value(i, j, first=value)
                i = j
                continue
            k = self.next_row(i + 1)
            if k < len(self.rows) and self.is_item(k) \
                    and self.rows[k][1] >= indent:
                out[key], i = self.sequence(k, self.rows[k][1])
            elif k < j:
                out[key], i = self.mapping(k, self.rows[k][1], depth + 1)
            else:
                out[key], i = None, k

    def key(self, n: int, text: str) -> str:
        text = text.rstrip(" ")
        if text[0] in "'\"":
            return _quoted([text])
        if text[0] in _INDICATORS or (text[0] in "?:-"
                                      and text[1:2] in ("", " ")) \
                or " #" in text or "\t" in text:
            _fail(n, f"unsupported YAML key {text!r}")
        try:
            key = _plain_scalar(text)
        except ValueError as e:
            _fail(n, str(e))
        if type(key) is not str:
            _fail(n, f"the key {text!r} is not a string")
        return key

    def sequence(self, i: int, indent: int) -> tuple:
        """The block sequence whose items sit at `indent` from row i on ->
        (its list, the first row after it)."""
        if not self.sequences:
            _fail(self.rows[i][0], "a sequence (outside this subset)")
        out = []
        while True:
            i = self.next_row(i)
            if i == len(self.rows) or self.rows[i][1] < indent:
                return out, i
            n, ind, text = self.rows[i]
            if ind == indent and not self.is_item(i):
                return out, i  # the parent mapping's next key
            if ind > indent:
                _fail(n, "bad indentation")
            j = self.block_end(i, indent)
            value = text[1:].strip(" ")
            if not value or self.comment(value):
                if self.next_row(i + 1) < j:
                    _fail(n, "a sequence item that is a collection")
                out.append(None)
            else:
                item = self.value(i, j, first=value)
                if isinstance(item, (dict, list)):
                    _fail(n, "a sequence item that is a collection")
                out.append(item)
            i = j

    def value(self, i: int, j: int, first: Optional[str] = None):
        """The value that starts on row i (`first`: its text after the
        key or the item's dash; else the whole row) and may go on over
        rows i+1 .. j-1."""
        n = self.rows[i][0]
        first = self.rows[i][2] if first is None else first
        lines = [(n, first)] + [(r[0], r[2]) for r in self.rows[i + 1:j]]
        if first[0] in "'\"":
            return self.quoted(lines)
        if first[0] == "[":
            if not self.sequences:
                _fail(n, "a flow sequence (outside this subset)")
            return self.flow(lines)
        if first[0] == "{":
            end = first.find("}")
            if end < 0 or first[1:end].strip(" ") \
                    or not self.rest_is_comment(lines, 0, end + 1):
                _fail(n, f"a flow mapping other than {{}}: {first!r}")
            return {}
        return self.plain(lines)

    def rest_is_comment(self, lines, row: int, col: int) -> bool:
        """Whether nothing but comments and blanks follows (row, col)."""
        rest = lines[row][1][col:].lstrip(" ")
        if rest and not self.comment(rest):
            return False
        return all(not t or self.comment(t) for _, t in lines[row + 1:])

    def quoted(self, lines) -> str:
        quote = lines[0][1][0]
        start = 1
        for row, (n, text) in enumerate(lines):
            end = _quote_end(text, start, quote)
            if end >= 0:
                if not self.rest_is_comment(lines, row, end + 1):
                    _fail(n, "text after a quoted scalar")
                return _quoted([t for _, t in lines[:row]]
                               + [text[:end + 1]])
            start = 0
        _fail(lines[0][0], "an unterminated quoted scalar")

    def plain(self, lines):
        texts = []
        for row, (n, text) in enumerate(lines):
            cut = 0 if row and text.startswith("#") else text.find(" #")
            if cut >= 0:
                if not self.comments:
                    _fail(n, "a comment (outside this subset)")
                texts.append(text[:cut].rstrip(" "))
                if not self.rest_is_comment(lines, row, len(text)):
                    _fail(n, "a plain scalar that goes on past a comment")
                break
            texts.append(text)
        while texts and not texts[-1]:
            texts.pop()
        n, first = lines[0][0], texts[0]
        if first[0] in _INDICATORS + "#" or (first[0] in "?:-"
                                             and first[1:2] in ("", " ")):
            _fail(n, f"unsupported YAML value {first!r}")
        for t in texts:
            if "\t" in t:
                _fail(n, "a tab outside quotes")
            if ": " in t or t.endswith(":"):
                _fail(n, f"a mapping inside a value: {t!r}")
        try:
            return _plain_scalar(_fold(texts, ""))
        except ValueError as e:
            _fail(n, str(e))

    def flow(self, lines) -> list:
        """A flow sequence of scalars, over one row or several: each item
        on one row, a comma after each but the last (and the last may
        have one)."""
        out, want_item = [], True
        for row, (n, text) in enumerate(lines):
            col = 1 if row == 0 else 0
            while col < len(text):
                ch = text[col]
                if ch == " ":
                    col += 1
                elif ch == "#" and (col == 0 or text[col - 1] == " "):
                    if not self.comments:
                        _fail(n, "a comment (outside this subset)")
                    break
                elif ch == "]":
                    if not self.rest_is_comment(lines, row, col + 1):
                        _fail(n, "text after a flow sequence")
                    return out
                elif ch == ",":
                    if want_item:
                        _fail(n, "an empty item in a flow sequence")
                    want_item, col = True, col + 1
                elif not want_item:
                    _fail(n, "a flow sequence item without a comma")
                elif ch in "'\"":
                    end = _quote_end(text, col + 1, ch)
                    if end < 0:
                        _fail(n, "a quoted item over several lines")
                    out.append(_quoted([text[col:end + 1]]))
                    want_item, col = False, end + 1
                else:
                    end = col
                    while end < len(text) and text[end] not in ",[]{}" \
                            and text[end:end + 2] != " #":
                        if text[end] == ":" and text[end + 1:end + 2] in (
                                "", " ", ",", "[", "]", "{", "}"):
                            _fail(n, "a mapping inside a flow sequence")
                        end += 1
                    token = text[col:end].rstrip(" ")
                    if not token or token[0] in _INDICATORS + "#?:" \
                            or "\t" in token \
                            or (token[0] == "-" and token[1:2] in ("", " ")):
                        _fail(n, f"unsupported flow item {token!r}")
                    nxt = self.flow_next(lines, row + 1)
                    if end == len(text) and nxt not in (",", "]"):
                        _fail(n, "an unterminated flow sequence"
                              if nxt is None
                              else "a plain item over several lines")
                    try:
                        out.append(_plain_scalar(token))
                    except ValueError as e:
                        _fail(n, str(e))
                    want_item, col = False, end
        _fail(lines[0][0], "an unterminated flow sequence")

    def flow_next(self, lines, row: int):
        """The first character that follows in a flow sequence from `row`
        on (comments and blanks skipped), or None."""
        for _, text in lines[row:]:
            if text and not self.comment(text):
                return text[0]
        return None


def _json_float(token: str):
    # safe_load resolves a JSON number as a YAML 1.1 plain scalar: a
    # float needs a dot and a signed exponent, else it stays a string
    return float(token) if _FLOAT.match(token) else token


_SURROGATE = re.compile(r"\\u[dD][89a-fA-F][0-9a-fA-F]{2}")


def load(text: str, *, comments: bool = True, sequences: bool = True,
         max_depth: Optional[int] = None) -> dict:
    """A document of the subset -> ``yaml.safe_load(text) or {}``; raises
    ValueError ("line N: ...") on any other YAML."""
    text = text[1:] if text.startswith("\ufeff") else text
    bad = _NON_PRINTABLE.search(text)
    if bad:
        _fail(text.count("\n", 0, bad.start()) + 1,
              f"non-printable character {bad.group()!r}")
    stripped = text.lstrip()
    if stripped.startswith("{") and not re.match(r"\{ *\}", stripped):
        return _load_json(text, sequences, max_depth)
    return _Reader(text, comments, sequences, max_depth).document()


def _load_json(text: str, sequences: bool, max_depth: Optional[int]):
    """A JSON document -> what safe_load gives for it."""
    bad = _SURROGATE.search(text)
    if bad:  # PyYAML keeps the two halves of a pair apart
        _fail(text.count("\n", 0, bad.start()) + 1, "a surrogate escape")
    try:
        out = json.loads(text, parse_float=_json_float,
                         parse_constant=lambda token: token)
    except json.JSONDecodeError as e:
        _fail(e.lineno, f"a flow mapping that is not JSON ({e.msg})")

    def check(value, depth):
        if isinstance(value, dict):
            if max_depth is not None and depth > max_depth and value:
                _fail(1, f"YAML nested deeper than {max_depth} levels")
            for v in value.values():
                check(v, depth + 1)
        elif isinstance(value, list):
            if not sequences:
                _fail(1, "a sequence (outside this subset)")
            if any(isinstance(v, (dict, list)) for v in value):
                _fail(1, "a sequence item that is a collection")

    if not isinstance(out, dict):
        _fail(1, "the document is not a mapping")
    check(out, 1)
    return out


# ------------------------------------------------------------------ writer

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
    and of sequences of scalars need: its column, whitespace and
    indention state, and its writers of plain, single-quoted and
    double-quoted scalars."""

    def __init__(self, sequences: bool, max_depth: Optional[int]):
        self.sequences, self.max_depth = sequences, max_depth
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
                  whitespace: bool = False, indention: bool = False) -> None:
        self.write(text if self.whitespace or not need_whitespace
                   else " " + text)
        self.whitespace = whitespace
        self.indention = self.indention and indention

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
        """One scalar as a simple key (``key``), a block mapping's value or
        a sequence item, with PyYAML's SafeRepresenter text and choice of
        style."""
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
            raise ValueError(f"unsupported YAML value {value!r} "
                             f"({type(value).__name__})")
        multiline, plain, single = _styles(text)
        if key and (not text or multiline or len(text) >= 128):
            raise ValueError(f"unsupported YAML key {value!r}")
        self.indent += _INDENT  # a scalar node's indent (increase_indent)
        if implicit and plain and not (key and not text):
            self.plain(text, split=not key)
        elif single:
            self.single_quoted(text, split=not key)
        else:
            self.double_quoted(text, split=not key)
        self.indent -= _INDENT

    def mapping(self, tree: Mapping, sort_keys: bool, depth: int) -> None:
        items = sorted(tree.items()) if sort_keys else list(tree.items())
        for key, value in items:
            if type(key) is not str:
                raise ValueError(f"unsupported YAML key {key!r}")
            self.write_indent()
            self.scalar(key, key=True)
            self.indicator(":", False)
            if isinstance(value, Mapping):
                self.block(value, sort_keys, depth + 1)
            elif type(value) is list:
                self.sequence(value)
            else:
                self.scalar(value, key=False)

    def block(self, tree: Mapping, sort_keys: bool, depth: int) -> None:
        """A mapping node: ``{}`` when empty, else a block mapping one
        indent in from its parent's (at 0 for the document's root)."""
        if self.max_depth is not None and depth > self.max_depth and tree:
            raise ValueError(f"YAML nested deeper than {self.max_depth} "
                             "levels")
        if not tree:
            self.indicator("{", True, whitespace=True)
            self.indicator("}", False)
            return
        outer = self.indent
        self.indent = 0 if depth == 1 else outer + _INDENT
        self.mapping(tree, sort_keys, depth)
        self.indent = outer

    def sequence(self, items: list) -> None:
        """A mapping's sequence value: ``[]`` when empty, else a block
        sequence at the mapping's own indent (PyYAML's indentless
        sequence), one ``- item`` a line."""
        if not self.sequences:
            raise ValueError("a sequence (outside this subset)")
        if not items:
            self.indicator("[", True, whitespace=True)
            self.indicator("]", False)
            return
        for item in items:
            if isinstance(item, (Mapping, list)):
                raise ValueError("a sequence item that is a collection")
            self.write_indent()
            self.indicator("-", True, indention=True)
            self.scalar(item, key=False)


def dump(tree: Mapping, sort_keys: bool = True, *, sequences: bool = True,
         max_depth: Optional[int] = None) -> str:
    """The text ``yaml.safe_dump(tree, sort_keys=sort_keys)`` writes, for a
    mapping of str keys to scalars (str, int, float, bool, None), lists of
    such scalars and such mappings.  Raises ValueError on anything else
    (other types, empty / multiline / 128+-character keys, one container
    at two places, which PyYAML would write as an anchor)."""
    if not isinstance(tree, Mapping):
        raise ValueError(f"the tree must be a mapping, got {type(tree)}")
    seen = set()

    def check(value):
        if isinstance(value, (Mapping, list)):
            if id(value) in seen:
                raise ValueError("one container at two places in the tree")
            seen.add(id(value))
            for v in (value.values() if isinstance(value, Mapping)
                      else value):
                check(v)

    check(tree)
    em = _Emitter(sequences, max_depth)
    em.block(tree, sort_keys, 1)
    em.indent = 0
    em.write_indent()  # the document's end
    return "".join(em.out)
