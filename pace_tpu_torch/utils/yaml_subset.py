"""A reader and writer for the subset of YAML the driver's configs use.

The port reads its ``DriverConfig`` files without PyYAML: block mappings and
block sequences (indented or not), flow lists and mappings, plain, single-
and double-quoted scalars, and comments. Plain scalars resolve as PyYAML's
``safe_load`` resolves them under its YAML 1.1 rules, which is how
``pace_tpu`` reads the same files: ``~``, ``null`` and an empty value are
``None``; ``yes``/``no``/``true``/``false``/``on``/``off`` (three cases each)
are booleans; ints take ``0b``, ``0x``, octal ``0...`` and base-60 ``1:30``
forms; a float needs a dot in its mantissa and a sign in its exponent
(``1.0e+5``, not ``1e5``, which stays a string); a quoted scalar is always a
string (``"null"`` is the text ``null``).

Anything outside the subset (anchors, aliases, tags, block scalars ``|``
and ``>``, multi-line plain scalars, several documents, timestamps) raises
:class:`YAMLSubsetError` rather than being read differently.

:func:`dump` writes the same subset (sorted keys, block style, indentless
sequences, as ``yaml.safe_dump`` lays a document out) so that both this
reader and PyYAML read it back to the same object.
"""

from __future__ import annotations

import math
import re
from typing import Any, List, Tuple


class YAMLSubsetError(ValueError):
    pass


_BOOL = re.compile(r"^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False|FALSE"
                   r"|on|On|ON|off|Off|OFF)$")
_FLOAT = re.compile(r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
                    |\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?
                    |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
                    |[-+]?\.(?:inf|Inf|INF)
                    |\.(?:nan|NaN|NAN))$""", re.X)
_INT = re.compile(r"""^(?:[-+]?0b[0-1_]+
                    |[-+]?0[0-7_]+
                    |[-+]?(?:0|[1-9][0-9_]*)
                    |[-+]?0x[0-9a-fA-F_]+
                    |[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$""", re.X)
_NULL = re.compile(r"^(?:~|null|Null|NULL|)$")
_TIMESTAMP = re.compile(r"""^(?:[0-9][0-9][0-9][0-9]-[0-9][0-9]-[0-9][0-9]
                    |[0-9][0-9][0-9][0-9] -[0-9][0-9]? -[0-9][0-9]?
                     (?:[Tt]|[ \t]+)[0-9][0-9]?
                     :[0-9][0-9] :[0-9][0-9] (?:\.[0-9]*)?
                     (?:[ \t]*(?:Z|[-+][0-9][0-9]?(?::[0-9][0-9])?))?)$""", re.X)


def _base60(value: str, cast):
    total = cast(0)
    base = 1
    for part in reversed(value.split(":")):
        total += cast(part) * base
        base *= 60
    return total


def _to_int(value: str) -> int:
    value = value.replace("_", "")
    sign = -1 if value[0] == "-" else 1
    if value[0] in "+-":
        value = value[1:]
    if value == "0":
        return 0
    if value.startswith("0b"):
        return sign * int(value[2:], 2)
    if value.startswith("0x"):
        return sign * int(value[2:], 16)
    if value[0] == "0":
        return sign * int(value, 8)
    if ":" in value:
        return sign * _base60(value, int)
    return sign * int(value)


def _to_float(value: str) -> float:
    value = value.replace("_", "").lower()
    sign = -1 if value[0] == "-" else 1
    if value[0] in "+-":
        value = value[1:]
    if value == ".inf":
        return sign * math.inf
    if value == ".nan":
        return math.nan
    if ":" in value:
        return sign * _base60(value, float)
    return sign * float(value)


def resolve_plain(text: str) -> Any:
    """The value of a plain (unquoted) scalar, by PyYAML's safe resolvers in
    their order: bool, float, int, null; timestamps are refused."""
    if text and text[0] in "yYnNtTfFoO" and _BOOL.match(text):
        return text.lower() in ("yes", "true", "on")
    if (not text or text[0] in "-+0123456789.") and _FLOAT.match(text):
        return _to_float(text)
    if (not text or text[0] in "-+0123456789") and _INT.match(text):
        return _to_int(text)
    if _NULL.match(text):
        return None
    if _TIMESTAMP.match(text):
        raise YAMLSubsetError(f"timestamps are outside the YAML subset: {text!r}")
    if text == "<<" or text == "=":
        raise YAMLSubsetError(f"merge and value keys are outside the YAML subset: {text!r}")
    return text


# ---------------------------------------------------------------------------
# reading
# ---------------------------------------------------------------------------
_ESCAPES = {"0": "\0", "a": "\a", "b": "\b", "t": "\t", "\t": "\t", "n": "\n", "v": "\v",
            "f": "\f", "r": "\r", "e": "\x1b", " ": " ", '"': '"', "/": "/", "\\": "\\",
            "N": "\x85", "_": "\xa0", "L": " ", "P": " "}
_HEX = {"x": 2, "u": 4, "U": 8}


def _quoted(s: str, i: int) -> Tuple[str, int]:
    """The quoted scalar starting at ``s[i]``; returns (text, index after)."""
    q = s[i]
    out = []
    i += 1
    while i < len(s):
        c = s[i]
        if q == "'":
            if c == "'":
                if s[i + 1:i + 2] == "'":
                    out.append("'")
                    i += 2
                    continue
                return "".join(out), i + 1
            out.append(c)
            i += 1
            continue
        if c == '"':
            return "".join(out), i + 1
        if c == "\\":
            e = s[i + 1:i + 2]
            if e in _HEX:
                n = _HEX[e]
                out.append(chr(int(s[i + 2:i + 2 + n], 16)))
                i += 2 + n
                continue
            if e not in _ESCAPES:
                raise YAMLSubsetError(f"unknown escape \\{e} in {s!r}")
            out.append(_ESCAPES[e])
            i += 2
            continue
        out.append(c)
        i += 1
    raise YAMLSubsetError(f"unterminated quoted scalar in {s!r}")


def _strip_comment(line: str) -> str:
    """``line`` without a trailing comment (a ``#`` outside quotes at the
    start or after whitespace) and trailing blanks."""
    i = 0
    while i < len(line):
        c = line[i]
        if c in "'\"" and (i == 0 or line[i - 1] in " \t[{,:-"):
            _text, i = _quoted(line, i)
            continue
        if c == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i].rstrip()
        i += 1
    return line.rstrip()


def _depth_change(text: str) -> int:
    """Open minus closed flow brackets of ``text`` outside quotes."""
    depth, i = 0, 0
    while i < len(text):
        c = text[i]
        if c in "'\"" and (i == 0 or text[i - 1] in " \t[{,:-"):
            _text, i = _quoted(text, i)
            continue
        if c in "[{":
            depth += 1
        elif c in "]}":
            depth -= 1
        i += 1
    return depth


class _Flow:
    """Recursive descent over one flow collection or scalar."""

    def __init__(self, text: str):
        self.s = text
        self.i = 0

    def _ws(self):
        while self.i < len(self.s) and self.s[self.i] in " \t":
            self.i += 1

    def node(self):
        self._ws()
        c = self.s[self.i:self.i + 1]
        if c == "[":
            return self._seq()
        if c == "{":
            return self._map()
        if c in ("'", '"'):
            text, self.i = _quoted(self.s, self.i)
            return text
        return resolve_plain(self._plain())

    def _plain(self) -> str:
        start = self.i
        while self.i < len(self.s):
            c = self.s[self.i]
            if c in ",[]{}":
                break
            if c == ":" and self.s[self.i + 1:self.i + 2] in ("", " ", ",", "]", "}"):
                break
            self.i += 1
        text = self.s[start:self.i].strip()
        if text[:1] in ("&", "*", "!", "|", ">", "%", "@", "`"):
            raise YAMLSubsetError(f"{text!r} is outside the YAML subset")
        return text

    def _expect(self, c):
        self._ws()
        if self.s[self.i:self.i + 1] != c:
            raise YAMLSubsetError(f"expected {c!r} at {self.i} of {self.s!r}")
        self.i += 1

    def _seq(self):
        self._expect("[")
        out = []
        while True:
            self._ws()
            if self.s[self.i:self.i + 1] == "]":
                self.i += 1
                return out
            out.append(self.node())
            self._ws()
            if self.s[self.i:self.i + 1] == ",":
                self.i += 1
            elif self.s[self.i:self.i + 1] != "]":
                raise YAMLSubsetError(f"expected ',' or ']' at {self.i} of {self.s!r}")

    def _map(self):
        self._expect("{")
        out = {}
        while True:
            self._ws()
            if self.s[self.i:self.i + 1] == "}":
                self.i += 1
                return out
            key = self.node()
            self._ws()
            value = None
            if self.s[self.i:self.i + 1] == ":":
                self.i += 1
                self._ws()
                if self.s[self.i:self.i + 1] not in (",", "}"):
                    value = self.node()
            out[key] = value
            self._ws()
            if self.s[self.i:self.i + 1] == ",":
                self.i += 1
            elif self.s[self.i:self.i + 1] != "}":
                raise YAMLSubsetError(f"expected ',' or '}}' at {self.i} of {self.s!r}")

    def done(self):
        self._ws()
        if self.i != len(self.s):
            raise YAMLSubsetError(f"unexpected text {self.s[self.i:]!r} in {self.s!r}")


def _inline(text: str):
    """The value of an inline node: a flow collection or a scalar."""
    if text[:1] in ("&", "*", "!", "|", ">", "%", "@", "`"):
        raise YAMLSubsetError(f"{text!r} is outside the YAML subset")
    if text[:1] in ("[", "{", "'", '"'):
        f = _Flow(text)
        value = f.node()
        f.done()
        return value
    if re.search(r":(\s|$)", text):
        raise YAMLSubsetError(f"a plain scalar may not hold ': ': {text!r}")
    return resolve_plain(text)


def _key_split(text: str):
    """(key text, value text) of a block mapping entry, or None when
    ``text`` is no mapping entry."""
    i = 0
    if text[:1] in ("'", '"'):
        _k, i = _quoted(text, 0)
    while i < len(text):
        c = text[i]
        if c in "[{" and i == 0:
            return None
        if c == ":" and (i + 1 == len(text) or text[i + 1] in " \t"):
            return text[:i].rstrip(), text[i + 1:].strip()
        i += 1
    return None


def _is_seq_item(text: str) -> bool:
    return text == "-" or text.startswith("- ")


class _Block:
    def __init__(self, lines: List[Tuple[int, str, int]]):
        #: (indent, content, line number)
        self.lines = lines

    def _err(self, i, msg):
        n = self.lines[i][2] if i < len(self.lines) else "end"
        return YAMLSubsetError(f"line {n}: {msg}")

    def node(self, i: int, ind: int):
        text = self.lines[i][1]
        if _is_seq_item(text):
            return self.seq(i, ind)
        if _key_split(text) is not None:
            return self.mapping(i, ind)
        value = _inline(text)
        if i + 1 < len(self.lines) and self.lines[i + 1][0] > ind:
            raise self._err(i + 1, "multi-line plain scalars are outside the YAML subset")
        return value, i + 1

    def _nested(self, i: int, ind: int, allow_indentless: bool):
        """The block value below a key or item at indent ``ind`` whose own
        line holds no value."""
        if i < len(self.lines):
            nind, ntext, _n = self.lines[i]
            if nind > ind:
                return self.node(i, nind)
            if allow_indentless and nind == ind and _is_seq_item(ntext):
                return self.seq(i, ind)
        return None, i

    def mapping(self, i: int, ind: int):
        out = {}
        while i < len(self.lines):
            lind, text, _n = self.lines[i]
            if lind < ind:
                break
            if lind > ind:
                raise self._err(i, "unexpected indentation")
            if _is_seq_item(text):
                break
            split = _key_split(text)
            if split is None:
                raise self._err(i, f"expected 'key: value', got {text!r}")
            ktext, vtext = split
            key = _inline(ktext) if ktext else None
            if vtext:
                value = _inline(vtext)
                i += 1
                if i < len(self.lines) and self.lines[i][0] > ind:
                    raise self._err(i, "unexpected indentation after a value")
            else:
                value, i = self._nested(i + 1, ind, allow_indentless=True)
            out[key] = value
        return out, i

    def seq(self, i: int, ind: int):
        out = []
        while i < len(self.lines):
            lind, text, n = self.lines[i]
            if lind != ind or not _is_seq_item(text):
                if lind > ind:
                    raise self._err(i, "unexpected indentation in a sequence")
                break
            rest = text[1:].lstrip()
            if not rest:
                value, i = self._nested(i + 1, ind, allow_indentless=False)
            elif _is_seq_item(rest) or _key_split(rest) is not None:
                # a compact nested block: its first line starts after "- "
                col = ind + len(text) - len(rest)
                self.lines[i] = (col, rest, n)
                value, i = self.node(i, col)
            else:
                value = _inline(rest)
                i += 1
                if i < len(self.lines) and self.lines[i][0] > ind:
                    raise self._err(i, "unexpected indentation after an item")
            out.append(value)
        return out, i


def load(text: str):
    """The object of the YAML document ``text``."""
    lines: List[Tuple[int, str, int]] = []
    pending = None
    for n, raw in enumerate(text.splitlines(), start=1):
        if "\t" in raw[:len(raw) - len(raw.lstrip())]:
            raise YAMLSubsetError(f"line {n}: tabs in indentation")
        body = _strip_comment(raw)
        if pending is not None:
            # a flow collection continued from an earlier line
            ind, acc, n0, depth = pending
            acc += " " + body.strip()
            depth += _depth_change(body)
            pending = (ind, acc, n0, depth) if depth > 0 else None
            if pending is None:
                lines.append((ind, acc, n0))
            continue
        if not body.strip():
            continue
        stripped = body.lstrip()
        if stripped.startswith(("%", "---", "...")):
            if stripped in ("---", "...") and not lines:
                continue
            raise YAMLSubsetError(f"line {n}: directives and several documents are outside "
                                  "the YAML subset")
        ind = len(body) - len(stripped)
        depth = _depth_change(stripped)
        if depth > 0:
            pending = (ind, stripped, n, depth)
        else:
            lines.append((ind, stripped, n))
    if pending is not None:
        raise YAMLSubsetError(f"line {pending[2]}: unterminated flow collection")
    if not lines:
        return None
    block = _Block(lines)
    value, i = block.node(0, lines[0][0])
    if i != len(lines):
        raise block._err(i, "unexpected content")
    return value


def safe_load(stream):
    """``load`` of a string or of a file object's text."""
    return load(stream if isinstance(stream, str) else stream.read())


# ---------------------------------------------------------------------------
# writing
# ---------------------------------------------------------------------------
_SAFE_PLAIN = re.compile(r"^[A-Za-z0-9_/][A-Za-z0-9_./{}-]*$")


def _scalar(v) -> str:
    if v is None:
        return "null"
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, int):
        return str(v)
    if isinstance(v, float):
        if math.isnan(v):
            return ".nan"
        if math.isinf(v):
            return ".inf" if v > 0 else "-.inf"
        text = repr(v).lower()
        # a YAML 1.1 float needs a dot in its mantissa
        if "." not in text and "e" in text:
            text = text.replace("e", ".0e", 1)
        return text
    if isinstance(v, str):
        if _SAFE_PLAIN.match(v) and resolve_plain(v) == v:
            return v
        if all(c.isprintable() for c in v):
            return "'" + v.replace("'", "''") + "'"
        return '"' + "".join(
            c if c.isprintable() and c not in '"\\' else
            ("\\" + c if c in '"\\' else f"\\u{ord(c):04x}") for c in v) + '"'
    raise YAMLSubsetError(f"cannot write {type(v).__name__} {v!r}")


def _emit(obj, ind: int) -> List[str]:
    pad = " " * ind
    lines = []
    if isinstance(obj, dict):
        for k in sorted(obj):
            v = obj[k]
            key = _scalar(k)
            if isinstance(v, dict) and v:
                lines.append(f"{pad}{key}:")
                lines += _emit(v, ind + 2)
            elif isinstance(v, (list, tuple)) and v:
                lines.append(f"{pad}{key}:")
                lines += _emit(v, ind)
            else:
                lines.append(f"{pad}{key}: {_inline_out(v)}")
        return lines
    for item in obj:
        if isinstance(item, (dict, list, tuple)) and item:
            sub = _emit(item, ind + 2)
            sub[0] = f"{pad}- " + sub[0][ind + 2:]
            lines += sub
        else:
            lines.append(f"{pad}- {_inline_out(item)}")
    return lines


def _inline_out(v) -> str:
    if isinstance(v, dict):
        return "{}"
    if isinstance(v, (list, tuple)):
        return "[]"
    return _scalar(v)


def dump(obj) -> str:
    """``obj`` (dicts with string keys, lists, tuples, strings, numbers,
    booleans and None) as a block-style document of the subset."""
    if isinstance(obj, (dict, list, tuple)) and obj:
        return "\n".join(_emit(obj, 0)) + "\n"
    return _inline_out(obj) + "\n"
