"""A reader for the YAML subset of the repository's ``configurations/``.

The machine with the card has no PyYAML, so the port reads the config tree
with this module. It gives what ``yaml.load`` with the JAX package's
``_Loader`` gives (a SafeLoader with the YAML-1.2 float rule, so ``5e-5`` is a
float) for the constructs those files use:

- block mappings and block sequences (a sequence may sit at its key's own
  indentation), sequences of mappings (``- key: value``);
- flow sequences ``[a, [b, c]]`` and flow mappings ``{}`` / ``{k: v}`` on one
  line;
- plain, single-quoted and double-quoted scalars; comments;
- literal block scalars ``|`` and ``|-``;
- plain scalars resolved as YAML 1.1 does for null, booleans, decimal ints
  and floats (``.inf``, ``.nan``), plus the YAML-1.2 float form.

Anything else raises :class:`UnsupportedYAML` with its file and line: an
anchor, alias, tag, directive, document marker, complex key, folded or
kept block scalar, multi-line plain or quoted scalar, a flow collection
over several lines, and a plain scalar that YAML 1.1 would resolve to a type
this reader does not build (octal, hex, binary, sexagesimal, numbers with
``_``, timestamps, ``<<``, ``=``). A value is never read silently as
something else. Malformed text raises :class:`YAMLError`.
"""

from __future__ import annotations

import math
import re
from typing import Any, List, Optional, Tuple

__all__ = ["YAMLError", "UnsupportedYAML", "load", "load_file", "parse_scalar", "dump_flow"]


class YAMLError(ValueError):
    """Text that is not valid YAML of the subset's grammar."""


class UnsupportedYAML(YAMLError):
    """Valid YAML that the subset does not read."""


class _Unclosed(YAMLError):
    """A flow collection still open at the end of its line."""


_NULLS = {"", "~", "null", "Null", "NULL"}
_TRUES = {"yes", "Yes", "YES", "true", "True", "TRUE", "on", "On", "ON"}
_FALSES = {"no", "No", "NO", "false", "False", "FALSE", "off", "Off", "OFF"}
_INT = re.compile(r"[-+]?(?:0|[1-9][0-9]*)")
_FLOAT = re.compile(
    r"""[-+]?[0-9]+\.[0-9]*(?:[eE][-+]?[0-9]+)?
    |[-+]?[0-9]+[eE][-+]?[0-9]+
    |\.[0-9]+(?:[eE][-+]?[0-9]+)?
    |[-+]?\.(?:inf|Inf|INF)
    |\.(?:nan|NaN|NAN)""",
    re.X,
)
# what YAML 1.1 (and the YAML-1.2 float rule) resolves beyond the forms above
_OTHER_TYPED = re.compile(
    r"""[-+]?0b[0-1_]+
    |[-+]?0[0-7_]+
    |[-+]?0x[0-9a-fA-F_]+
    |[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+(?:\.[0-9_]*)?
    |[-+]?(?:0|[1-9][0-9_]*)
    |[-+]?[0-9][0-9_]*\.[0-9_]*(?:[eE][-+]?[0-9]+)?
    |[-+]?[0-9][0-9_]*[eE][-+]?[0-9]+
    |\.[0-9_]+(?:[eE][-+]?[0-9]+)?
    |[0-9]{4}-[0-9]{1,2}-[0-9]{1,2}.*
    |<<|=""",
    re.X,
)
_INDICATORS = "&*!%@`|>"  # and "?" or "-" followed by a space


def _fail(cls, msg: str, where: str) -> YAMLError:
    return cls(f"{where}: {msg}")


def resolve_plain(text: str, where: str = "<scalar>") -> Any:
    """A plain scalar's value under the subset's rules."""
    if text in _NULLS:
        return None
    if text in _TRUES:
        return True
    if text in _FALSES:
        return False
    if _INT.fullmatch(text):
        return int(text)
    if _FLOAT.fullmatch(text):
        low = text.lower()
        if low.endswith(".inf"):
            return -math.inf if low.startswith("-") else math.inf
        if low == ".nan":
            return math.nan
        return float(text)
    if _OTHER_TYPED.fullmatch(text):
        raise _fail(UnsupportedYAML, f"plain scalar {text!r} has a YAML type this reader does not build", where)
    return text


def _strip_comment(text: str) -> str:
    """Cut a ``#`` comment (at the start or after whitespace, outside quotes)."""
    quote = None
    for i, ch in enumerate(text):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "'\"" and (i == 0 or text[i - 1] in " \t[{,:-"):
            quote = ch
        elif ch == "#" and (i == 0 or text[i - 1] in " \t"):
            return text[:i].rstrip()
    return text.rstrip()


def _double_quoted(body: str, where: str) -> str:
    escapes = {"\\": "\\", '"': '"', "n": "\n", "t": "\t", "r": "\r", "/": "/", "0": "\0"}
    out, i = [], 0
    while i < len(body):
        ch = body[i]
        if ch == "\\":
            if i + 1 >= len(body) or body[i + 1] not in escapes:
                raise _fail(UnsupportedYAML, f"escape {body[i:i + 2]!r} in a double-quoted scalar", where)
            out.append(escapes[body[i + 1]])
            i += 2
            continue
        out.append(ch)
        i += 1
    return "".join(out)


def _read_quoted(text: str, pos: int, where: str) -> Tuple[str, int]:
    """The quoted scalar starting at ``text[pos]``; returns (value, end)."""
    q = text[pos]
    i = pos + 1
    buf = []
    while i < len(text):
        ch = text[i]
        if q == "'" and ch == "'":
            if i + 1 < len(text) and text[i + 1] == "'":
                buf.append("'")
                i += 2
                continue
            return "".join(buf), i + 1
        if q == '"' and ch == "\\":
            buf.append(text[i:i + 2])
            i += 2
            continue
        if q == '"' and ch == '"':
            return _double_quoted("".join(buf), where), i + 1
        buf.append(ch)
        i += 1
    raise _fail(UnsupportedYAML, "a quoted scalar that does not close on its line", where)


class _Flow:
    """Parser of one line's flow collection."""

    def __init__(self, text: str, where: str):
        self.text, self.pos, self.where = text, 0, where

    def _skip(self) -> None:
        while self.pos < len(self.text) and self.text[self.pos] in " \t":
            self.pos += 1

    def _peek(self) -> str:
        self._skip()
        return self.text[self.pos] if self.pos < len(self.text) else ""

    def parse(self) -> Any:
        value = self._node()
        if self._peek():
            raise _fail(YAMLError, f"text after a flow collection: {self.text[self.pos:]!r}", self.where)
        return value

    def _node(self) -> Any:
        ch = self._peek()
        if ch == "[":
            return self._seq()
        if ch == "{":
            return self._map()
        if ch and ch in "'\"":
            value, self.pos = _read_quoted(self.text, self.pos, self.where)
            return value
        if ch and ch in _INDICATORS:
            raise _fail(UnsupportedYAML, f"indicator {ch!r} in a flow collection", self.where)
        start = self.pos
        while self.pos < len(self.text):
            c = self.text[self.pos]
            if c in ",[]{}":
                break
            if c == ":" and (self.pos + 1 == len(self.text) or self.text[self.pos + 1] in " ,]}"):
                break
            self.pos += 1
        return resolve_plain(self.text[start:self.pos].strip(), self.where)

    def _seq(self) -> List[Any]:
        self.pos += 1
        out: List[Any] = []
        if self._peek() == "]":
            self.pos += 1
            return out
        while True:
            out.append(self._node())
            ch = self._peek()
            if ch == ":":
                raise _fail(UnsupportedYAML, "a mapping inside a flow sequence", self.where)
            self.pos += 1
            if ch == "]":
                return out
            if ch != ",":
                raise _fail(_Unclosed if not ch else YAMLError,
                            "a flow sequence that does not close", self.where)
            if self._peek() == "]":  # trailing comma
                self.pos += 1
                return out

    def _map(self) -> dict:
        self.pos += 1
        out: dict = {}
        if self._peek() == "}":
            self.pos += 1
            return out
        while True:
            key = self._node()
            if self._peek() != ":":
                raise _fail(UnsupportedYAML, "a flow mapping entry without ': '", self.where)
            self.pos += 1
            out[key] = None if self._peek() in ",}" else self._node()
            ch = self._peek()
            self.pos += 1
            if ch == "}":
                return out
            if ch != ",":
                raise _fail(_Unclosed if not ch else YAMLError,
                            "a flow mapping that does not close", self.where)


def _scalar_or_flow(text: str, where: str) -> Any:
    """A value written on one line: flow collection, quoted or plain scalar."""
    if not text:
        return None
    if text[0] in "[{":
        return _Flow(text, where).parse()
    if text[0] in "'\"":
        value, end = _read_quoted(text, 0, where)
        if text[end:].strip():
            raise _fail(YAMLError, f"text after a quoted scalar: {text[end:]!r}", where)
        return value
    if text[0] in _INDICATORS or text[0] in "-?" and text[1:2] in ("", " "):
        raise _fail(UnsupportedYAML, f"value {text!r} starts with an indicator", where)
    if text.startswith("---") or text.startswith("..."):
        raise _fail(UnsupportedYAML, "document markers", where)
    return resolve_plain(text, where)


def _split_key(text: str) -> Optional[Tuple[str, str]]:
    """(key, rest) of a mapping entry, or None when ``text`` is no entry."""
    quote = None
    depth = 0
    for i, ch in enumerate(text):
        if quote:
            if ch == quote:
                quote = None
            continue
        if ch in "'\"" and i == 0:
            quote = ch
        elif ch in "[{":
            depth += 1
        elif ch in "]}":
            depth -= 1
        elif ch == ":" and depth == 0 and (i + 1 == len(text) or text[i + 1] in " \t"):
            return text[:i].rstrip(), text[i + 1:].strip()
    return None


class _Block:
    """Indentation-driven parser of one document."""

    def __init__(self, text: str, source: str):
        self.lines = text.split("\n")
        self.source = source

    def where(self, i: int) -> str:
        return f"{self.source}:{i + 1}"

    def content(self, i: int) -> Tuple[int, str]:
        """(indentation, text without comment) of line i."""
        raw = self.lines[i]
        stripped = raw.lstrip(" ")
        if stripped.startswith("\t") or "\t" in raw[: len(raw) - len(stripped)]:
            raise _fail(UnsupportedYAML, "a tab in indentation", self.where(i))
        return len(raw) - len(stripped), _strip_comment(stripped)

    def next_line(self, i: int) -> Optional[int]:
        """The first line at or after i that holds more than a comment."""
        while i < len(self.lines):
            _, text = self.content(i)
            if text:
                if text.startswith("%") or text in ("---", "...") or text.startswith("--- "):
                    raise _fail(UnsupportedYAML, "directives and document markers", self.where(i))
                return i
            i += 1
        return None

    def document(self) -> Any:
        i = self.next_line(0)
        if i is None:
            return None
        ind, _ = self.content(i)
        value, j = self.node(i, ind)
        j = self.next_line(j)
        if j is not None:
            raise _fail(YAMLError, "text after the document's top-level node", self.where(j))
        return value

    def node(self, i: int, ind: int) -> Tuple[Any, int]:
        _, text = self.content(i)
        if text == "-" or text.startswith("- "):
            return self.sequence(i, ind)
        if text.startswith("? "):
            raise _fail(UnsupportedYAML, "complex mapping keys", self.where(i))
        if _split_key(text) is not None:
            return self.mapping(i, ind)
        value = self.value(text, i)
        self.no_continuation(i, ind)
        return value, i + 1

    def value(self, text: str, i: int) -> Any:
        """The one-line value ``text`` of line i."""
        try:
            return _scalar_or_flow(text, self.where(i))
        except _Unclosed as e:
            if self.next_line(i + 1) is not None:
                raise _fail(UnsupportedYAML, "a flow collection over several lines",
                            self.where(i)) from e
            raise

    def no_continuation(self, i: int, ind: int) -> None:
        j = self.next_line(i + 1)
        if j is not None and self.content(j)[0] > ind:
            raise _fail(UnsupportedYAML, "a value continued on a more indented line", self.where(j))

    def sequence(self, i: int, ind: int) -> Tuple[list, int]:
        out = []
        while True:
            line_ind, text = self.content(i)
            if not (text == "-" or text.startswith("- ")):
                raise _fail(YAMLError, "a sequence entry expected", self.where(i))
            rest = text[1:].lstrip(" ")
            if not rest:  # the item is the block below
                j = self.next_line(i + 1)
                if j is not None and self.content(j)[0] > line_ind:
                    value, i = self.node(j, self.content(j)[0])
                else:
                    value, i = None, i + 1
            else:
                # the item's content as a line of its own, at its own column
                col = line_ind + len(text) - len(rest)
                self.lines[i] = " " * col + rest
                value, i = self.node(i, col)
            out.append(value)
            j = self.next_line(i)
            if j is None:
                return out, len(self.lines)
            next_ind, next_text = self.content(j)
            if next_ind < ind or (next_ind == ind and not next_text.startswith("-")):
                return out, j
            if next_ind != ind:
                raise _fail(YAMLError, "bad indentation in a sequence", self.where(j))
            i = j

    def mapping(self, i: int, ind: int) -> Tuple[dict, int]:
        out: dict = {}
        while True:
            _, text = self.content(i)
            split = _split_key(text)
            if split is None:
                raise _fail(YAMLError, f"a mapping entry expected, got {text!r}", self.where(i))
            key_text, rest = split
            key = _scalar_or_flow(key_text, self.where(i))
            if key == "<<":
                raise _fail(UnsupportedYAML, "merge keys", self.where(i))
            if rest in ("|", "|-"):
                out[key], i = self.block_scalar(i, ind, keep_newline=rest == "|")
            elif rest and rest[0] in "|>":
                raise _fail(UnsupportedYAML, f"block scalar header {rest!r}", self.where(i))
            elif rest:
                out[key] = self.value(rest, i)
                self.no_continuation(i, ind)
                i += 1
            else:
                j = self.next_line(i + 1)
                if j is None:
                    out[key], i = None, len(self.lines)
                else:
                    child_ind, child_text = self.content(j)
                    if child_ind > ind or (
                        child_ind == ind and (child_text == "-" or child_text.startswith("- "))
                    ):
                        out[key], i = self.node(j, child_ind)
                    else:
                        out[key], i = None, i + 1
            j = self.next_line(i)
            if j is None:
                return out, len(self.lines)
            next_ind, _ = self.content(j)
            if next_ind < ind:
                return out, j
            if next_ind > ind:
                raise _fail(YAMLError, "bad indentation in a mapping", self.where(j))
            i = j

    def block_scalar(self, i: int, ind: int, keep_newline: bool) -> Tuple[str, int]:
        body: List[str] = []
        block_ind = None
        j = i + 1
        while j < len(self.lines):
            raw = self.lines[j]
            if raw.strip():
                line_ind = len(raw) - len(raw.lstrip(" "))
                if block_ind is None:
                    if line_ind <= ind:
                        break
                    block_ind = line_ind
                elif line_ind < block_ind:
                    break
                body.append(raw[block_ind:])
            else:
                body.append("")
            j += 1
        while body and not body[-1]:
            body.pop()
        text = "\n".join(body)
        if text and keep_newline:
            text += "\n"
        return text, j


def load(text: str, source: str = "<string>") -> Any:
    """The value of one YAML document in the subset."""
    return _Block(text, source).document()


def load_file(path: str) -> Any:
    with open(path, "r") as f:
        return load(f.read(), path)


def parse_scalar(text: str) -> Any:
    """A command-line value under YAML scalar rules (``[a, b]``, ``4.0``,
    ``null``, ``name``): text that is not valid YAML comes back as it is, as
    the JAX package's ``_parse_scalar`` does; text outside the subset raises."""
    try:
        return load(text, "<command line>")
    except UnsupportedYAML:
        raise
    except YAMLError:
        return text


def _plain_ok(s: str) -> bool:
    if not s or s != s.strip() or s[0] in _INDICATORS + "-?[]{},#'\"":
        return False
    if any(c in s for c in ",[]{}\n") or ": " in s or " #" in s or s.endswith(":"):
        return False
    try:
        return resolve_plain(s) == s
    except UnsupportedYAML:
        return False


def dump_flow(value: Any) -> str:
    """One-line flow text that :func:`parse_scalar` reads back as ``value``
    (the shortcut macros' rendering of a value into an override)."""
    if value is None:
        return "null"
    if isinstance(value, bool):
        return "true" if value else "false"
    if isinstance(value, int):
        return str(value)
    if isinstance(value, float):
        if math.isnan(value):
            return ".nan"
        if math.isinf(value):
            return ".inf" if value > 0 else "-.inf"
        return repr(value)
    if isinstance(value, str):
        return value if _plain_ok(value) else "'" + value.replace("'", "''") + "'"
    if isinstance(value, (list, tuple)):
        return "[" + ", ".join(dump_flow(v) for v in value) + "]"
    if isinstance(value, dict):
        return "{" + ", ".join(f"{dump_flow(k)}: {dump_flow(v)}" for k, v in value.items()) + "}"
    raise TypeError(f"cannot render {type(value).__name__} as YAML")
