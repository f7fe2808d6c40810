"""A YAML loader for the subset the shipped configs use.

Supported: block mappings and block sequences by indentation, ``- key: v``
items, flow sequences and mappings (``[1, [2, 3]]``, ``{a: 1}``) on one line,
comments, single- and double-quoted strings, and plain scalars resolved as
YAML 1.1 / PyYAML does for the forms below: ``null``/``~``/empty, booleans
(``true``/``false``/``yes``/``no``/``on``/``off`` in their three spellings),
decimal integers, floats with a dot (``1.0``, ``.5``, ``1.0e-5``), ``.inf``
and ``.nan``.  Anything else that YAML would treat specially (anchors,
aliases, tags, block scalars, directives, multi-line flow collections,
multiple documents) raises ``YAMLError``, so a config never loads as
something other than what PyYAML would have produced.
"""

import math
import re
from typing import Any, List, Tuple

__all__ = ["YAMLError", "load_yaml"]


class YAMLError(ValueError):
    pass


_BOOL = {
    **{s: True for w in ("true", "yes", "on") for s in (w, w.capitalize(), w.upper())},
    **{s: False for w in ("false", "no", "off") for s in (w, w.capitalize(), w.upper())},
}
_NULL = {"", "~", "null", "Null", "NULL"}
_INT = re.compile(r"[-+]?(?:0|[1-9][0-9_]*)")
_FLOAT = re.compile(r"[-+]?(?:[0-9][0-9_]*\.[0-9_]*|\.[0-9_]+)(?:[eE][-+][0-9]+)?")
_INF = re.compile(r"[-+]?\.(?:inf|Inf|INF)")
_NAN = re.compile(r"\.(?:nan|NaN|NAN)")
_SPECIAL_START = set("&*!|>%@`")
# numbers PyYAML resolves but this loader does not: hex, octal, binary, base 60
_UNSUPPORTED_NUMBER = re.compile(
    r"[-+]?0(?:[0-7_]+|x[0-9a-fA-F_]+|b[01_]+)|[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+(?:\.[0-9_]*)?"
)


def load_yaml(source) -> Any:
    """Parse a YAML document from a string or a text file object."""
    text = source if isinstance(source, str) else source.read()
    if isinstance(text, bytes):
        text = text.decode("utf-8")
    lines = _logical_lines(text)
    if not lines:
        return None
    value, i = _block(lines, 0, lines[0][0])
    if i != len(lines):
        raise YAMLError(f"unexpected content at line {lines[i][2]}: {lines[i][1]!r}")
    return value


def _strip_comment(line: str) -> str:
    quote = None
    i = 0
    while i < len(line):
        ch = line[i]
        if quote:
            if quote == '"' and ch == "\\":
                i += 1  # escaped character
            elif ch == quote:
                if quote == "'" and line[i + 1 : i + 2] == "'":
                    i += 1  # '' is an escaped quote
                else:
                    quote = None
        elif ch in "'\"" and (i == 0 or line[i - 1] in " \t[{,:-"):
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i]
        i += 1
    return line


def _logical_lines(text: str) -> List[Tuple[int, str, int]]:
    """(indent, content, line number) of every non-blank, non-comment line."""
    out = []
    for n, raw in enumerate(text.splitlines(), 1):
        if "\t" in raw[: len(raw) - len(raw.lstrip())]:
            raise YAMLError(f"tab indentation at line {n}")
        line = _strip_comment(raw).rstrip()
        content = line.lstrip(" ")
        if not content:
            continue
        if content.startswith(("%", "---", "...")):
            if content == "---" and not out:
                continue
            raise YAMLError(f"directives and multiple documents are not supported (line {n})")
        out.append((len(line) - len(content), content, n))
    return out


def _block(lines, i, indent):
    content = lines[i][1]
    if content == "-" or content.startswith("- "):
        return _sequence(lines, i, indent)
    return _mapping(lines, i, indent)


def _sequence(lines, i, indent):
    items = []
    while i < len(lines) and lines[i][0] == indent and (lines[i][1] == "-" or lines[i][1].startswith("- ")):
        _, content, n = lines[i]
        rest = content[1:].lstrip(" ")
        if not rest:
            if i + 1 < len(lines) and lines[i + 1][0] > indent:
                value, i = _block(lines, i + 1, lines[i + 1][0])
            else:
                value, i = None, i + 1
        elif _mapping_key(rest) is not None:
            # "- key: value" opens a mapping indented past the dash
            inner = indent + (len(content) - len(rest))
            value, i = _mapping_from(lines, i, inner, rest, n)
        else:
            value, i = _inline(rest, n), i + 1
        items.append(value)
    return items, i


def _mapping_from(lines, i, inner, first, n):
    """Parse the mapping whose first entry ``first`` sits on line ``i``."""
    patched = list(lines)
    patched[i] = (inner, first, n)
    return _mapping(patched, i, inner)


def _mapping_key(content: str):
    """Split ``key: value`` / ``key:``; None when the line is not an entry."""
    if content[0] in "[{":
        return None
    quote = None
    for j, ch in enumerate(content):
        if quote:
            if ch == quote:
                quote = None
            continue
        if ch in "'\"" and j == 0:
            quote = ch
        elif ch == ":" and (j + 1 == len(content) or content[j + 1] == " "):
            return content[:j].strip(), content[j + 1 :].strip()
    return None


def _mapping(lines, i, indent):
    out = {}
    while i < len(lines) and lines[i][0] == indent:
        _, content, n = lines[i]
        entry = _mapping_key(content)
        if entry is None:
            raise YAMLError(f"expected 'key: value' at line {n}: {content!r}")
        key_text, rest = entry
        key = _scalar(key_text, n)
        i += 1
        if rest:
            out[key] = _inline(rest, n)
        elif i < len(lines) and lines[i][0] > indent:
            out[key], i = _block(lines, i, lines[i][0])
        elif i < len(lines) and lines[i][0] == indent and (lines[i][1] == "-" or lines[i][1].startswith("- ")):
            out[key], i = _sequence(lines, i, indent)
        else:
            out[key] = None
    if i < len(lines) and lines[i][0] > indent:
        raise YAMLError(f"bad indentation at line {lines[i][2]}")
    return out, i


def _inline(text: str, n: int):
    if text[0] in "[{":
        value, pos = _flow(text, 0, n)
        if text[pos:].strip():
            raise YAMLError(f"trailing content after flow collection at line {n}")
        return value
    return _scalar(text, n)


def _flow(text: str, pos: int, n: int):
    """Parse a flow collection starting at text[pos]; returns (value, end)."""
    close = "]" if text[pos] == "[" else "}"
    is_map = close == "}"
    out = {} if is_map else []
    pos += 1
    while True:
        pos = _skip_ws(text, pos)
        if pos >= len(text):
            raise YAMLError(f"unterminated flow collection at line {n} (multi-line flow is not supported)")
        if text[pos] == close:
            return out, pos + 1
        if is_map:
            key, pos = _flow_item(text, pos, n, stop=":,}")
            pos = _skip_ws(text, pos)
            if pos >= len(text) or text[pos] != ":":
                raise YAMLError(f"expected ':' in flow mapping at line {n}")
            value, pos = _flow_item(text, pos + 1, n, stop=",}")
            out[key] = value
        else:
            value, pos = _flow_item(text, pos, n, stop=",]")
            out.append(value)
        pos = _skip_ws(text, pos)
        if pos < len(text) and text[pos] == ",":
            pos += 1
        elif pos < len(text) and text[pos] != close:
            raise YAMLError(f"expected ',' or '{close}' at line {n}")


def _skip_ws(text, pos):
    while pos < len(text) and text[pos] == " ":
        pos += 1
    return pos


def _flow_item(text, pos, n, stop):
    pos = _skip_ws(text, pos)
    if pos < len(text) and text[pos] in "[{":
        return _flow(text, pos, n)
    if pos < len(text) and text[pos] in "'\"":
        end = _quote_end(text, pos, n)
        return _scalar(text[pos : end + 1], n), end + 1
    end = pos
    while end < len(text) and text[end] not in stop:
        end += 1
    return _scalar(text[pos:end].strip(), n), end


def _quote_end(text, pos, n):
    quote = text[pos]
    j = pos + 1
    while j < len(text):
        if quote == '"' and text[j] == "\\":
            j += 2
            continue
        if text[j] == quote:
            if quote == "'" and j + 1 < len(text) and text[j + 1] == "'":
                j += 2
                continue
            return j
        j += 1
    raise YAMLError(f"unterminated string at line {n}")


_ESCAPES = {"n": "\n", "t": "\t", "\\": "\\", '"': '"', "/": "/", "0": "\0", "r": "\r"}


def _scalar(text: str, n: int):
    if text[:1] in ("'", '"'):
        if _quote_end(text, 0, n) != len(text) - 1:
            raise YAMLError(f"trailing content after string at line {n}")
        body = text[1:-1]
        if text[0] == "'":
            return body.replace("''", "'")
        out, j = [], 0
        while j < len(body):
            if body[j] == "\\":
                if j + 1 >= len(body) or body[j + 1] not in _ESCAPES:
                    raise YAMLError(f"unsupported escape at line {n}")
                out.append(_ESCAPES[body[j + 1]])
                j += 2
            else:
                out.append(body[j])
                j += 1
        return "".join(out)
    if text in _NULL:
        return None
    if text in _BOOL:
        return _BOOL[text]
    if _INT.fullmatch(text):
        return int(text.replace("_", ""))
    if _FLOAT.fullmatch(text):
        return float(text.replace("_", ""))
    if _INF.fullmatch(text):
        return -math.inf if text.startswith("-") else math.inf
    if _NAN.fullmatch(text):
        return math.nan
    if _UNSUPPORTED_NUMBER.fullmatch(text) or text[0] in _SPECIAL_START or text.startswith(("- ", "? ", ": ")) or ": " in text or " #" in text:
        raise YAMLError(f"unsupported YAML at line {n}: {text!r}")
    return text
