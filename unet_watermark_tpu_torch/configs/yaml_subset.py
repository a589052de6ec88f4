"""A reader for the YAML subset of the shipped config files, with the
values PyYAML's safe_load gives them (the GPU machine has no PyYAML).

The subset:
  * block maps nested by indentation (spaces), keys plain or quoted;
  * scalars: quoted strings ("..." with backslash escapes, '...' with ''),
    plain strings, decimal ints, floats with a dot (1.0e-5; as YAML 1.1
    reads them, 1e-5 stays a string), .inf/.nan, true/false (and
    yes/no/on/off), null and ~;
  * flow lists of scalars, [a, b];
  * comments, whole-line and after a value.
Anything else raises ValueError naming the line: block lists ("- x"),
flow maps, nested flow lists, anchors, aliases, tags, block scalars
(| and >), documents (---), tabs in indentation, octal, hex and
sexagesimal numbers.
"""
from __future__ import annotations

import json
import re
from typing import Any, Dict, List, Tuple

_INT = re.compile(r"[-+]?(?:0|[1-9][0-9_]*)$")
_FLOAT = re.compile(r"[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?$"
                    r"|\.[0-9_]+(?:[eE][-+][0-9]+)?$")
# numeric forms YAML 1.1 resolves that the subset leaves out
_OTHER_NUMBER = re.compile(
    r"[-+]?0b[01_]+$|[-+]?0[0-7_]+$|[-+]?0x[0-9a-fA-F_]+$"
    r"|[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+(?:\.[0-9_]*)?$")
_BOOLS = {v: b for b, words in ((True, ("yes", "true", "on")),
                                (False, ("no", "false", "off")))
          for w in words for v in (w, w.capitalize(), w.upper())}
_NULLS = ("", "~", "null", "Null", "NULL")
_SPECIAL = {".inf": float("inf"), ".Inf": float("inf"), ".INF": float("inf"),
            "+.inf": float("inf"), "+.Inf": float("inf"),
            "+.INF": float("inf"), "-.inf": float("-inf"),
            "-.Inf": float("-inf"), "-.INF": float("-inf"),
            ".nan": float("nan"), ".NaN": float("nan"), ".NAN": float("nan")}
_ESCAPES = {"\\": "\\", '"': '"', "/": "/", "n": "\n", "t": "\t", "r": "\r",
            "0": "\0", " ": " "}


def _strip_comment(line: str) -> str:
    """The line without a comment: '#' at its start or after whitespace,
    outside quotes."""
    quote = None
    i = 0
    while i < len(line):
        c = line[i]
        if quote:
            if c == "\\" and quote == '"':
                i += 1
            elif c == quote:
                if quote == "'" and line[i + 1:i + 2] == "'":
                    i += 1
                else:
                    quote = None
        elif c in "\"'" and (i == 0 or line[i - 1] in " \t[,:"):
            quote = c
        elif c == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i].rstrip()
        i += 1
    return line.rstrip()


def _quoted(text: str) -> Tuple[str, str]:
    """(the value of the quoted string that starts text, the rest)."""
    q = text[0]
    out = []
    i = 1
    while i < len(text):
        c = text[i]
        if q == '"' and c == "\\":
            esc = text[i + 1:i + 2]
            if esc not in _ESCAPES:
                raise ValueError(f"escape \\{esc} outside the YAML subset")
            out.append(_ESCAPES[esc])
            i += 2
            continue
        if c == q:
            if q == "'" and text[i + 1:i + 2] == "'":
                out.append("'")
                i += 2
                continue
            return "".join(out), text[i + 1:]
        out.append(c)
        i += 1
    raise ValueError(f"unterminated string {text!r}")


def _plain(text: str) -> Any:
    if text in _NULLS:
        return None
    if text in _BOOLS:
        return _BOOLS[text]
    if _INT.match(text):
        return int(text.replace("_", ""))
    if _FLOAT.match(text):
        return float(text.replace("_", ""))
    if text in _SPECIAL:
        return _SPECIAL[text]
    if _OTHER_NUMBER.match(text):
        raise ValueError(f"number {text!r} outside the YAML subset")
    if text[0] in "[]{}&*!|>%@`-?" and not (text[0] == "-" and
                                           text[1:2] not in ("", " ")):
        raise ValueError(f"{text!r} is outside the YAML subset")
    if ": " in text or text.endswith(":") or " #" in text:
        raise ValueError(f"{text!r} is outside the YAML subset")
    return text


def _scalar(text: str) -> Any:
    text = text.strip()
    if text[:1] in ("'", '"'):
        value, rest = _quoted(text)
        if rest.strip():
            raise ValueError(f"text after a quoted string: {text!r}")
        return value
    return _plain(text)


def _flow_list(text: str) -> List[Any]:
    inner = text[1:-1].strip()
    items: List[Any] = []
    while inner:
        if inner[0] in "[{":
            raise ValueError(f"nested flow collection {text!r} is outside "
                             f"the YAML subset")
        if inner[0] in ("'", '"'):
            value, rest = _quoted(inner)
            items.append(value)
            rest = rest.strip()
        else:
            head, sep, rest = inner.partition(",")
            items.append(_plain(head.strip()))
            rest = sep + rest
        if rest and not rest.startswith(","):
            raise ValueError(f"malformed flow list {text!r}")
        inner = rest[1:].strip()
        if not inner and rest:
            raise ValueError(f"trailing comma in flow list {text!r}")
    return items


def load_value(text: str) -> Any:
    """One value: a scalar or a flow list of scalars."""
    text = text.strip()
    if text.startswith("["):
        if not text.endswith("]"):
            raise ValueError(f"unterminated flow list {text!r}")
        return _flow_list(text)
    return _scalar(text)


def _key(text: str, lineno: int) -> Tuple[str, str]:
    """(key, the value's text) of a 'key: value' line."""
    if text[0] in ("'", '"'):
        key, rest = _quoted(text)
        if not rest.startswith(":"):
            raise ValueError(f"line {lineno}: expected ':' after the key")
        return key, rest[1:]
    for i, c in enumerate(text):
        if c == ":" and (i + 1 == len(text) or text[i + 1] == " "):
            key = text[:i].strip()
            if not key or key[0] in "[]{}&*!|>%@`-?":
                raise ValueError(f"line {lineno}: key {key!r} is outside "
                                 f"the YAML subset")
            return key, text[i + 1:]
    raise ValueError(f"line {lineno}: not a 'key: value' line: {text!r}")


def load(text: str) -> Dict[str, Any]:
    """The document's top-level map (None for an empty document)."""
    lines = []
    for lineno, raw in enumerate(text.splitlines(), 1):
        body = _strip_comment(raw)
        if not body.strip():
            continue
        stripped = body.lstrip(" ")
        if stripped[0] == "\t":
            raise ValueError(f"line {lineno}: tab in indentation")
        if body.startswith(("%", "---", "...")):
            raise ValueError(f"line {lineno}: document markers are outside "
                             f"the YAML subset")
        lines.append((lineno, len(body) - len(stripped), stripped))
    if not lines:
        return None
    if lines[0][1] != 0:
        raise ValueError(f"line {lines[0][0]}: the document is indented")
    node, end = _block(lines, 0, 0)
    if end != len(lines):
        raise ValueError(f"line {lines[end][0]}: bad indentation")
    return node


def _block(lines, start: int, indent: int) -> Tuple[Dict[str, Any], int]:
    """The map whose keys sit at `indent`, from lines[start]; (map, index of
    the first line after it)."""
    out: Dict[str, Any] = {}
    i = start
    while i < len(lines):
        lineno, ind, text = lines[i]
        if ind < indent:
            break
        if ind > indent:
            raise ValueError(f"line {lineno}: bad indentation")
        if text.startswith("- ") or text == "-":
            raise ValueError(f"line {lineno}: block lists are outside the "
                             f"YAML subset")
        key, rest = _key(text, lineno)
        rest = rest.strip()
        i += 1
        if rest:
            if rest[0] in "|>":
                raise ValueError(f"line {lineno}: block scalars are outside "
                                 f"the YAML subset")
            try:
                out[key] = load_value(rest)
            except ValueError as e:
                raise ValueError(f"line {lineno}: {e}") from None
            if i < len(lines) and lines[i][1] > indent:
                raise ValueError(f"line {lines[i][0]}: bad indentation")
        elif i < len(lines) and lines[i][1] > indent:
            out[key], i = _block(lines, i, lines[i][1])
        else:
            out[key] = None
    return out, i


def _dump_scalar(v: Any) -> str:
    if v is None:
        return "null"
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, int):
        return str(v)
    if isinstance(v, float):
        if v != v:
            return ".nan"
        if v in (float("inf"), float("-inf")):
            return ".inf" if v > 0 else "-.inf"
        text = repr(v)
        if "." not in text and "e" in text:  # 1e-06 → 1.0e-06, a YAML float
            mant, _, exp = text.partition("e")
            text = f"{mant}.0e{exp}"
        return text
    if isinstance(v, str):
        return json.dumps(v)  # a double-quoted YAML scalar
    raise ValueError(f"cannot write {type(v).__name__} into the YAML subset")


def dump(tree: Dict[str, Any], indent: int = 0) -> str:
    """The inverse of load for a map of scalars and nested (non-empty)
    maps: block maps indented by two spaces, strings double-quoted, floats with a dot
    (as PyYAML writes them), so both this reader and PyYAML's safe_load
    give back the same values."""
    lines = []
    pad = " " * indent
    for key, v in tree.items():
        if isinstance(v, dict):
            if not v:
                raise ValueError(f"empty map {key!r}: outside the YAML "
                                 f"subset")
            lines.append(f"{pad}{key}:")
            lines.append(dump(v, indent + 2).rstrip("\n"))
        else:
            lines.append(f"{pad}{key}: {_dump_scalar(v)}")
    return "\n".join(lines) + "\n"
