"""Reader and writer for the block-YAML subset that case files use.

Case files (`CASES/*/config.yaml`, the reference's schema) and the batch list
(`cases_to_run.yaml`) use only: nested block maps, block lists (`- item`,
indented or at the key's own indent), one-line flow lists (`[a, b]`),
int/float/bool/null/string scalars (plain or quoted) and `#` comments.
This module reads and writes exactly that subset, so the solver needs no
YAML package.  Anything outside it raises ValueError with the line number.
"""

from __future__ import annotations

import re
from typing import Any, List, Tuple

_BOOL = {
    "true": True, "yes": True, "on": True,
    "false": False, "no": False, "off": False,
}
_NULL = {"", "~", "null"}
_INT = re.compile(r"^[-+]?\d+$")
_FLOAT = re.compile(r"^[-+]?(\d+\.?\d*|\.\d+)([eE][-+]?\d+)?$")


def _strip_comment(line: str) -> str:
    """Drop a `#` comment that is not inside quotes."""
    quote = None
    for i, ch in enumerate(line):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "'\"":
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i]
    return line


def _scalar(text: str, lineno: int) -> Any:
    t = text.strip()
    if len(t) >= 2 and t[0] == t[-1] and t[0] in "'\"":
        return t[1:-1]
    if t.startswith("["):
        if not t.endswith("]"):
            raise ValueError(f"line {lineno}: unterminated flow list: {t!r}")
        body = t[1:-1].strip()
        return [_scalar(v, lineno) for v in body.split(",")] if body else []
    if t == "{}":
        return {}
    if t.startswith(("{", "&", "*", "!", "|", ">")):
        raise ValueError(f"line {lineno}: unsupported YAML construct: {t!r}")
    low = t.lower()
    if low in _NULL:
        return None
    if low in _BOOL:
        return _BOOL[low]
    if _INT.match(t):
        return int(t)
    if _FLOAT.match(t):
        return float(t)
    if low in (".inf", "+.inf", "-.inf", ".nan"):
        return float(low.replace(".", ""))
    return t


def _tokenize(text: str) -> List[Tuple[int, str, int]]:
    """(indent, content, line number) of every non-blank line."""
    out = []
    for n, raw in enumerate(text.splitlines(), 1):
        if "\t" in raw[: len(raw) - len(raw.lstrip())]:
            raise ValueError(f"line {n}: tab indentation")
        line = _strip_comment(raw).rstrip()
        if line.strip() in ("", "---"):
            continue
        out.append((len(line) - len(line.lstrip(" ")), line.strip(), n))
    return out


def _split_key(content: str, lineno: int) -> Tuple[str, str]:
    m = re.match(r"^(\"[^\"]*\"|'[^']*'|[^:]+?)\s*:(\s+(.*))?$", content)
    if not m:
        raise ValueError(f"line {lineno}: expected 'key: value': {content!r}")
    key = m.group(1)
    if key[0] in "'\"":
        key = key[1:-1]
    return key, (m.group(3) or "")


def _parse_block(lines, i: int, indent: int) -> Tuple[Any, int]:
    """Parse the block starting at lines[i], whose lines sit at `indent`."""
    if lines[i][1].startswith("- ") or lines[i][1] == "-":
        return _parse_list(lines, i, indent)
    return _parse_map(lines, i, indent)


def _parse_value(lines, i: int, indent: int, rest: str, lineno: int):
    """Value of a key (or list item) whose inline text is `rest`."""
    if rest:
        return _scalar(rest, lineno), i + 1
    if i + 1 < len(lines):
        nxt_indent, nxt, _ = lines[i + 1]
        if nxt_indent > indent:
            return _parse_block(lines, i + 1, nxt_indent)
        if nxt_indent == indent and (nxt.startswith("- ") or nxt == "-"):
            # a block list at the key's own indent (PyYAML's dump style)
            return _parse_list(lines, i + 1, indent)
    return None, i + 1


def _parse_map(lines, i: int, indent: int) -> Tuple[dict, int]:
    out = {}
    while i < len(lines):
        ind, content, n = lines[i]
        if ind < indent:
            break
        if ind > indent:
            raise ValueError(f"line {n}: unexpected indentation")
        if content.startswith("- "):
            break
        key, rest = _split_key(content, n)
        if key in out:
            raise ValueError(f"line {n}: duplicate key {key!r}")
        out[key], i = _parse_value(lines, i, indent, rest, n)
    return out, i


def _parse_list(lines, i: int, indent: int) -> Tuple[list, int]:
    out = []
    while i < len(lines):
        ind, content, n = lines[i]
        if ind != indent or not (content.startswith("- ") or content == "-"):
            if ind > indent:
                raise ValueError(f"line {n}: unexpected indentation")
            break
        item = content[1:].strip()
        if item and re.match(r"^[^'\"\[][^:]*:(\s|$)", item):
            # "- key: value" opens a map whose keys sit two columns in
            sub = [(indent + 2, item, n)]
            j = i + 1
            while j < len(lines) and lines[j][0] > indent:
                sub.append(lines[j])
                j += 1
            val, _ = _parse_map(sub, 0, indent + 2)
            out.append(val)
            i = j
        else:
            val, i = _parse_value(lines, i, indent, item, n)
            out.append(val)
    return out, i


def loads(text: str) -> Any:
    """Parse a document of the supported subset (None for an empty one)."""
    lines = _tokenize(text)
    if not lines:
        return None
    val, i = _parse_block(lines, 0, lines[0][0])
    if i != len(lines):
        raise ValueError(f"line {lines[i][2]}: unexpected content")
    return val


def load(path: str) -> Any:
    with open(path) as f:
        return loads(f.read())


def _format_scalar(v: Any) -> str:
    if v is None:
        return "null"
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, float) and v != v:
        return ".nan"
    if isinstance(v, float) and abs(v) == float("inf"):
        return ".inf" if v > 0 else "-.inf"
    if isinstance(v, (int, float)):
        return repr(v)
    s = str(v)
    if s == "" or s != s.strip() or _scalar(s, 0) != s or any(c in s for c in ":#[]{}'\""):
        return '"' + s.replace('"', '\\"') + '"'
    return s


def _dump(v: Any, indent: int, out: List[str]) -> None:
    pad = " " * indent
    if isinstance(v, dict):
        for key, val in v.items():
            if isinstance(val, dict) and val:
                out.append(f"{pad}{key}:")
                _dump(val, indent + 2, out)
            elif isinstance(val, (list, tuple)) and val:
                out.append(f"{pad}{key}:")
                _dump(list(val), indent, out)
            elif isinstance(val, (dict, list, tuple)):
                out.append(f"{pad}{key}: {'{}' if isinstance(val, dict) else '[]'}")
            else:
                out.append(f"{pad}{key}: {_format_scalar(val)}")
    elif isinstance(v, (list, tuple)):
        for item in v:
            if isinstance(item, (dict, list, tuple)):
                raise ValueError("nested collections inside lists are not supported")
            out.append(f"{pad}- {_format_scalar(item)}")
    else:
        out.append(pad + _format_scalar(v))


def dumps(data: Any) -> str:
    """Block-style text of nested dicts, lists of scalars and scalars."""
    out: List[str] = []
    _dump(data, 0, out)
    return "\n".join(out) + "\n"


def dump(data: Any, path: str) -> None:
    with open(path, "w") as f:
        f.write(dumps(data))
