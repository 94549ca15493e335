"""Kubernetes manifests without PyYAML: a loader for the block-style YAML
subset the repo's demo specs and DeviceClass manifests are written in.

The port stands alone (no ``yaml`` import), yet the local process cluster
applies ``demo/specs/quickstart-gpu/*.yaml`` and the GPU chart's
DeviceClasses unchanged. :func:`load_all` reads what those files use:

- documents split by ``---`` (and ended by ``...``), ``#`` comments;
- block mappings and block sequences, a sequence item opening a mapping
  (``- name: x``), a mapping value's sequence at the key's own indent;
- flow sequences (``["python", "-c"]``, ``[mig]``);
- double-quoted scalars, and plain scalars resolved as PyYAML's safe loader
  resolves them (null, booleans, integers, floats, strings).

Anything else (flow mappings, single-quoted and block scalars, anchors,
tags, multi-line scalars) raises :class:`ManifestError` instead of being
misread;
``tests/test_torch_deployments.py`` holds the loader to ``yaml.safe_load_all``
on every spec and DeviceClass file.
"""

from __future__ import annotations

import re
from pathlib import Path
from typing import Any, Optional


class ManifestError(ValueError):
    pass


_INT_RE = re.compile(r"^[-+]?(0|[1-9][0-9_]*)$")
# PyYAML's (YAML 1.1) float: a dot is required ("1e-3" stays a string).
_FLOAT_RE = re.compile(r"^[-+]?([0-9][0-9_]*)?\.[0-9_]*([eE][-+][0-9]+)?$")
_NULLS = {"", "~", "null", "Null", "NULL"}
_TRUE = {"true", "True", "TRUE", "yes", "Yes", "YES", "on", "On", "ON"}
_FALSE = {"false", "False", "FALSE", "no", "No", "NO", "off", "Off", "OFF"}


def _plain(text: str) -> Any:
    """A plain scalar, resolved as YAML 1.1's core schema (PyYAML) does."""
    if text in _NULLS:
        return None
    if text in _TRUE:
        return True
    if text in _FALSE:
        return False
    if _INT_RE.match(text) and any(c.isdigit() for c in text):
        return int(text.replace("_", ""))
    if _FLOAT_RE.match(text) and any(c.isdigit() for c in text):
        return float(text.replace("_", ""))
    if text[:1] in ("&", "*", "!", "|", ">", "@", "`", "'", "{"):
        raise ManifestError(f"unsupported YAML construct: {text!r}")
    return text


def _strip_comment(text: str) -> str:
    """Cut a trailing ``# comment`` (a ``#`` after whitespace, outside
    quotes) and trailing blanks."""
    quote = ""
    escaped = False
    for i, c in enumerate(text):
        if quote:
            if escaped:
                escaped = False
            elif c == "\\" and quote == '"':
                escaped = True
            elif c == quote:
                quote = ""
        elif c == '"' and (i == 0 or text[i - 1] in " [,:"):
            quote = c
        elif c == "#" and (i == 0 or text[i - 1] in " \t"):
            return text[:i].rstrip()
    return text.rstrip()


def _split_key(text: str) -> Optional[tuple[str, str]]:
    """``key: value`` → (key, value); None when the line is no mapping
    entry (a colon inside quotes or flow brackets does not count)."""
    quote = False
    depth = 0
    for i, c in enumerate(text):
        if quote:
            quote = c != '"'
        elif c == '"' and i == 0:
            quote = True
        elif c == "[":
            depth += 1
        elif c == "]":
            depth -= 1
        elif (c == ":" and depth == 0
              and (i + 1 == len(text) or text[i + 1] in " \t")):
            return text[:i].rstrip(), text[i + 1:].strip()
    return None


class _Flow:
    """A flow sequence or a double-quoted scalar on one line."""

    def __init__(self, text: str):
        self.s = text
        self.i = 0

    def _ws(self) -> None:
        while self.i < len(self.s) and self.s[self.i] in " \t":
            self.i += 1

    def value(self, in_flow: bool) -> Any:
        """The next value; ``in_flow``: inside a sequence, where ``,`` and
        ``]`` end a plain scalar."""
        self._ws()
        c = self.s[self.i:self.i + 1]
        if c == "[":
            self.i += 1
            out = []
            self._ws()
            if self.s[self.i:self.i + 1] == "]":
                self.i += 1
                return out
            while True:
                out.append(self.value(True))
                self._ws()
                c = self.s[self.i:self.i + 1]
                self.i += 1
                if c == "]":
                    return out
                if c != ",":
                    raise ManifestError(f"bad flow sequence: {self.s!r}")
        if c == '"':
            return self._double()
        start = self.i
        stop = ",]" if in_flow else ""
        while self.i < len(self.s) and self.s[self.i] not in stop:
            self.i += 1
        return _plain(self.s[start:self.i].strip())

    def _double(self) -> str:
        out = []
        self.i += 1
        escapes = {"n": "\n", "t": "\t", '"': '"', "\\": "\\", "/": "/",
                   "0": "\0", " ": " "}
        while self.i < len(self.s):
            c = self.s[self.i]
            if c == "\\":
                nxt = self.s[self.i + 1:self.i + 2]
                if nxt not in escapes:
                    raise ManifestError(f"unsupported escape in {self.s!r}")
                out.append(escapes[nxt])
                self.i += 2
                continue
            self.i += 1
            if c == '"':
                return "".join(out)
            out.append(c)
        raise ManifestError(f"unterminated double-quoted scalar: {self.s!r}")


def _inline(text: str) -> Any:
    """The value after ``key:`` or ``- `` on the same line."""
    if text[:1] in ("[", '"'):
        f = _Flow(text)
        v = f.value(False)
        f._ws()
        if f.i != len(f.s):
            raise ManifestError(f"trailing text after a value: {text!r}")
        return v
    return _plain(text)


class _Block:
    def __init__(self, lines: list[str]):
        # (indent, text) of every line that carries content; tabs are not
        # YAML indentation.
        self.lines: list[tuple[int, str]] = []
        for raw in lines:
            if "\t" in raw[:len(raw) - len(raw.lstrip())]:
                raise ManifestError(f"tab in indentation: {raw!r}")
            text = _strip_comment(raw.strip())
            if text:
                self.lines.append((len(raw) - len(raw.lstrip()), text))
        self.i = 0

    def _peek(self) -> Optional[tuple[int, str]]:
        return self.lines[self.i] if self.i < len(self.lines) else None

    @staticmethod
    def _is_item(text: str) -> bool:
        return text == "-" or text.startswith("- ")

    def node(self, min_indent: int) -> Any:
        nxt = self._peek()
        if nxt is None or nxt[0] < min_indent:
            return None
        ind, text = nxt
        if self._is_item(text):
            return self.seq(ind)
        if _split_key(text) is not None:
            return self.mapping(ind)
        self.i += 1
        nxt = self._peek()
        if nxt is not None and nxt[0] > ind:
            raise ManifestError(f"multi-line scalar unsupported: {text!r}")
        return _inline(text)

    def _item_or_value(self, indent: int, col: int, rest: str) -> Any:
        """The node that starts at column ``col`` with ``rest`` on the
        current line (a sequence item's content)."""
        if self._is_item(rest) or _split_key(rest) is not None:
            # Re-read the rest of the line as a block node of its own at
            # its column: ``- name: x`` opens a mapping there.
            self.lines[self.i] = (col, rest)
            return self.node(col)
        self.i += 1
        return _inline(rest)

    def seq(self, ind: int) -> list:
        out = []
        while True:
            nxt = self._peek()
            if nxt is None or nxt[0] != ind or not self._is_item(nxt[1]):
                break
            text = nxt[1]
            rest = text[1:].lstrip()
            if not rest:
                self.i += 1
                out.append(self.node(ind + 1))
                continue
            col = ind + len(text) - len(rest)
            out.append(self._item_or_value(ind, col, rest))
        nxt = self._peek()
        if nxt is not None and nxt[0] > ind:
            raise ManifestError(f"unexpected indentation: {nxt[1]!r}")
        return out

    def mapping(self, ind: int) -> dict:
        out: dict = {}
        while True:
            nxt = self._peek()
            if nxt is None or nxt[0] != ind or self._is_item(nxt[1]):
                break
            kv = _split_key(nxt[1])
            if kv is None:
                raise ManifestError(f"expected a mapping entry: {nxt[1]!r}")
            key = _inline(kv[0])
            if key in out:
                raise ManifestError(f"duplicate key {key!r}")
            self.i += 1
            if kv[1]:
                if kv[1][:1] in ("|", ">"):
                    raise ManifestError(
                        f"block scalars are unsupported: {nxt[1]!r}")
                out[key] = _inline(kv[1])
                continue
            follow = self._peek()
            if follow is None or follow[0] < ind:
                out[key] = None
            elif follow[0] == ind:
                out[key] = (self.seq(ind) if self._is_item(follow[1])
                            else None)
            else:
                out[key] = self.node(follow[0])
        nxt = self._peek()
        if nxt is not None and nxt[0] > ind:
            raise ManifestError(f"unexpected indentation: {nxt[1]!r}")
        return out


def _load_doc(lines: list[str]) -> Any:
    block = _Block(lines)
    value = block.node(0)
    if block._peek() is not None:
        raise ManifestError(f"unparsed text: {block._peek()[1]!r}")
    return value


def load_all(text: str) -> list[Any]:
    """Every document of ``text``, as ``yaml.safe_load_all`` reads the
    subset above, with ``None`` for a stretch of comments or nothing
    between two markers (filter those out: :func:`load_file` does)."""
    docs: list[list[str]] = [[]]
    for raw in text.splitlines():
        head = raw.rstrip()
        if head in ("---", "...") or head.startswith("--- "):
            if _strip_comment(head[3:].strip()):
                raise ManifestError(f"content on a document marker: {raw!r}")
            docs.append([])
            continue
        docs[-1].append(raw)
    return [_load_doc(d) for d in docs]


def load_file(path: str | Path) -> list[Any]:
    """The non-empty documents of a manifest file."""
    return [d for d in load_all(Path(path).read_text()) if d]
