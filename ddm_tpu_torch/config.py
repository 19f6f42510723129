"""Hierarchical run configuration, compatible with the reference's key names.

The reference configures everything through ``Dune::ParameterTree`` populated
from ``.ini`` files plus ``-key value`` command-line overrides (reference:
examples/poisson.cc:178-181, and the key inventory in SURVEY.md §5.6).  We keep
the exact key names so the shipped ``.ini`` files translate 1:1, but store them
in a plain nested-dict ``ParamTree`` with typed getters.

Missing mandatory keys raise ``KeyError`` with the full dotted path, mirroring
the reference's explicit missing-key errors (dune/ddm/schwarz.hh:89-91).
"""

from __future__ import annotations

import re
from typing import Any, Iterator


class ParamTree:
    """Nested string-keyed configuration tree.

    Values are stored as strings (like ParameterTree) and converted by the
    typed ``get`` on access.  ``sub("a.b")`` returns a view of the subtree.
    """

    def __init__(self, data: dict[str, Any] | None = None, prefix: str = ""):
        self._data: dict[str, Any] = {}
        self._prefix = prefix
        if data:
            for k, v in data.items():
                self[k] = v

    # -- path helpers -----------------------------------------------------
    def _walk(self, dotted: str, create: bool = False) -> tuple[dict, str]:
        parts = dotted.split(".")
        node = self._data
        for p in parts[:-1]:
            if p not in node or not isinstance(node[p], dict):
                if not create:
                    raise KeyError(self._full(dotted))
                node[p] = {}
            node = node[p]
        return node, parts[-1]

    def _full(self, dotted: str) -> str:
        return f"{self._prefix}.{dotted}" if self._prefix else dotted

    # -- dict-like --------------------------------------------------------
    def __setitem__(self, dotted: str, value: Any) -> None:
        if isinstance(value, dict):
            for k, v in value.items():
                self[f"{dotted}.{k}"] = v
            return
        node, leaf = self._walk(dotted, create=True)
        node[leaf] = str(value)

    def __contains__(self, dotted: str) -> bool:
        try:
            node, leaf = self._walk(dotted)
        except KeyError:
            return False
        return leaf in node and not isinstance(node[leaf], dict)

    def has_sub(self, dotted: str) -> bool:
        try:
            node, leaf = self._walk(dotted)
        except KeyError:
            return False
        return isinstance(node.get(leaf), dict)

    def get(self, dotted: str, default: Any = ..., astype: type | None = None):
        """Typed get.  With no default, the key is mandatory."""
        try:
            node, leaf = self._walk(dotted)
            raw = node[leaf]
            if isinstance(raw, dict):
                raise KeyError(self._full(dotted))
        except KeyError:
            if default is ...:
                raise KeyError(
                    f"Missing mandatory configuration key '{self._full(dotted)}'"
                ) from None
            return default
        ty = astype if astype is not None else (
            default.__class__ if default is not ... else str
        )
        if ty is bool:
            return str(raw).strip().lower() in ("1", "true", "yes", "on")
        if ty is type(None):
            return raw
        return ty(raw)

    def sub(self, dotted: str) -> "ParamTree":
        """Subtree view (empty tree if absent, like ParameterTree.sub)."""
        t = ParamTree(prefix=self._full(dotted))
        try:
            node, leaf = self._walk(dotted)
            subtree = node.get(leaf)
            if isinstance(subtree, dict):
                t._data = subtree
        except KeyError:
            pass
        return t

    def items(self) -> Iterator[tuple[str, Any]]:
        def rec(node, pre):
            for k, v in node.items():
                p = f"{pre}.{k}" if pre else k
                if isinstance(v, dict):
                    yield from rec(v, p)
                else:
                    yield p, v

        return rec(self._data, "")

    def as_dict(self) -> dict:
        import copy

        return copy.deepcopy(self._data)

    def __repr__(self) -> str:  # pragma: no cover
        return f"ParamTree({self._data!r})"


_SECTION_RE = re.compile(r"^\[(?P<name>[^\]]+)\]\s*$")


def read_ini(text: str, tree: ParamTree | None = None) -> ParamTree:
    """Parse DUNE-style ``.ini`` text into a ParamTree.

    Supports ``[dotted.section]`` headers, ``key = value`` pairs, and ``#``
    comments — the subset the reference's configs use
    (e.g. the reference's examples/poisson.ini).
    """
    tree = tree if tree is not None else ParamTree()
    section = ""
    for line in text.splitlines():
        line = line.split("#", 1)[0].strip()
        if not line:
            continue
        m = _SECTION_RE.match(line)
        if m:
            section = m.group("name").strip()
            continue
        if "=" in line:
            k, v = line.split("=", 1)
            key = f"{section}.{k.strip()}" if section else k.strip()
            tree[key] = v.strip().strip('"')
    return tree


def read_ini_file(path: str, tree: ParamTree | None = None) -> ParamTree:
    with open(path) as f:
        return read_ini(f.read(), tree)


def apply_cli_overrides(tree: ParamTree, argv: list[str]) -> list[str]:
    """Apply ``-key value`` overrides (reference: readOptions), returning
    the unconsumed arguments."""
    rest = []
    i = 0
    while i < len(argv):
        a = argv[i]
        if a.startswith("-") and not a.startswith("--") and i + 1 < len(argv):
            tree[a[1:]] = argv[i + 1]
            i += 2
        else:
            rest.append(a)
            i += 1
    return rest
