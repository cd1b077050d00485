"""Shared AST helpers for the port's rules: file walking, module names,
import resolution and dotted-name rendering (own copies of what
``repro.analysis.astutils`` offers; the analyzer never imports the code it
checks)."""

from __future__ import annotations

import ast
import dataclasses
from pathlib import Path
from typing import Iterator


def iter_py_files(root: Path) -> Iterator[Path]:
    """All .py files under ``root``, skipping caches, sorted for stable
    finding order."""
    if not root.is_dir():
        return
    for p in sorted(root.rglob("*.py")):
        if "__pycache__" not in p.parts:
            yield p


def module_name_for(path: Path, src_root: Path) -> str:
    """Dotted module name of ``path`` relative to ``src_root``
    (``src/repro_torch/core/api.py`` -> ``repro_torch.core.api``)."""
    parts = list(path.relative_to(src_root).with_suffix("").parts)
    if parts[-1] == "__init__":
        parts = parts[:-1]
    return ".".join(parts)


def dotted(node: ast.AST) -> str | None:
    """Render a Name/Attribute chain as ``a.b.c``; None for anything else."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


@dataclasses.dataclass
class ImportMap:
    """Name bindings a module's imports introduce, at any depth:
    ``aliases`` maps a local name to the dotted module it stands for,
    ``from_imports`` a local name to ``(module, original_name)``."""

    aliases: dict[str, str] = dataclasses.field(default_factory=dict)
    from_imports: dict[str, tuple[str, str]] = dataclasses.field(
        default_factory=dict)

    def resolve(self, dotted_name: str) -> str:
        """Expand the leading component of ``a.b.c`` through the imports;
        unknown leading names pass through unchanged."""
        head, _, rest = dotted_name.partition(".")
        if head in self.aliases:
            base = self.aliases[head]
        elif head in self.from_imports:
            mod, orig = self.from_imports[head]
            base = f"{mod}.{orig}"
        else:
            return dotted_name
        return f"{base}.{rest}" if rest else base


def absolute_module(node: ast.ImportFrom, modname: str,
                    is_package: bool) -> str | None:
    """The module an ``ImportFrom`` names, relative imports resolved
    against ``modname`` (None where it climbs out of the tree)."""
    if not node.level:
        return node.module
    parts = modname.split(".") if modname else []
    if not is_package:
        parts = parts[:-1]
    if node.level - 1 > len(parts):
        return None
    base = parts[:len(parts) - (node.level - 1)]
    return ".".join(base + ([node.module] if node.module else []))


def import_map(tree: ast.Module, modname: str = "",
               is_package: bool = False) -> ImportMap:
    m = ImportMap()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.asname:
                    m.aliases[a.asname] = a.name
                else:
                    m.aliases[a.name.partition(".")[0]] = \
                        a.name.partition(".")[0]
                    if "." in a.name:
                        m.aliases.setdefault(a.name, a.name)
        elif isinstance(node, ast.ImportFrom):
            mod = absolute_module(node, modname, is_package)
            if mod is None:
                continue
            for a in node.names:
                if a.name != "*":
                    m.from_imports[a.asname or a.name] = (mod, a.name)
    return m


def imported_modules(tree: ast.Module, modname: str = "",
                     is_package: bool = False
                     ) -> Iterator[tuple[ast.AST, str]]:
    """(node, dotted module) for every import in the tree: ``import a.b``
    gives ``a.b``, ``from a import b`` gives ``a.b`` (b may be a module)
    and ``a``."""
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield node, a.name
        elif isinstance(node, ast.ImportFrom):
            mod = absolute_module(node, modname, is_package)
            if mod is None:
                continue
            yield node, mod
            for a in node.names:
                yield node, f"{mod}.{a.name}"


def func_params(fn: ast.FunctionDef) -> tuple[list[str], list[str]]:
    """(positional_names, kwonly_names) of a function signature."""
    a = fn.args
    pos = [p.arg for p in a.posonlyargs + a.args]
    if a.vararg:
        pos.append(a.vararg.arg)
    kw = [p.arg for p in a.kwonlyargs]
    if a.kwarg:
        kw.append(a.kwarg.arg)
    return pos, kw


def keyword_names(call: ast.Call) -> set[str]:
    return {k.arg for k in call.keywords if k.arg}
