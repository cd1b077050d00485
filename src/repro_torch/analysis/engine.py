"""Rule engine for ``repro_torch.analysis``: the parsed-module index, the
rule registry, findings, and baseline diffing (own copies of what
``repro.analysis.engine`` offers, scoped to the port).

The analyzer is purely static (``ast`` only): it parses every module under
``src/repro_torch/`` and the port's test files ``tests/test_torch_*.py``,
hands the index to each rule, and diffs the findings against a baseline
when one is given.  A finding's suppression ``key`` is line-free, so a
baseline survives unrelated edits, and every baseline entry must carry a
justification: the baseline records accepted exceptions, it does not
silence findings.
"""

from __future__ import annotations

import ast
import dataclasses
import json
from pathlib import Path
from typing import Callable

from repro_torch.analysis.astutils import (
    import_map,
    iter_py_files,
    module_name_for,
)

PACKAGE = "repro_torch"
TEST_GLOB = "test_torch_*.py"


@dataclasses.dataclass(frozen=True)
class Finding:
    rule: str       # "T1".."T3" (or "PARSE" for unparseable sources)
    file: str       # repo-relative posix path
    line: int       # 1-based; 0 for file- or directory-level findings
    key: str        # stable suppression identity (never includes the line)
    message: str

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def render(self) -> str:
        loc = f"{self.file}:{self.line}" if self.line else self.file
        return f"[{self.rule}] {loc}: {self.message}"


@dataclasses.dataclass(frozen=True)
class Rule:
    id: str
    title: str
    run: Callable[["AnalysisContext"], list[Finding]]


@dataclasses.dataclass
class ModuleInfo:
    name: str            # dotted module name ("" for test files)
    path: Path
    source: str
    tree: ast.Module

    @property
    def imports(self):
        if not hasattr(self, "_imports"):
            self._imports = import_map(self.tree, self.name,
                                       self.path.name == "__init__.py")
        return self._imports


class AnalysisContext:
    """Everything the rules see: one parse of the port.

    Layout (the real repo and the test fixtures alike): sources under
    ``<root>/src/repro_torch/``, tests at ``<root>/tests/test_torch_*.py``
    (top level only)."""

    def __init__(self, root: Path | str):
        self.root = Path(root).resolve()
        self.src_root = self.root / "src"
        self.package_root = self.src_root / PACKAGE
        self.tests_root = self.root / "tests"
        self.parse_findings: list[Finding] = []
        self.modules: dict[str, ModuleInfo] = {}
        for path in iter_py_files(self.package_root):
            name = module_name_for(path, self.src_root)
            info = self._parse(name, path)
            if info is not None:
                self.modules[name] = info
        self.tests: dict[str, ModuleInfo] = {}
        if self.tests_root.is_dir():
            for path in sorted(self.tests_root.glob(TEST_GLOB)):
                info = self._parse("", path)
                if info is not None:
                    self.tests[path.name] = info

    def _parse(self, name: str, path: Path) -> ModuleInfo | None:
        source = path.read_text()
        try:
            tree = ast.parse(source, filename=str(path))
        except SyntaxError as e:
            rel = self.relpath(path)
            self.parse_findings.append(Finding(
                rule="PARSE", file=rel, line=e.lineno or 0,
                key=f"PARSE:{rel}", message=f"unparseable source: {e.msg}"))
            return None
        return ModuleInfo(name=name, path=path, source=source, tree=tree)

    def relpath(self, path: Path) -> str:
        return path.resolve().relative_to(self.root).as_posix()


@dataclasses.dataclass
class Report:
    findings: list[Finding]            # every raw finding, all rules
    unsuppressed: list[Finding]        # findings not covered by the baseline
    suppressed: list[Finding]
    stale_suppressions: list[str]      # baseline keys that matched nothing
    errors: list[str]                  # baseline problems (exit 2)

    @property
    def ok(self) -> bool:
        return not self.unsuppressed and not self.errors

    def to_dict(self) -> dict:
        return {
            "ok": self.ok,
            "counts": {"total": len(self.findings),
                       "unsuppressed": len(self.unsuppressed),
                       "suppressed": len(self.suppressed)},
            "findings": [f.to_dict() for f in self.unsuppressed],
            "suppressed": [f.to_dict() for f in self.suppressed],
            "stale_suppressions": self.stale_suppressions,
            "errors": self.errors,
        }


def load_baseline(path: Path | None) -> tuple[dict[str, str], list[str]]:
    """-> ({key: justification}, errors).  No path is an empty baseline; a
    missing file, bad JSON, an entry without a non-empty justification or
    a duplicate key is a configuration error."""
    if path is None:
        return {}, []
    if not path.is_file():
        return {}, [f"baseline {path}: no such file"]
    try:
        data = json.loads(path.read_text())
    except json.JSONDecodeError as e:
        return {}, [f"baseline {path.name}: invalid JSON: {e}"]
    entries = data.get("suppressions") if isinstance(data, dict) else None
    if not isinstance(entries, list):
        return {}, [f"baseline {path.name}: expected a 'suppressions' list"]
    errors: list[str] = []
    out: dict[str, str] = {}
    for i, entry in enumerate(entries):
        if not isinstance(entry, dict) or "key" not in entry:
            errors.append(f"baseline entry #{i}: must be an object with 'key'")
            continue
        key = entry["key"]
        just = entry.get("justification", "")
        if not isinstance(just, str) or not just.strip():
            errors.append(
                f"baseline entry {key!r}: a non-empty 'justification' string "
                "is required: the baseline records accepted exceptions, "
                "not silenced ones")
        if key in out:
            errors.append(f"baseline entry {key!r}: duplicate key")
        out[key] = just
    return out, errors


def run_analysis(root: Path | str, baseline_path: Path | str | None = None,
                 rules: list[Rule] | None = None) -> Report:
    """Run the rules (``None``: all of them) over the port at ``root`` and
    apply the baseline, if one is given."""
    from repro_torch.analysis.rules import ALL_RULES

    ctx = AnalysisContext(root)
    findings: list[Finding] = list(ctx.parse_findings)
    for rule in (rules if rules is not None else ALL_RULES):
        findings.extend(rule.run(ctx))
    findings.sort(key=lambda f: (f.rule, f.file, f.line, f.key))
    suppressions, errors = load_baseline(
        None if baseline_path is None else Path(baseline_path))
    seen = {f.key for f in findings}
    return Report(
        findings=findings,
        unsuppressed=[f for f in findings if f.key not in suppressions],
        suppressed=[f for f in findings if f.key in suppressions],
        stale_suppressions=sorted(k for k in suppressions if k not in seen),
        errors=errors,
    )
