"""T3 — no fallback by availability (the port's ground rule).

A path that was meant for the card runs there or raises: it never drops
to a kernel's plain version or to the CPU because the card is missing or
a kernel failed, so a CPU result can never pass for a card result.  Over
every module of the port:

* no ``try`` whose ``except`` handler calls a plain version (a
  ``*_ref`` function) or moves work to the CPU (``.cpu()``, a ``"cpu"``
  device);
* no branch on ``torch.cuda.is_available()`` (``if``, conditional
  expression, ``while``), except an ``if`` whose body only raises: that is
  the refusal (``repro_torch.device.resolve_device``), not a fallback.
  The CPU is reached only by asking for it (``device="cpu"``) or by
  handing an entry point CPU tensors.
"""

from __future__ import annotations

import ast

from repro_torch.analysis.astutils import dotted
from repro_torch.analysis.engine import Finding, Rule

AVAILABILITY = frozenset({"torch.cuda.is_available"})


def _moves_off_the_card(node: ast.AST, imports) -> str | None:
    """What in ``node`` calls a plain version or names the CPU, or
    None."""
    for n in ast.walk(node):
        if isinstance(n, ast.Call):
            name = dotted(n.func)
            tail = (n.func.attr if isinstance(n.func, ast.Attribute)
                    else n.func.id if isinstance(n.func, ast.Name) else "")
            if tail.endswith("_ref"):
                return f"calls `{name or tail}`"
            if tail == "cpu":
                return "calls `.cpu()`"
        if isinstance(n, ast.Constant) and n.value == "cpu":
            return "names the \"cpu\" device"
    return None


def _tests_availability(test: ast.AST, imports) -> bool:
    for n in ast.walk(test):
        if isinstance(n, ast.Call):
            name = dotted(n.func)
            if name and imports.resolve(name) in AVAILABILITY:
                return True
    return False


def _only_raises(body: list[ast.stmt]) -> bool:
    return all(isinstance(s, ast.Raise) for s in body)


def run(ctx) -> list[Finding]:
    findings: list[Finding] = []
    for info in ctx.modules.values():
        rel = ctx.relpath(info.path)
        imports = info.imports

        def emit(node, detail, message):
            findings.append(Finding(
                rule="T3", file=rel, line=getattr(node, "lineno", 0),
                key=f"T3:{rel}:{detail}", message=message))

        for node in ast.walk(info.tree):
            if isinstance(node, ast.Try):
                for handler in node.handlers:
                    what = _moves_off_the_card(
                        ast.Module(body=handler.body, type_ignores=[]),
                        imports)
                    if what:
                        emit(handler, f"except-fallback:{what}",
                             f"an `except` handler {what}: a failure on "
                             "the card must raise, not fall back")
            elif isinstance(node, ast.If):
                if _tests_availability(node.test, imports) and not (
                        _only_raises(node.body) and not node.orelse):
                    emit(node, "branch-on-availability",
                         "branches on torch.cuda.is_available(): the "
                         "device is the caller's choice (device=), and "
                         "a missing card raises")
            elif isinstance(node, (ast.IfExp, ast.While)):
                if _tests_availability(node.test, imports):
                    emit(node, "branch-on-availability",
                         "branches on torch.cuda.is_available(): the "
                         "device is the caller's choice (device=), and "
                         "a missing card raises")
    return findings


rule = Rule(
    id="T3",
    title="no fallback by availability: no except-to-plain or to-CPU, no "
          "branch on torch.cuda.is_available()",
    run=run,
)
