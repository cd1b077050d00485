"""T1 — the kernel triad (the intent of the JAX analyzer's R3, for the
port's hand-written kernels).

Every ``src/repro_torch/kernels/<name>/`` directory holds:

* **files** — ``ref.py`` (the plain PyTorch version that defines the
  semantics), ``ops.py`` (the entry point: the kernel for a CUDA tensor,
  the plain version for a CPU tensor), ``<name>.py`` (the wrapper that
  builds and launches the CUDA source) and ``csrc/*.cu``;
* **ref purity** — ``ref.py`` imports neither ``ctypes`` nor the wrapper:
  the plain version cannot be the implementation;
* **a launch counter** — the wrapper keeps a module-level ``LAUNCHES``
  counter, which a run reads to show that its path went through the
  kernel;
* **ops is the entry point** — no module of the port outside the kernel's
  directory imports the wrapper, except to read its upper-case
  module-level constants (``obs/kernelstats.py`` records the sweep's block
  shape and shared memory from them; a constant launches nothing).  Tests
  are exempt: they hold the wrapper against its plain version and read its
  counters and constants;
* **signature agreement** — every public ``*_ref`` in ``ref.py`` that
  ``ops.py`` dispatches to has an ``ops.py`` counterpart (same stem, else
  the public function whose parameters cover the plain version's
  positional ones).  A backward's plain version, ``<stem>_bwd_ref``, is
  reached through autograd, its output gradients supplied by it: its
  counterpart is the trainable op ``<stem>_trainable``.  A ``*_ref`` that
  ``ops.py`` does not import is a spec of a kernel's internals, not of an
  entry point (the split decode's algebra ``attention_split_ref``, the
  turnover's logistic ``sigmoid_ref``, the bucketed sweep's algebra),
  held by its own tests: it has no entry point to agree with;
* **tolerance test** — some ``tests/test_torch_*.py`` function calls that
  ``ops`` counterpart and asserts a tolerance (``assert_allclose``,
  ``assert_close``, ``allclose``, or exact equality: ``assert_array_equal``,
  ``torch.equal``, or an ``assert`` bounding an error with ``<=``),
  directly or through a helper of its module that does.
"""

from __future__ import annotations

import ast

from repro_torch.analysis.astutils import (
    dotted,
    func_params,
    imported_modules,
)
from repro_torch.analysis.engine import Finding, Rule

TOLERANCE_CALLS = frozenset({
    "assert_allclose", "allclose", "assert_close", "assert_array_equal",
    "assert_array_almost_equal", "equal",
})


def _kernel_dirs(ctx):
    kroot = ctx.package_root / "kernels"
    if not kroot.is_dir():
        return []
    return sorted(d for d in kroot.iterdir()
                  if d.is_dir() and any(d.glob("*.py")))


def _public_functions(tree: ast.Module):
    return [n for n in tree.body
            if isinstance(n, ast.FunctionDef) and not n.name.startswith("_")]


def _all_params(fn: ast.FunctionDef) -> set[str]:
    pos, kw = func_params(fn)
    return set(pos) | set(kw)


def _match_ops(rfn: ast.FunctionDef, ops_funcs):
    """The ops counterpart of a plain version: exact stem match first, else
    the public ops function covering its positional parameters that shares
    the most parameter names with it."""
    stem = rfn.name[:-len("_ref")]
    for ofn in ops_funcs:
        if ofn.name == stem:
            return ofn
    want = set(func_params(rfn)[0])
    covering = [ofn for ofn in ops_funcs if want <= _all_params(ofn)]
    if not covering:
        return None
    ref_all = _all_params(rfn)
    covering.sort(key=lambda ofn: (-len(ref_all & _all_params(ofn)),
                                   len(_all_params(ofn) - ref_all)))
    return covering[0]


def _ops_refs(ops_info, ref_mod: str) -> set[str]:
    """The names of ``ref_mod`` that the ops module uses: imported from it,
    or read off an alias of it."""
    imports = ops_info.imports
    names = {orig for mod, orig in imports.from_imports.values()
             if mod == ref_mod}
    aliases = {local for local, (mod, orig) in imports.from_imports.items()
               if f"{mod}.{orig}" == ref_mod}
    aliases |= {local for local, full in imports.aliases.items()
                if full == ref_mod}
    names |= {n.attr for n in ast.walk(ops_info.tree)
              if isinstance(n, ast.Attribute) and isinstance(n.value, ast.Name)
              and n.value.id in aliases}
    return names


def _has_launch_counter(tree: ast.Module) -> bool:
    for node in tree.body:
        targets = (node.targets if isinstance(node, ast.Assign)
                   else [node.target] if isinstance(node, ast.AnnAssign)
                   else [])
        if any(isinstance(t, ast.Name) and t.id == "LAUNCHES"
               for t in targets):
            return True
    return False


def _wrapper_uses(info, wrapper: str) -> list[tuple[ast.AST, str]]:
    """(node, what) for every use of ``wrapper`` in ``info`` other than
    reading an upper-case constant."""
    bad: list[tuple[ast.AST, str]] = []
    aliases: set[str] = set()
    pkg, _, kname = wrapper.rpartition(".")
    for node in ast.walk(info.tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.name == wrapper:
                    if a.asname:
                        aliases.add(a.asname)
                    else:
                        bad.append((node, f"import {a.name}"))
        elif isinstance(node, ast.ImportFrom):
            imports = info.imports
            for a in node.names:
                mod, orig = imports.from_imports.get(a.asname or a.name,
                                                     (None, None))
                if mod == pkg and orig == kname:
                    aliases.add(a.asname or a.name)
                elif mod == wrapper and not orig.isupper():
                    bad.append((node, f"from {wrapper} import {orig}"))
    for node in ast.walk(info.tree):
        if isinstance(node, ast.Attribute) and isinstance(
                node.value, ast.Name) and node.value.id in aliases:
            if not node.attr.isupper():
                bad.append((node, f"{node.value.id}.{node.attr}"))
        elif isinstance(node, ast.Name) and node.id in aliases and not any(
                isinstance(p, ast.Attribute) and p.value is node
                for p in ast.walk(info.tree)):
            bad.append((node, node.id))
    return bad


def _tested_names(test, ops_mod: str) -> tuple[set[str], set[str]]:
    """(local names bound to ops functions, local aliases of the ops
    module) in a test module."""
    imports = test.imports
    funcs = {local for local, (mod, _) in imports.from_imports.items()
             if mod == ops_mod}
    mods = {local for local, full in imports.aliases.items()
            if full == ops_mod}
    mods |= {local for local, (mod, orig) in imports.from_imports.items()
             if f"{mod}.{orig}" == ops_mod}
    return funcs, mods


def _asserts_tolerance(fn: ast.AST, helpers: set[str]) -> bool:
    for n in ast.walk(fn):
        if isinstance(n, ast.Assert) and isinstance(n.test, ast.Compare) \
                and any(isinstance(op, (ast.Lt, ast.LtE))
                        for op in n.test.ops):
            return True                      # assert err <= bound
        if isinstance(n, ast.Call):
            name = dotted(n.func)
            if name is not None and (
                    name.rsplit(".", 1)[-1] in TOLERANCE_CALLS
                    or name in helpers):
                return True
    return False


def _tolerance_helpers(tree: ast.Module) -> set[str]:
    """The test module's top-level functions that assert a tolerance,
    directly or through one another (``_within(got, want, tol)``)."""
    fns = [n for n in tree.body if isinstance(n, ast.FunctionDef)]
    helpers: set[str] = set()
    while True:
        more = {f.name for f in fns if f.name not in helpers
                and _asserts_tolerance(f, helpers)}
        if not more:
            return helpers
        helpers |= more


def _has_tolerance_test(ctx, ops_mod: str, fname: str) -> bool:
    for test in ctx.tests.values():
        funcs, mods = _tested_names(test, ops_mod)
        local = {n for n in funcs
                 if test.imports.from_imports[n][1] == fname}
        if not local and not mods:
            continue
        helpers = _tolerance_helpers(test.tree)
        for fn in ast.walk(test.tree):
            if not isinstance(fn, ast.FunctionDef):
                continue
            uses = any(
                (isinstance(n, ast.Name) and n.id in local)
                or (isinstance(n, ast.Attribute) and n.attr == fname
                    and isinstance(n.value, ast.Name)
                    and n.value.id in mods)
                for n in ast.walk(fn))
            if uses and _asserts_tolerance(fn, helpers):
                return True
    return False


def run(ctx) -> list[Finding]:
    findings: list[Finding] = []

    def emit(file, line, key, message):
        findings.append(Finding(rule="T1", file=file, line=line,
                                key=f"T1:{file}:{key}", message=message))

    for kdir in _kernel_dirs(ctx):
        kname = kdir.name
        rel_dir = ctx.relpath(kdir)
        present = {p.name for p in kdir.glob("*.py")}
        for missing in sorted({f"{kname}.py", "ops.py", "ref.py"} - present):
            emit(rel_dir, 0, f"missing:{missing}",
                 f"kernel `{kname}` is missing `{missing}`: every kernel "
                 "ships the ref/ops/wrapper triad")
        if not any(kdir.glob("csrc/*.cu")):
            emit(rel_dir, 0, "missing:csrc",
                 f"kernel `{kname}` has no CUDA source under csrc/")
        prefix = f"repro_torch.kernels.{kname}"
        wrapper = f"{prefix}.{kname}"
        ops_info = ctx.modules.get(f"{prefix}.ops")
        ref_info = ctx.modules.get(f"{prefix}.ref")
        kern_info = ctx.modules.get(wrapper)

        if ref_info is not None:
            rel = ctx.relpath(ref_info.path)
            for node, mod in imported_modules(ref_info.tree, ref_info.name):
                if mod == "ctypes" or mod == wrapper:
                    emit(rel, node.lineno, f"ref-imports:{mod}",
                         f"kernel `{kname}`: ref.py imports `{mod}`; the "
                         "plain version cannot be the implementation")

        if kern_info is not None and not _has_launch_counter(kern_info.tree):
            emit(ctx.relpath(kern_info.path), 0, "no-launch-counter",
                 f"kernel `{kname}`: the wrapper keeps no module-level "
                 "`LAUNCHES` counter")

        for info in ctx.modules.values():
            if info.path.parent == kdir:
                continue
            for node, what in _wrapper_uses(info, wrapper):
                rel = ctx.relpath(info.path)
                emit(rel, node.lineno, f"wrapper-use:{kname}:{what}",
                     f"`{what}` reaches the wrapper `{wrapper}` past its "
                     "entry point; call `ops` (only upper-case constants "
                     "may be read)")

        if ops_info is None or ref_info is None:
            continue
        ops_funcs = _public_functions(ops_info.tree)
        dispatched = _ops_refs(ops_info, f"{prefix}.ref")
        rel = ctx.relpath(ref_info.path)
        for rfn in _public_functions(ref_info.tree):
            if not rfn.name.endswith("_ref") or rfn.name not in dispatched:
                continue
            if rfn.name.endswith("_bwd_ref"):
                want = rfn.name[:-len("_bwd_ref")] + "_trainable"
                counterpart = next(
                    (f for f in ops_funcs if f.name == want), None)
            else:
                counterpart = _match_ops(rfn, ops_funcs)
            if counterpart is None:
                emit(rel, rfn.lineno, f"no-ops-counterpart:{rfn.name}",
                     f"kernel `{kname}`: plain version `{rfn.name}` has no "
                     "public ops.py counterpart covering its positional "
                     "parameters")
            elif not _has_tolerance_test(ctx, f"{prefix}.ops",
                                         counterpart.name):
                emit(rel, rfn.lineno,
                     f"no-tolerance-test:{counterpart.name}",
                     f"kernel `{kname}`: no tests/test_torch_*.py test "
                     f"calls ops `{counterpart.name}` and asserts a "
                     "tolerance")
    return findings


rule = Rule(
    id="T1",
    title="kernel triad: ref/ops/wrapper/csrc, launch counter, ops as the "
          "entry point, tolerance tests",
    run=run,
)
