"""T2 — determinism (the intent of the JAX analyzer's R2, in PyTorch's
terms).

The port's modules backing bit-exact goldens and oracles (``core/``,
``capacity/``, ``kernels/``, ``data/``, ``serve/``) must be reproducible
from their inputs alone:

* no global seeding (``torch.manual_seed``, ``torch.cuda.manual_seed``,
  ``torch.seed``): seeding process-global state makes a result depend on
  every draw before it;
* no stdlib ``random``;
* no numpy global-state RNG (``np.random.rand``, ``np.random.seed``...)
  and no unseeded constructor (``np.random.default_rng()``);
* no draw from PyTorch's global generator: ``torch.rand*``, ``randn*``,
  ``randint*``, ``randperm``, ``multinomial``, ``normal``, ``bernoulli``,
  ``poisson`` and the in-place ``Tensor`` draws (``normal_``,
  ``uniform_``...) take ``generator=`` (a seeded ``torch.Generator``);
  the ``*_like`` draws, which take none, are refused;
* no wall-clock reads (``time.time``, ``time.perf_counter``,
  ``datetime.now``...).
"""

from __future__ import annotations

import ast

from repro_torch.analysis.astutils import dotted, keyword_names
from repro_torch.analysis.engine import Finding, Rule

SCOPES = ("core/", "capacity/", "kernels/", "data/", "serve/")

CLOCK_CALLS = frozenset({
    "time.time", "time.time_ns", "time.monotonic", "time.monotonic_ns",
    "time.perf_counter", "time.perf_counter_ns", "time.process_time",
    "datetime.datetime.now", "datetime.datetime.utcnow",
    "datetime.datetime.today", "datetime.date.today",
})

#: numpy.random attributes allowed when seeded (constructor given args).
SEEDED_CTORS = frozenset({
    "default_rng", "Generator", "SeedSequence", "PCG64", "Philox",
    "MT19937", "SFC64",
})

GLOBAL_SEEDING = frozenset({
    "torch.manual_seed", "torch.seed", "torch.random.manual_seed",
    "torch.random.seed", "torch.cuda.manual_seed",
    "torch.cuda.manual_seed_all", "torch.cuda.seed", "torch.cuda.seed_all",
})

#: torch functions that draw, and take ``generator=``.
TORCH_DRAWS = frozenset({
    "rand", "randn", "randint", "randperm", "multinomial", "normal",
    "bernoulli", "poisson",
})
#: draws that take no generator at all: always the global one.
TORCH_GLOBAL_DRAWS = frozenset({"rand_like", "randn_like", "randint_like"})

#: in-place and method draws on a tensor, which take ``generator=``.
METHOD_DRAWS = frozenset({
    "normal_", "uniform_", "exponential_", "random_", "bernoulli_",
    "cauchy_", "log_normal_", "geometric_",
})


def _in_scope(ctx, info) -> bool:
    rel = info.path.relative_to(ctx.package_root).as_posix()
    return rel.startswith(SCOPES)


def run(ctx) -> list[Finding]:
    findings: list[Finding] = []
    for info in ctx.modules.values():
        if not _in_scope(ctx, info):
            continue
        rel = ctx.relpath(info.path)
        imports = info.imports

        def emit(node, detail, message):
            findings.append(Finding(
                rule="T2", file=rel, line=getattr(node, "lineno", 0),
                key=f"T2:{rel}:{detail}", message=message))

        for node in ast.walk(info.tree):
            if isinstance(node, ast.Import) and any(
                    a.name == "random" for a in node.names):
                emit(node, "import-random",
                     "stdlib `random` is process-global state; draw from "
                     "a seeded torch.Generator or numpy Generator")
            elif isinstance(node, ast.ImportFrom) and node.module in (
                    "random", "time"):
                for a in node.names:
                    if node.module == "random" or \
                            f"time.{a.name}" in CLOCK_CALLS:
                        emit(node, f"import-{node.module}.{a.name}",
                             f"`from {node.module} import {a.name}` in a "
                             "determinism-scoped module")
            if not isinstance(node, ast.Call):
                continue
            name = dotted(node.func)
            full = imports.resolve(name) if name else None
            kws = keyword_names(node)
            if full in CLOCK_CALLS:
                emit(node, full, f"`{full}()` is a wall-clock read")
            elif full in GLOBAL_SEEDING:
                emit(node, full,
                     f"`{full}()` seeds process-global state; seed a "
                     "torch.Generator and pass it as generator=")
            elif full and full.startswith("numpy.random."):
                attr = full[len("numpy.random."):]
                if attr not in SEEDED_CTORS:
                    emit(node, full, f"`np.random.{attr}` uses numpy's "
                         "global RNG state; use a seeded Generator")
                elif not node.args and not node.keywords:
                    emit(node, f"{full}:unseeded",
                         f"`np.random.{attr}()` without a seed draws OS "
                         "entropy; pass an explicit seed")
            elif full and full.startswith("torch.") and \
                    full[len("torch."):] in TORCH_GLOBAL_DRAWS:
                emit(node, full, f"`{full}()` draws from the global "
                     "generator (it takes no generator=)")
            elif full and full.startswith("torch.") and \
                    full[len("torch."):] in TORCH_DRAWS:
                if "generator" not in kws:
                    emit(node, f"{full}:no-generator",
                         f"`{full}()` without generator= draws from the "
                         "global generator")
            elif isinstance(node.func, ast.Attribute) and \
                    node.func.attr in METHOD_DRAWS | {"multinomial",
                                                      "bernoulli"} and \
                    "generator" not in kws and not (
                        full and full.startswith("torch.")):
                emit(node, f"{node.func.attr}:no-generator",
                     f"`.{node.func.attr}()` without generator= draws "
                     "from the global generator")
    return findings


rule = Rule(
    id="T2",
    title="determinism: seeded generators only, no clocks, in the "
          "golden-backed modules",
    run=run,
)
