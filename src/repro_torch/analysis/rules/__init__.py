"""Rule registry.  Adding a rule = write a module defining a ``rule``
object and list it here; the engine and the CLI pick it up."""

from repro_torch.analysis.rules import (
    t1_kernel_triad,
    t2_determinism,
    t3_no_fallback,
)

ALL_RULES = [
    t1_kernel_triad.rule,
    t2_determinism.rule,
    t3_no_fallback.rule,
]

RULES_BY_ID = {r.id: r for r in ALL_RULES}
