"""``repro_torch.analysis`` — the port's own static analyzer.

The port leans on three invariants that the JAX package's analyzer
(``repro.analysis``, which scans the JAX package's layout) cannot see:
every hand-written kernel ships as a triad of plain version, entry point
and wrapper around its CUDA source, with a counter of its launches and a
tolerance test; the modules backing bit-exact goldens draw only from
seeded generators and read no clock; and no path falls back to a plain
version or to the CPU when the card is missing or a kernel fails.  This
package checks them in ``ast`` only (it imports nothing it checks), over
``src/repro_torch/`` and ``tests/test_torch_*.py``:

    python -m repro_torch.analysis            # human output, exit 1 on findings
    python -m repro_torch.analysis --json     # machine output

The port lints clean with no baseline; a ``--baseline`` file, where one is
given, lists accepted exceptions, each with a justification.
"""

from repro_torch.analysis.engine import (  # noqa: F401
    AnalysisContext,
    Finding,
    Report,
    Rule,
    run_analysis,
)
