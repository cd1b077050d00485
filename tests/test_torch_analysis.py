"""The port's static analyzer (``repro_torch.analysis``): the port lints
clean with no baseline; each rule fires on a violation planted in a small
fixture tree under ``tmp_path`` (and stays quiet on the clean tree and on
the patterns it allows); the CLI's exit codes 0/1/2, the JSON report, and
a baseline entry without a justification refused."""

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

from repro_torch.analysis import run_analysis
from repro_torch.analysis.rules import RULES_BY_ID

REPO = Path(__file__).resolve().parents[1]

CLEAN = {
    "src/repro_torch/__init__.py": "",
    "src/repro_torch/kernels/__init__.py": "",
    "src/repro_torch/kernels/foo/__init__.py": "",
    "src/repro_torch/kernels/foo/csrc/foo.cu": "extern \"C\" void foo() {}\n",
    "src/repro_torch/kernels/foo/foo.py": """
        import ctypes
        LAUNCHES = 0
        THREADS = 128

        def foo_cuda(x):
            global LAUNCHES
            LAUNCHES += 1
            return x
    """,
    "src/repro_torch/kernels/foo/ref.py": """
        import torch

        def foo_ref(x: torch.Tensor, scale: float = 1.0) -> torch.Tensor:
            return x * scale
    """,
    "src/repro_torch/kernels/foo/ops.py": """
        from repro_torch.kernels.foo import foo as _kernel
        from repro_torch.kernels.foo.ref import foo_ref

        def foo(x, scale=1.0):
            if x.is_cuda:
                return _kernel.foo_cuda(x)
            return foo_ref(x, scale)
    """,
    "src/repro_torch/obs/stats.py": """
        from repro_torch.kernels.foo import foo as _k
        BLOCK = _k.THREADS
    """,
    "src/repro_torch/core/draws.py": """
        import numpy as np
        import torch

        def draw(seed):
            gen = torch.Generator().manual_seed(seed)
            rng = np.random.default_rng(seed)
            x = torch.randn(4, generator=gen)
            x.normal_(generator=gen)
            return x, rng.normal()
    """,
    "src/repro_torch/device.py": """
        import torch

        def resolve(device):
            if device == "cuda" and not torch.cuda.is_available():
                raise RuntimeError("no CUDA device")
            return torch.device(device)
    """,
    "src/repro_torch/models/free.py": """
        import torch

        def init(shape):
            return torch.randn(shape)   # outside the determinism scopes
    """,
    "tests/test_torch_foo.py": """
        import numpy as np
        import torch
        from repro_torch.kernels.foo import ops

        def test_foo():
            x = torch.ones(3)
            np.testing.assert_allclose(ops.foo(x).numpy(), x.numpy())
    """,
}


def _tree(root: Path, files: dict) -> Path:
    for rel, text in files.items():
        path = root / rel
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(textwrap.dedent(text).lstrip("\n"))
    return root


def _planted(tmp_path, **changes):
    """The clean tree with files replaced (a value) or removed (None),
    each named by its path with ``__`` for ``/`` (``..__ops__py``)."""
    files = dict(CLEAN)
    for rel, text in changes.items():
        rel = rel.replace("__", "/")
        if rel.endswith("/py"):
            rel = rel[:-len("/py")] + ".py"
        if text is None:
            files.pop(rel)
        else:
            files[rel] = text
    return _tree(tmp_path / "repo", files)


def _keys(root, rule):
    report = run_analysis(root, rules=[RULES_BY_ID[rule]])
    return [f.key for f in report.findings]


def test_the_port_lints_clean_without_a_baseline():
    report = run_analysis(REPO)
    assert report.ok, "\n".join(f.render() for f in report.unsuppressed)
    assert report.findings == [] and report.errors == []
    assert not (REPO / "src" / "repro_torch" / "baseline.json").exists()


def test_the_clean_fixture_is_clean(tmp_path):
    root = _tree(tmp_path / "repo", CLEAN)
    assert run_analysis(root).findings == []


# ------------------------------------------------------------------- T1
@pytest.mark.parametrize("missing,key", [
    ("ops.py", "missing:ops.py"), ("ref.py", "missing:ref.py"),
    ("foo.py", "missing:foo.py"), ("csrc/foo.cu", "missing:csrc")])
def test_kernel_triad_missing_file(tmp_path, missing, key):
    root = _planted(tmp_path, **{
        f"src__repro_torch__kernels__foo__{missing.replace('/', '__')}":
        None})
    assert f"T1:src/repro_torch/kernels/foo:{key}" in _keys(root, "T1")


def test_kernel_triad_ref_imports_ctypes(tmp_path):
    root = _planted(tmp_path, src__repro_torch__kernels__foo__ref__py=(
        "import ctypes\n\ndef foo_ref(x, scale=1.0):\n    return x\n"))
    assert any("ref-imports:ctypes" in k for k in _keys(root, "T1"))


def test_kernel_triad_launch_counter(tmp_path):
    root = _planted(tmp_path, src__repro_torch__kernels__foo__foo__py=(
        "def foo_cuda(x):\n    return x\n"))
    assert any("no-launch-counter" in k for k in _keys(root, "T1"))


def test_kernel_triad_wrapper_past_ops(tmp_path):
    """Reading a constant is allowed (the clean tree does); calling the
    wrapper from outside its directory is not."""
    root = _planted(tmp_path, src__repro_torch__obs__stats__py=(
        "from repro_torch.kernels.foo import foo as _k\n\n"
        "def run(x):\n    return _k.foo_cuda(x)\n"))
    assert any("wrapper-use:foo:_k.foo_cuda" in k
               for k in _keys(root, "T1"))


def test_kernel_triad_no_counterpart_and_no_test(tmp_path):
    root = _planted(
        tmp_path,
        src__repro_torch__kernels__foo__ops__py=(
            "from repro_torch.kernels.foo.ref import bar_ref, foo_ref\n\n"
            "def foo(x, scale=1.0):\n    return foo_ref(x, scale)\n"),
        src__repro_torch__kernels__foo__ref__py=(
            "def foo_ref(x, scale=1.0):\n    return x\n\n"
            "def bar_ref(y, z):\n    return y\n"),
        tests__test_torch_foo__py=(
            "from repro_torch.kernels.foo import ops\n\n"
            "def test_foo():\n    assert ops.foo(1) is not None\n"))
    keys = _keys(root, "T1")
    assert any("no-ops-counterpart:bar_ref" in k for k in keys)
    assert any("no-tolerance-test:foo" in k for k in keys)


# ------------------------------------------------------------------- T2
@pytest.mark.parametrize("line,detail", [
    ("x = torch.randn(3)", "torch.randn:no-generator"),
    ("x = torch.randint(0, 5, (3,))", "torch.randint:no-generator"),
    ("x = torch.rand_like(torch.ones(2))", "torch.rand_like"),
    ("torch.manual_seed(0)", "torch.manual_seed"),
    ("x = np.random.default_rng()", "numpy.random.default_rng:unseeded"),
    ("x = np.random.rand(3)", "numpy.random.rand"),
    ("x = torch.ones(3).normal_()", "normal_:no-generator"),
    ("x = time.perf_counter()", "time.perf_counter"),
])
def test_determinism_fires(tmp_path, line, detail):
    src = ("import time\nimport numpy as np\nimport torch\n\n"
           f"def f():\n    {line}\n")
    root = _planted(tmp_path, src__repro_torch__core__draws__py=src)
    assert f"T2:src/repro_torch/core/draws.py:{detail}" in _keys(root, "T2")


def test_determinism_stdlib_random(tmp_path):
    root = _planted(tmp_path, src__repro_torch__data__shuffle__py=(
        "import random\n\ndef f(xs):\n    random.shuffle(xs)\n"))
    assert any("import-random" in k for k in _keys(root, "T2"))


def test_determinism_scope(tmp_path):
    """models/ is outside the scopes (the clean tree's unseeded draw
    there is not flagged); the same draw in serve/ is."""
    assert _keys(_tree(tmp_path / "a", CLEAN), "T2") == []
    root = _planted(tmp_path, src__repro_torch__serve__free__py=(
        CLEAN["src/repro_torch/models/free.py"]))
    assert any("serve/free.py" in k for k in _keys(root, "T2"))


# ------------------------------------------------------------------- T3
@pytest.mark.parametrize("body,detail", [
    ("""
    def f(x):
        try:
            return _kernel.foo_cuda(x)
        except RuntimeError:
            return foo_ref(x)
    """, "except-fallback"),
    ("""
    def f(x):
        try:
            return _kernel.foo_cuda(x)
        except RuntimeError:
            return _kernel.foo_cuda(x.cpu())
    """, "except-fallback"),
    ("""
    def f(x):
        if torch.cuda.is_available():
            return _kernel.foo_cuda(x)
        return foo_ref(x)
    """, "branch-on-availability"),
    ("""
    def f():
        return "cuda" if torch.cuda.is_available() else "cpu"
    """, "branch-on-availability"),
])
def test_no_fallback_fires(tmp_path, body, detail):
    src = ("import torch\n"
           "from repro_torch.kernels.foo import foo as _kernel\n"
           "from repro_torch.kernels.foo.ref import foo_ref\n"
           + textwrap.dedent(body))
    root = _planted(tmp_path, src__repro_torch__kernels__foo__ops__py=(
        textwrap.dedent(CLEAN["src/repro_torch/kernels/foo/ops.py"])
        + "\n" + src))
    assert any(detail in k for k in _keys(root, "T3"))


def test_no_fallback_allows_the_refusal(tmp_path):
    """``if not available: raise`` is the refusal (the clean tree's
    device.py); other try blocks pass."""
    root = _planted(tmp_path, src__repro_torch__ckpt__io__py=(
        "def load(path):\n    try:\n        return open(path).read()\n"
        "    except OSError:\n        raise RuntimeError(path)\n"))
    assert _keys(root, "T3") == []


# ------------------------------------------------------------------- CLI
def _cli(root, *extra):
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", "--root", str(root),
         *extra], capture_output=True, text=True, env=env, timeout=120)


def test_cli_exit_codes(tmp_path):
    clean = _tree(tmp_path / "clean", CLEAN)
    proc = _cli(clean)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "0 findings" in proc.stdout

    dirty = _planted(tmp_path, src__repro_torch__core__draws__py=(
        "import torch\n\ndef f():\n    return torch.randn(3)\n"))
    proc = _cli(dirty, "--json")
    assert proc.returncode == 1, proc.stdout + proc.stderr
    report = json.loads(proc.stdout)
    assert report["ok"] is False
    key = report["findings"][0]["key"]
    assert key == "T2:src/repro_torch/core/draws.py:torch.randn:no-generator"

    # a justified baseline entry suppresses it; an unjustified one is a
    # configuration error
    good = tmp_path / "good.json"
    good.write_text(json.dumps({"suppressions": [
        {"key": key, "justification": "fixture: a planted draw"}]}))
    assert _cli(dirty, "--baseline", str(good)).returncode == 0
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"suppressions": [{"key": key,
                                                 "justification": " "}]}))
    proc = _cli(dirty, "--baseline", str(bad))
    assert proc.returncode == 2
    assert "justification" in proc.stderr

    assert _cli(tmp_path / "nowhere").returncode == 2
    assert _cli(clean, "--baseline", str(tmp_path / "missing.json")
                ).returncode == 2


def test_cli_on_the_repo():
    proc = _cli(REPO)
    assert proc.returncode == 0, proc.stdout + proc.stderr
