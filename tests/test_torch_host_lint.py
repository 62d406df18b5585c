"""The port's host-layer lints against the JAX package's, on the CPU: the
AST rules, the concurrency tier, the metric-doc drift rule, the CLI's exit
status and its lock-witness mode.

``tracer-leak`` and ``wallclock-in-jit`` look where the port freezes a
value at trace or capture time (``torch.compile``, ``torch.jit``,
``torch.func``, CUDA-graph capture). ``chaos-site``, the ``lock-*`` rules
and ``metric-doc-drift`` are package-neutral: every source fixture of the
JAX package's analysis tests, and every module of the port, gives the same
findings through both linters. The port's package lints clean, its
static lock graph is acyclic, and the doc's names the port does not
register are exactly ``rules.docs.NOT_YET_PORTED``. A lock witness the
port writes gets the same verdict from both CLIs.
"""

import ast
import json
import os

import pytest

from analytics_zoo_tpu import analysis as janalysis
from analytics_zoo_tpu.analysis.__main__ import main as jmain
from analytics_zoo_tpu_torch import analysis
from analytics_zoo_tpu_torch.analysis import lint_source
from analytics_zoo_tpu_torch.analysis.__main__ import main
from analytics_zoo_tpu_torch.common import locks as tlk
from analytics_zoo_tpu_torch.common import telemetry as ttm

pytestmark = pytest.mark.analysis

ROOT = os.path.join(os.path.dirname(__file__), "..")
PKG = os.path.join(ROOT, "analytics_zoo_tpu_torch")
NEUTRAL = ["chaos-site", "lock-guarded-by", "lock-order-cycle",
           "lock-hold-hazard", "lock-leaf-violation", "lock-unused",
           "lock-reachin"]


def _one(src, rule, **kw):
    findings, _ = lint_source(src, "fixture.py", **kw)
    assert len(findings) == 1, [str(f) for f in findings]
    assert findings[0].rule == rule, str(findings[0])
    return findings[0]


# ------------------------------------------------------------ AST goldens

LEAKS = {
    "compile-decorator": ("import torch\n"
                          "@torch.compile\n"
                          "def step(x):\n"
                          "    return float(x.sum()) + x\n"),
    "jit-script": ("import torch\n"
                   "def step(x):\n"
                   "    return x * x.max().item()\n"
                   "scripted = torch.jit.script(step)\n"),
    "func-vmap": ("import torch\n"
                  "f = torch.func.vmap(lambda v: v * v.sum().tolist())\n"),
    "graphed-callables": ("import torch\n"
                          "def fwd(x):\n"
                          "    return x.cpu() * 2\n"
                          "g = torch.cuda.make_graphed_callables(fwd, (x,))\n"),
    "cuda-graph-capture": ("import numpy as np, torch\n"
                           "def run(g, x):\n"
                           "    with torch.cuda.graph(g):\n"
                           "        y = x * 2\n"
                           "        z = np.asarray(y)\n"
                           "    return z\n"),
}


@pytest.mark.parametrize("case", sorted(LEAKS))
def test_golden_tracer_leak(case):
    f = _one(LEAKS[case], "tracer-leak")
    assert f.severity == "error"


WALLCLOCKS = {
    "compile": ("import time, torch\n"
                "def step(x):\n"
                "    return x * time.time()\n"
                "fast = torch.compile(step)\n"),
    "jit-trace": ("import numpy as np, torch\n"
                  "def step(x):\n"
                  "    return x + np.random.rand()\n"
                  "traced = torch.jit.trace(step, (x,))\n"),
}


@pytest.mark.parametrize("case", sorted(WALLCLOCKS))
def test_golden_wallclock_in_jit(case):
    _one(WALLCLOCKS[case], "wallclock-in-jit")


def test_ast_negative_space():
    """Host-side float(), torch's own RNG inside a compiled function,
    ``re.compile`` of a name that is also a function, functional_call and
    registered chaos sites: all clean."""
    src = ("import re, time, torch\n"
           "from analytics_zoo_tpu_torch.common.chaos import chaos_point\n"
           "def pattern(v):\n"
           "    return float(v), time.time()\n"
           "rx = re.compile(pattern)\n"
           "def host(v):\n"
           "    chaos_point('estimator.step')\n"
           "    return float(v), time.time()\n"
           "@torch.compile\n"
           "def step(x):\n"
           "    return x + torch.randn(x.shape)\n"
           "y = torch.func.functional_call(host, {}, (1,))\n")
    findings, _ = lint_source(src, "fixture.py")
    assert findings == []


def test_ast_nested_def_reports_once():
    src = ("import torch\n"
           "@torch.compile\n"
           "def outer(x):\n"
           "    def inner(v):\n"
           "        y = v + 1\n"
           "        return float(y)\n"
           "    return inner(x)\n")
    findings, _ = lint_source(src, "fixture.py")
    assert [f.rule for f in findings] == ["tracer-leak"]


def test_suppression_inline_and_preceding_line_like_jax():
    body = ("def step(x):\n"
            "    a = float(x)  # zoo-lint: disable=tracer-leak — fixture\n"
            "    # zoo-lint: disable=tracer-leak — fixture\n"
            "    b = float(x)\n"
            "    c = float(x)\n"
            "    return a + b + c\n")
    port = "import torch\n" + body + "fast = torch.compile(step)\n"
    jax_src = "import jax\n" + body + "jitted = jax.jit(step)\n"
    for lint, src in ((lint_source, port), (janalysis.lint_source, jax_src)):
        findings, suppressed = lint(src, "fixture.py")
        assert suppressed == 2
        assert len(findings) == 1 and findings[0].location.endswith(":6")
        src_all = src.replace("disable=tracer-leak — fixture\n    b",
                              "disable=all — fixture\n    b")
        assert lint(src_all, "fixture.py")[1] == 2


def test_ast_findings_land_in_telemetry():
    def count():
        return ttm.snapshot().get("zoo_analysis_findings_total", {}) \
            .get("samples", {}).get("tracer-leak,error", 0)

    before = count()
    _one(LEAKS["compile-decorator"], "tracer-leak")
    assert count() == before + 1


# ------------------------------------------------- package-neutral rules

def _neutral(lint, src, sites):
    findings, suppressed = lint(src, "fixture.py", chaos_sites=sites,
                                rules=NEUTRAL)
    return sorted((f.rule, f.severity, f.location) for f in findings), \
        suppressed


def _fixture_sources(path):
    """Every string constant of a JAX test module that parses as Python
    with a class or a function in it: the JAX goldens' sources."""
    out = []
    for node in ast.walk(ast.parse(open(path, encoding="utf-8").read())):
        if isinstance(node, ast.Constant) and isinstance(node.value, str) \
                and "\n" in node.value and ("def " in node.value
                                            or "class " in node.value):
            try:
                ast.parse(node.value)
            except SyntaxError:
                continue
            out.append(node.value)
    return out


@pytest.mark.parametrize("module", ["test_concurrency_lint.py",
                                    "test_analysis.py"])
def test_jax_goldens_give_the_same_findings(module):
    """The JAX package's golden sources through both linters: the same
    chaos-site and lock findings, suppressions included."""
    from analytics_zoo_tpu.common.chaos import KNOWN_SITES

    sources = _fixture_sources(os.path.join(ROOT, "tests", module))
    assert len(sources) >= (10 if module == "test_concurrency_lint.py"
                            else 5)
    tripped = 0
    for src in sources:
        got = _neutral(lint_source, src, KNOWN_SITES)
        want = _neutral(janalysis.lint_source, src, KNOWN_SITES)
        assert got == want, src
        tripped += bool(got[0])
    assert tripped >= (3 if module == "test_concurrency_lint.py" else 2)


def _subpackages():
    return sorted(d for d in os.listdir(PKG)
                  if os.path.isdir(os.path.join(PKG, d))
                  and not d.startswith(("_", "csrc")))


@pytest.mark.parametrize("sub", _subpackages())
def test_both_linters_agree_on_the_port_source(sub):
    """Every module of the port through both linters (the port's chaos
    sites): the same package-neutral findings and suppressions."""
    from analytics_zoo_tpu_torch.common.chaos import KNOWN_SITES

    for dirpath, _dirs, files in os.walk(os.path.join(PKG, sub)):
        for fname in sorted(files):
            if not fname.endswith(".py"):
                continue
            with open(os.path.join(dirpath, fname), encoding="utf-8") as f:
                src = f.read()
            assert _neutral(lint_source, src, KNOWN_SITES) == \
                _neutral(janalysis.lint_source, src, KNOWN_SITES), fname


def test_repo_lints_clean_and_cli_exit_status(tmp_path, capsys):
    """The port's package has no unsuppressed finding (and an acyclic
    static lock graph); the CLI exits 0 on it, 1 on a golden bad file."""
    findings, _ = analysis.lint_package(PKG)
    assert findings == [], "\n".join(str(f) for f in findings)
    edges, _leaves, declared = analysis.collect_lock_graph(PKG)
    graph = [(e.src, e.dst) for e in edges] + [(a, b) for a, b, _ in
                                               declared]
    assert analysis.find_cycles(graph) == []
    assert main(["--json"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["errors"] == 0 and out["findings"] == []
    bad = tmp_path / "bad.py"
    bad.write_text(LEAKS["compile-decorator"])
    assert main([str(bad)]) == 1
    assert main([str(bad), "--rules", "lock-*"]) == 0
    with pytest.raises(SystemExit):
        main([str(bad), "--rules", "no-such-rule-*"])


def test_metric_doc_drift_names_exactly_what_is_missing():
    """The doc's names the port does not register are exactly
    NOT_YET_PORTED, each tied to a ROADMAP item; nothing else drifts."""
    from analytics_zoo_tpu_torch.analysis.rules import docs

    doc = os.path.join(ROOT, "docs", "observability.md")
    code = docs.registered_metrics([PKG])
    documented = docs.documented_metrics(doc)
    assert set(documented) - set(code) == set(docs.NOT_YET_PORTED)
    assert set(code) - set(documented) == set()
    assert all("ROADMAP" in v for v in docs.NOT_YET_PORTED.values())
    assert docs.check_metric_doc_drift([PKG], doc) == []
    assert "| `zoo_analysis_findings_total` |" in docs.render_metric_table(
        [PKG])
    # the JAX check on the port's registrations names the same gap
    jfs = janalysis.get_rule("metric-doc-drift").check(([PKG], doc),
                                                       analysis.RuleContext())
    assert {f.message.split("'")[1] for f in jfs} == set(docs.NOT_YET_PORTED)


@pytest.fixture()
def traced(monkeypatch):
    monkeypatch.setenv("ZOO_TPU_TRACE_LOCKS", "1")
    tlk.reset_witness()
    yield
    tlk.reset_witness()


def test_cli_witness_mode_like_jax(traced, tmp_path):
    """A lock witness the port records passes both CLIs in one order and
    fails both once the inverted order makes the union cyclic."""
    a = tlk.traced_lock("CLI.a")
    b = tlk.traced_lock("CLI.b")
    with a:
        with b:
            pass
    src_dir = tmp_path / "pkg"
    src_dir.mkdir()
    (src_dir / "m.py").write_text("x = 1\n")
    ok = tmp_path / "w.jsonl"
    tlk.dump_witness(str(ok))
    with b:
        with a:
            pass
    cyclic = tmp_path / "w2.jsonl"
    tlk.dump_witness(str(cyclic))
    for cli in (main, jmain):
        assert cli(["--witness", str(ok), str(src_dir)]) == 0
        assert cli(["--witness", str(cyclic), str(src_dir)]) == 1
    assert [f.rule for f in analysis.check_witness(
        [], tlk.witness_edges())] == ["lock-order-cycle"]
