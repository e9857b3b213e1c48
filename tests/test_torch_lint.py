"""The port's AST lint (``analysis/lint.py``) on the host.

Every rule in ``RULES`` is documented, fires on a known-bad fixture and
stays silent on a near miss (the numpy look-alikes of ``host-read``, the
dict subscript of ``axis-literal``, the same code outside a rule's
scope).  The rules carried over from the JAX package give JAX's
``(rule, line, col)`` on the same sources, the disable hatch's
behaviours included (JAX's ``tests/test_analysis.py``).  The live tree
lints clean and every disable in it gives a reason.  The entry point
exits 0 on the tree and 1 on each firing fixture, prints parseable JSON
and writes records ``validate_finding_records`` accepts; the metric
registry's loader raises where it cannot read the registry.  All in
process: no subprocess, no model.
"""

import ast
import json
import os
import textwrap

import pytest

from pytorch_distributed_training_tpu.analysis.lint import (
    lint_source as jax_lint_source,
)
from pytorch_distributed_training_tpu_torch.analysis import (
    RULES,
    iter_python_files,
    lint_paths,
    lint_source,
    validate_finding_records,
)
from pytorch_distributed_training_tpu_torch.analysis import lint

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = "pytorch_distributed_training_tpu_torch"


def _src(snippet: str) -> str:
    return textwrap.dedent(snippet).lstrip("\n")


def _child_argv_source() -> str:
    """``cli/main.py``'s ``_child_argv`` as it stands, read as text."""
    path = os.path.join(REPO, PKG, "cli", "main.py")
    with open(path, encoding="utf-8") as f:
        src = f.read()
    fn = next(n for n in ast.parse(src).body
              if isinstance(n, ast.FunctionDef) and n.name == "_child_argv")
    return "import argparse\n\n\n" + ast.get_source_segment(src, fn) + "\n"


def _without_bool_optional_branch(src: str) -> str:
    """The CLI's ``_child_argv`` without its BooleanOptionalAction branch,
    the form that once forwarded ``--serve-affinity True``."""
    lines = src.splitlines(keepends=True)
    i = next(k for k, ln in enumerate(lines)
             if "BooleanOptionalAction" in ln)
    end = i + 1
    while lines[end].startswith(" " * 12):
        end += 1
    return "".join(lines[:i] + lines[end:])


# --------------------------------------------------------------------- #
# fixtures: (id, path, source, expected (rule, line) list)
# --------------------------------------------------------------------- #

TRAIN = f"{PKG}/train/fixture.py"
SERVE = f"{PKG}/serve/fixture.py"
INIT = f"{PKG}/parallel/__init__.py"

FIRES = [
    ("debug-stray", "import-pdb", SERVE, "import pdb\n",
     [("debug-stray", 1)]),
    ("debug-stray", "breakpoint", SERVE, _src("""
        def f():
            breakpoint()
     """), [("debug-stray", 2)]),
    ("axis-literal", "jax-spelling", SERVE, _src("""
        from ..comm import collectives

        def f(x, mesh):
            return collectives.all_gather(x, "tensor")
     """), [("axis-literal", 4)]),
    ("axis-literal", "group", SERVE, _src("""
        def f(mesh):
            return mesh.group("tensor")
     """), [("axis-literal", 2)]),
    ("axis-literal", "axes-size-tuple", SERVE, _src("""
        def f(mesh):
            return mesh.axes_size(("data", "fsdp"))
     """), [("axis-literal", 2)]),
    ("axis-literal", "axes-index", SERVE, _src("""
        def f(mesh):
            return mesh.axes_index("pipeline")
     """), [("axis-literal", 2)]),
    ("axis-literal", "shape-and-coords", SERVE, _src("""
        def serving_groups(mesh):
            tp = mesh.shape["tensor"]
            return tp, mesh.rank - mesh.coords["tensor"]
     """), [("axis-literal", 2), ("axis-literal", 3)]),
    ("shard-axis-unknown", "typo", f"{PKG}/parallel/fixture.py", _src("""
        from .sharding import P

        RULES = [("wte", P("tensr", None))]
     """), [("shard-axis-unknown", 3)]),
    ("metric-name", "undeclared", SERVE, _src("""
        def f(em):
            em.gauge("mfu-live", 1.0)
     """), [("metric-name", 2)]),
    ("metric-name", "wrong-instrument", SERVE, _src("""
        def f(em):
            em.counter_add("mfu_live", 1.0)
     """), [("metric-name", 2)]),
    ("host-read", "item", TRAIN, _src("""
        import torch

        def f(x: torch.Tensor):
            return x.sum().item()
     """), [("host-read", 4)]),
    ("host-read", "tolist", TRAIN, _src("""
        import torch

        def f(logits):
            ids = torch.argmax(logits, -1)
            return ids.tolist()
     """), [("host-read", 5)]),
    ("host-read", "cpu", f"{PKG}/ops/fixture.py", _src("""
        import torch

        def f(losses):
            loss = torch.stack(losses).mean()
            return loss.cpu()
     """), [("host-read", 5)]),
    ("host-read", "numpy", f"{PKG}/parallel/fixture.py", _src("""
        import torch

        def f(n):
            return torch.ones(n).numpy()
     """), [("host-read", 4)]),
    ("host-read", "float", TRAIN, _src("""
        import torch

        def clip(grads):
            norm = torch.stack([g.norm() for g in grads]).norm()
            return float(norm)
     """), [("host-read", 5)]),
    ("host-read", "int-bool", f"{PKG}/resilience/anomaly.py", _src("""
        import torch

        def gate(loss: "torch.Tensor", count: torch.Tensor):
            bad = ~torch.isfinite(loss)
            return int(count), bool(bad)
     """), [("host-read", 5), ("host-read", 5)]),
    ("host-read", "if-test", TRAIN, _src("""
        import torch

        def f(x: torch.Tensor):
            if (x > 0).all():
                return x
            return -x
     """), [("host-read", 4)]),
    ("host-read", "while-test", TRAIN, _src("""
        import torch

        def f(x: torch.Tensor | None):
            while torch.isfinite(x).all():
                x = x * 2
            return x
     """), [("host-read", 4)]),
    # The optimizer's old lookup: a 0-dim count as a subscript, a sync
    # every step.
    ("host-read", "zero-dim-subscript", TRAIN, _src("""
        import torch

        def _lookup(table: torch.Tensor, count: torch.Tensor):
            index = count.clamp(max=table.numel() - 1).view(())
            return table[index]

        def _best(scores, lrs):
            k = torch.argmax(scores)
            return lrs[k + 1]
     """), [("host-read", 5), ("host-read", 9)]),
    ("host-read", "captured-body", SERVE, _src("""
        import torch

        from .engine import captured

        @captured
        def body(positions: torch.Tensor):
            return int(positions.max())
     """), [("host-read", 7)]),
    ("host-clock-in-capture", "clock-and-spans", SERVE, _src("""
        import time
        from time import perf_counter_ns

        from ..obs.trace import phase_span
        from . import engine

        @engine.captured
        def body(spans, x):
            t0 = time.perf_counter()
            with phase_span(spans, "serve/decode"):
                y = x + 1
            spans.span("serve/verify")
            return y, perf_counter_ns() - t0
     """), [("host-clock-in-capture", 9), ("host-clock-in-capture", 10),
            ("host-clock-in-capture", 12), ("host-clock-in-capture", 13)]),
    ("global-rng", "torch-draws", f"{PKG}/models/fixture.py", _src("""
        import torch

        def init(w, x):
            noise = torch.randn(3) + torch.rand_like(x)
            w.normal_(0.0, 0.02)
            torch.manual_seed(0)
            return noise
     """), [("global-rng", 4), ("global-rng", 4), ("global-rng", 5),
            ("global-rng", 6)]),
    ("global-rng", "numpy-and-stdlib", f"{PKG}/data/fixture.py", _src("""
        import random

        import numpy as np

        def order(n):
            np.random.seed(0)
            import numpy as onp
            return onp.random.permutation(n), random.random()
     """), [("global-rng", 6), ("global-rng", 8), ("global-rng", 8)]),
    ("raw-collective", "module-alias", f"{PKG}/resilience/fixture.py",
     _src("""
        import torch
        import torch.distributed as dist

        def grow(wire, group):
            dist.broadcast(wire, src=2, group=group)
            torch.distributed.all_gather_into_tensor(wire, wire)
     """), [("raw-collective", 5), ("raw-collective", 6)]),
    ("raw-collective", "local-import", SERVE, _src("""
        def sync(x):
            import torch.distributed as d
            from torch.distributed import reduce_scatter_tensor
            d.all_reduce(x)
            reduce_scatter_tensor(x, x)
     """), [("raw-collective", 4), ("raw-collective", 5)]),
    ("argv-bool", "child-argv-without-bool-branch", f"{PKG}/cli/fixture.py",
     _without_bool_optional_branch(_child_argv_source()), None),
    ("init-shadows-submodule", "ring-attention", INIT, _src("""
        from .ring_attention import ring_attention, ring_self_attention
     """), [("init-shadows-submodule", 1)]),
    ("init-shadows-submodule", "def-over-module", INIT, _src("""
        from .pipeline import pipeline_forward

        def pipeline():
            return pipeline_forward
     """), [("init-shadows-submodule", 3)]),
    ("bad-disable", "unknown-id", SERVE, _src("""
        x = 1  # graftcheck: disable=debug-strey — typo
     """), [("bad-disable", 1)]),
    ("bad-disable", "no-reason", SERVE, _src("""
        # graftcheck: disable=debug-stray
        breakpoint()
     """), [("bad-disable", 1)]),
    ("parse-error", "syntax", SERVE, "def f(:\n    pass\n",
     [("parse-error", 1)]),
]

NEAR = [
    ("debug-stray", "set-trace-lookalike", SERVE, _src("""
        import logging

        def f(tracer):
            tracer.set_trace_level(2)
            logging.debug("breakpoint")
     """)),
    ("axis-literal", "constants-dicts-regex", SERVE, _src("""
        from ..comm.mesh import AXIS_TENSOR, BATCH_AXES

        def f(mesh, sharding, m, x):
            tp = mesh.shape[AXIS_TENSOR] * mesh.axes_size(BATCH_AXES)
            return tp, sharding["tensor"], m.group(1), x.shape[0]
     """)),
    ("shard-axis-unknown", "known-axes", f"{PKG}/parallel/fixture.py",
     _src("""
        from .sharding import P

        RULES = [("wte", P(("data", "fsdp"), None, "tensor_ici")),
                 ("wpe", P())]
     """)),
    ("metric-name", "declared", SERVE, _src("""
        def f(em, cat):
            em.gauge("mfu_live", 1.0)
            em.gauge(f"ledger_{cat}_s", 2.0)
     """)),
    # The numpy look-alikes: the pipeline tables' int(f_tick[m, vs]), a
    # numpy .tolist(), a regex match's int(m.group(1)); shape math; the
    # trainer's log point (its tensors come from the step's return); a
    # None test; index_select in place of a 0-dim subscript.
    ("host-read", "numpy-and-shapes", f"{PKG}/parallel/fixture.py", _src("""
        import re

        import numpy as np
        import torch

        _BLOCK = re.compile(r"block(\\d+)")

        def ticks(m, vs, sched, s, name):
            f_tick = np.zeros((4, 4), np.int64)
            tb = getattr(sched, name)[s].tolist()
            return int(f_tick[m, vs]), tb, np.arange(3).tolist()

        def block(name, x: torch.Tensor, mask: torch.Tensor | None):
            m = _BLOCK.match(name)
            if mask is None or x.numel() == 0:
                return int(m.group(1)) + int(x.shape[0])
            return torch.index_select(x, 0, mask.clamp(max=3).view(1))
     """)),
    ("host-read", "log-point-and-scope", TRAIN, _src("""
        def log(metrics):
            return {k: float(v) for k, v in metrics.items()}
     """)),
    ("host-read", "outside-warm-code", SERVE, _src("""
        import torch

        def f(x: torch.Tensor):
            return x.sum().item()
     """)),
    # Spans and clocks around the replay, not in the body; a regex
    # match's span(1) inside it.
    ("host-clock-in-capture", "around-the-replay", SERVE, _src("""
        import re
        import time

        from ..obs.trace import phase_span
        from .engine import captured

        @captured
        def body(x, name):
            m = re.match(r"(a)", name)
            return x + 1, m.span(1)

        def tick(spans, x):
            t0 = time.perf_counter()
            with phase_span(spans, "serve/decode"):
                y = body(x, "a")
            return y, time.perf_counter() - t0
     """)),
    ("global-rng", "explicit-generators", f"{PKG}/models/fixture.py",
     _src("""
        import random as stdlib_random

        import numpy as np
        import torch

        def init(w, g, seed):
            rng = np.random.default_rng(seed)
            random = rng
            w.normal_(0.0, 0.02, generator=g)
            noise = torch.randn(3, generator=g)
            return (noise, random.integers(3), rng.normal(),
                    stdlib_random.Random(seed).random())
     """)),
    ("global-rng", "outside-the-package", "chip_smoke.py", _src("""
        import torch

        def f():
            return torch.randn(3)
     """)),
    ("raw-collective", "object-and-queries", SERVE, _src("""
        import torch.distributed as dist

        def send(group, message):
            dist.broadcast_object_list([message], src=0, group=group)
            dist.barrier()
            g = dist.new_group([0, 1])
            return dist.get_rank(g), dist.is_initialized()
     """)),
    ("raw-collective", "inside-comm", f"{PKG}/comm/fixture.py", _src("""
        import torch.distributed as dist

        def all_reduce(x, group):
            dist.all_reduce(x, group=group)
     """)),
    ("argv-bool", "todays-child-argv", f"{PKG}/cli/fixture.py",
     _child_argv_source()),
    ("init-shadows-submodule", "module-imports", INIT, _src("""
        from . import ring_attention
        from .pipeline import pipeline_forward
        from .ring_attention import ring_self_attention
     """)),
    ("init-shadows-submodule", "not-an-init", f"{PKG}/parallel/fixture.py",
     _src("""
        from .ring_attention import ring_attention
     """)),
    ("bad-disable", "reasons", SERVE, _src("""
        # graftcheck: disable=debug-stray - an ASCII reason
        breakpoint()
        breakpoint()  # graftcheck: disable=debug-stray — a reviewed one
     """)),
    ("parse-error", "valid", SERVE, "def f():\n    pass\n"),
]


def _key(findings):
    return [(f.rule, f.line) for f in findings]


def _argv_bool_lines(src: str) -> list:
    """The ``str(...)`` call of the fixture's emitting branch."""
    return [("argv-bool", n) for n, ln in enumerate(src.splitlines(), 1)
            if "str(value)" in ln]


@pytest.mark.parametrize("rule,case,path,src,want", FIRES,
                         ids=[f"{r}-{c}" for r, c, *_ in FIRES])
def test_rule_fires_on_its_fixture(rule, case, path, src, want):
    want = want if want is not None else _argv_bool_lines(src)
    assert want and all(r == rule for r, _ in want)
    assert _key(lint_source(src, path)) == want


@pytest.mark.parametrize("rule,case,path,src", NEAR,
                         ids=[f"{r}-{c}" for r, c, *_ in NEAR])
def test_rule_silent_on_its_near_miss(rule, case, path, src):
    assert lint_source(src, path) == []


def test_every_rule_is_documented_and_has_fixtures():
    for rule_id, rule in RULES.items():
        assert rule.rule_id == rule_id and rule.description and rule.fixit
    assert {r for r, *_ in FIRES} == set(RULES) == {r for r, *_ in NEAR}


def test_clock_rule_twins_jax_on_the_same_body():
    """JAX's ``host-clock-in-trace`` on a jitted body and the port's
    ``host-clock-in-capture`` on the same body captured: the same lines."""
    body = _src("""
        import time

        from {mod} import {deco}

        @{deco}
        def step(spans, x):
            t0 = time.monotonic()
            spans.start_span("serve/decode")
            return x + 1, time.perf_counter() - t0
     """)
    jax_src = body.format(mod="jax", deco="jit")
    port_src = body.format(mod=".engine", deco="captured")
    want = [(f.rule, f.line) for f in jax_lint_source(
        jax_src, "pytorch_distributed_training_tpu/serve/fixture.py")
        if f.rule == "host-clock-in-trace"]
    got = [(f.rule, f.line) for f in lint_source(port_src, SERVE)]
    assert [line for _, line in want] == [line for _, line in got] \
        == [7, 8, 9]
    assert {r for r, _ in got} == {"host-clock-in-capture"}


def test_rule_filter_and_unknown_rules():
    src = "import pdb\nbreakpoint()\n"
    assert lint_source(src, SERVE, enabled=["axis-literal"]) == []
    assert len(lint_source(src, SERVE, enabled=["debug-stray"])) == 2
    with pytest.raises(ValueError, match="unknown rules"):
        lint_source(src, SERVE, enabled=["tracer-leak"])


def test_axes_mirror_the_mesh():
    from pytorch_distributed_training_tpu_torch.comm import mesh

    assert lint.PORT_AXES == mesh.MESH_AXES
    assert lint.KNOWN_AXES == set(mesh.MESH_AXES) | {
        f(a) for a in mesh.MESH_AXES
        for f in (mesh.dcn_axis_name, mesh.ici_axis_name)}


# --------------------------------------------------------------------- #
# parity with the JAX package's lint
# --------------------------------------------------------------------- #

PARITY = [
    ("debug-stray", {"debug-stray"}, _src("""
        import pdb
        import ipdb

        def f():
            pdb.set_trace()
            ipdb.set_trace()
            breakpoint()
     """), ["debug-stray"] * 5),
    ("axis-literal", {"axis-literal"}, _src("""
        from jax import lax

        AXIS_DATA = "data"

        def f(x):
            a = lax.psum(x, "data") + lax.pmean(x, axis_name="tensor")
            b = lax.all_gather(x, ("fsdp", "tensor"), tiled=True)
            c = lax.ppermute(x, "data_dcn", perm=[(0, 1)])
            return a + b + c + lax.psum(x, AXIS_DATA)
     """), ["axis-literal"] * 4),
    ("shard-axis-unknown", {"shard-axis-unknown"}, _src("""
        from jax.sharding import PartitionSpec
        from jax.sharding import PartitionSpec as P

        A = P("data", "bogus")
        B = PartitionSpec(("fsdp", "tensr"), None)
        C = P("tensor_ici", ("data_dcn", "expert"))
     """), ["shard-axis-unknown"] * 2),
    ("metric-name", {"metric-name"}, _src("""
        def f(em, cat, live):
            em.gauge("mfu_live", 1.0)
            em.gauge("mfu-live", 1.0)
            em.counter_add("mfu_live", 1.0)
            em.gauge(f"ledger_{cat}_s", 1.0)
            em.observe(f"nosuch_{cat}", 1.0)
            live.gauge(labeled("mfu_live", replica=0), 1.0)
     """), ["metric-name"] * 3),
    ("bad-disable", {"debug-stray"}, _src("""
        x = 1  # graftcheck: disable=debug-strey — typo
     """), ["bad-disable"]),
    ("parse-error", None, "def f(:\n    pass\n", ["parse-error"]),
    # The hatch (JAX's test_analysis.py:364-429) on a rule both have.
    ("hatch-line-and-file", {"debug-stray"}, _src("""
        # graftcheck: disable=debug-stray — fixture
        breakpoint()
        breakpoint()
     """), ["debug-stray"]),
    ("hatch-file-wide", {"debug-stray"}, _src("""
        # graftcheck: disable-file=debug-stray — fixture
        import pdb
        breakpoint()
     """), []),
    ("hatch-typo", {"debug-stray"}, _src("""
        # graftcheck: disable=debug-strey — fixture
        breakpoint()
     """), ["bad-disable", "debug-stray"]),
    ("hatch-ascii-reason", {"debug-stray"}, _src("""
        # graftcheck: disable=debug-stray - legacy host read
        breakpoint()
     """), []),
    ("hatch-trailing-does-not-bleed", {"debug-stray"}, _src("""
        breakpoint()  # graftcheck: disable=debug-stray — reviewed
        breakpoint()
     """), ["debug-stray"]),
]


def _located(findings):
    return [(f.rule, f.line, f.col) for f in findings]


@pytest.mark.parametrize("case,enabled,src,rules", PARITY,
                         ids=[c for c, *_ in PARITY])
def test_carried_over_rules_match_jax(case, enabled, src, rules):
    """The same source, the same rules: the same (rule, line, col)."""
    port = lint_source(src, "fixture.py", enabled=enabled)
    assert _located(port) == _located(
        jax_lint_source(src, "fixture.py", enabled=enabled))
    assert [f.rule for f in port] == rules


# --------------------------------------------------------------------- #
# the gate
# --------------------------------------------------------------------- #


def test_live_tree_lints_clean():
    """The port and chip_smoke.py carry no finding: every exception is a
    disable with its reason."""
    findings = lint_paths()
    assert findings == [], "\n".join(f.format() for f in findings)


def test_every_disable_in_the_port_gives_a_reason():
    files = iter_python_files(lint.DEFAULT_LINT_TARGETS, REPO)
    assert len(files) > 90
    disables, unreasoned = 0, []
    for path in files:
        with open(path, encoding="utf-8") as f:
            src = f.read()
        disables += sum(bool(lint._DISABLE_RE.search(ln))
                        for ln in src.splitlines())
        unreasoned += [(path, n) for n in lint.unreasoned_disables(src)]
    assert disables >= 3 and unreasoned == []


# --------------------------------------------------------------------- #
# the entry point
# --------------------------------------------------------------------- #


def test_entry_point_clean_on_the_tree(capsys):
    assert lint.main([]) == 0
    assert "0 finding(s)" in capsys.readouterr().out


@pytest.mark.parametrize("rule,case,path,src,want", FIRES,
                         ids=[f"{r}-{c}" for r, c, *_ in FIRES])
def test_entry_point_fails_each_fixture(rule, case, path, src, want,
                                        tmp_path, capsys):
    target = tmp_path / path
    target.parent.mkdir(parents=True, exist_ok=True)
    target.write_text(src)
    assert lint.main(["--root", str(tmp_path), "--paths", PKG]) == 1
    out = capsys.readouterr().out
    assert f"{path}:" in out and f": {rule}: " in out


def test_entry_point_json_and_records(tmp_path, capsys):
    from pytorch_distributed_training_tpu_torch.obs import (
        read_events, validate_events,
    )

    bad = tmp_path / PKG / "serve" / "bad.py"
    bad.parent.mkdir(parents=True)
    bad.write_text("import pdb\nbreakpoint()\n")
    (tmp_path / "chip_smoke.py").write_text("print('ok')\n")
    metrics = tmp_path / "metrics"
    assert lint.main(["--root", str(tmp_path), "--json", "--metrics-dir",
                      str(metrics)]) == 1
    report = json.loads(capsys.readouterr().out)
    assert report["report"]["files_checked"] == 2
    assert report["report"]["rules"] == sorted(RULES)
    assert report["report"]["seconds"] >= 0
    assert [r["rule"] for r in report["findings"]] == ["debug-stray"] * 2
    events = read_events(str(metrics / "events.rank00000.jsonl"))
    validate_events(events)
    recs = [e for e in events if e.get("record") == "graftcheck_finding"]
    validate_finding_records(recs)
    assert [(r["path"], r["line"]) for r in recs] == [
        (f"{PKG}/serve/bad.py", 1), (f"{PKG}/serve/bad.py", 2)]
    assert lint.main(["--root", str(tmp_path), "--rules", "axis-literal",
                      "--json"]) == 0
    assert json.loads(capsys.readouterr().out)["findings"] == []


def test_entry_point_refuses_a_missing_target_and_unknown_rule(tmp_path):
    with pytest.raises(SystemExit) as e:
        lint.main(["--root", str(tmp_path), "--paths", "nosuch"])
    assert e.value.code == 2
    with pytest.raises(SystemExit) as e:
        lint.main(["--rules", "tracer-leak"])
    assert e.value.code == 2


@pytest.mark.parametrize("registry", ["missing", "no-checker", "syntax"])
def test_metric_registry_loader_raises(registry, tmp_path):
    """No silent fallback: an unreadable registry is an error, where
    JAX's loader lets the rule go quiet."""
    path = tmp_path / "schema.py"
    if registry == "no-checker":
        path.write_text("METRICS = {}\n")
    elif registry == "syntax":
        path.write_text("def check_metric_name(:\n")
    with pytest.raises(RuntimeError, match="metric registry"):
        lint.load_metric_checker(str(path))
