"""AST lint of the port's own sources: the JAX package's
``analysis/lint.py`` where its rules carry over to torch code, and rules
for the bug classes the port itself has shipped or nearly shipped.

    python -m pytorch_distributed_training_tpu_torch.analysis.lint
        [--root R] [--paths P ...] [--rules ID ...] [--json]
        [--metrics-dir DIR]

Exit status 0 when clean, 1 on any finding.  The analysis is per module
and syntactic: no code of a linted file is imported or executed.

Carried over from JAX, finding for finding on the same source:

- ``debug-stray``        — ``pdb``/``ipdb`` imports, ``set_trace``,
  ``breakpoint()`` (``jax.debug.print`` has no twin in use here);
- ``axis-literal``       — a collective called with a raw mesh-axis
  literal (JAX's spelling), and the port's own spellings:
  ``<x>.group(<axis>)``, ``<x>.axes_size(<axis>)``,
  ``<x>.axes_index(<axis>)``, ``<x>.shape[<axis>]`` and
  ``<x>.coords[<axis>]`` for one of the six axes of ``comm/mesh.py``
  or a tuple of them (a dict subscript ``d["tensor"]`` stays silent);
- ``shard-axis-unknown`` — ``P(...)``/``PartitionSpec(...)`` naming an
  axis no mesh has (``parallel/sharding.py``'s ``P``);
- ``metric-name``        — a ``gauge``/``counter_add``/``observe`` name
  that ``obs/schema.py`` does not declare for that instrument.  Where
  JAX's rule goes quiet when the registry cannot be read, this one
  raises;
- ``bad-disable``, ``parse-error``.

Twins of JAX rules whose premise is tracing:

- ``host-read`` (twin of ``tracer-leak``) — a read of a tensor's value
  back to the host in warm-step code (the package's ``train/``,
  ``parallel/``, ``ops/`` and ``resilience/anomaly.py``) and in a
  captured body (a function decorated ``@captured``: the serving
  engine's program bodies, which a CUDA graph captures): ``.item()``,
  ``.tolist()``, ``.cpu()``, ``.numpy()``; ``float()``/``int()``/
  ``bool()`` of a tensor or an ``if``/``while`` test on one; a subscript
  by a 0-dim tensor.  The AST has no types, so a name counts as a tensor
  only where one function shows it: bound from a ``torch.*`` call or a
  tensor method on such a name, or a parameter annotated
  ``torch.Tensor``.  Numpy values and shape math stay silent.  A first
  line, not a proof: the tests' ``_NoHostReads`` and the card's sync
  debug mode are the runtime pins;
- ``global-rng`` (twin of ``host-entropy``) — a draw from a
  process-global generator in the package: ``torch.rand``-family draws
  and in-place ``normal_``-family draws without ``generator=``,
  ``np.random.<draw>`` and ``np.random.seed``, stdlib ``random.*`` (an
  explicit ``random.Random(seed)`` is a generator of its own, not a
  draw), ``torch.manual_seed`` (and ``torch.cuda``'s seeders).  A name
  counts only where it is bound to that module;
- ``host-clock-in-capture`` (twin of ``host-clock-in-trace``) — a host
  clock read (``time.perf_counter``/``monotonic``/``time`` and their
  ``_ns`` forms) or a span call (``phase_span``, ``start_span``, ...)
  inside a captured body: a graph runs the body once, at capture, and
  replays its device work without the host code, so the reading would
  time the capture and never a replay.

No twin: ``tracer-leak``'s, ``host-entropy``'s and
``host-clock-in-trace``'s premises are met by the three above;
``host-commit``, ``donated-reuse`` and ``donate-no-out-shardings`` guard
donated or AOT-compiled XLA programs, and the port donates and compiles
none (its graphs write the cache in place and take no donation);
``select-gate`` guards against XLA re-fusing a select, and the guarded
step's ``torch.where`` selects are its design (``resilience/anomaly.py``).

The port's own bug classes, each from a fault a review found:

- ``raw-collective``         — a tensor collective reached through
  ``torch.distributed`` (any alias, function-local imports included) in
  the package outside ``comm/``, which bypasses the transport rules of
  ``comm/collectives.py``; the pickled ``*_object*`` forms, ``barrier``,
  ``new_group`` and the ``get_*``/``is_*`` queries are exempt;
- ``argv-bool``              — a function that walks
  ``<parser>._actions`` and emits ``str(value)`` as an option's value
  without first branching on ``argparse.BooleanOptionalAction`` and on
  ``_StoreTrueAction``/``_StoreFalseAction`` (``--flag True`` is an
  error for such a flag);
- ``init-shadows-submodule`` — a package ``__init__.py`` binding a
  sibling submodule's name to something other than that module, so
  ``import pkg.sub as m`` yields the function, not the module.

Escape hatch, JAX's: a ``graftcheck: disable=<id>[,<id>] — why``
comment on the line (or on a comment-only line above it) suppresses
those rules there; ``graftcheck: disable-file=<id>`` a whole file.  The
port's gate adds one condition: a disable gives its reason after the
ids, or it is a ``bad-disable`` finding.  The live tree lints clean.
"""

from __future__ import annotations

import argparse
import ast
import dataclasses
import functools
import importlib.util
import json
import os
import re
import sys
import time
from typing import Iterable

from .findings import Finding, finding_record, validate_finding_records

PACKAGE = "pytorch_distributed_training_tpu_torch"
_REPO_ROOT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_SCHEMA_PATH = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "obs",
    "schema.py")

# ---------------------------------------------------------------------- #
# rule registry
# ---------------------------------------------------------------------- #


@dataclasses.dataclass(frozen=True)
class Rule:
    rule_id: str
    description: str
    fixit: str


RULES: dict[str, Rule] = {
    r.rule_id: r
    for r in (
        Rule(
            "debug-stray",
            "debugger left in library code",
            "remove it (or gate it behind an explicit debug flag)",
        ),
        Rule(
            "axis-literal",
            "raw mesh-axis string literal at a collective or mesh call "
            "site",
            "use the comm.mesh AXIS_* constants so a typo'd axis cannot "
            "silently select the wrong group",
        ),
        Rule(
            "shard-axis-unknown",
            "PartitionSpec names an axis no project mesh has",
            "use the comm.mesh axis constants — an unknown axis in a "
            "PartitionSpec silently replicates instead of sharding",
        ),
        Rule(
            "metric-name",
            "emitter metric name not declared in the schema registry",
            "declare the name (with its instrument type) in "
            "obs/schema.py — a typo'd name silently forks a new time "
            "series instead of failing",
        ),
        Rule(
            "host-read",
            "tensor value read back to the host in warm-step code",
            "keep the value on the device (a torch op, index_select for "
            "a 0-dim index), or read it once at a log point",
        ),
        Rule(
            "host-clock-in-capture",
            "host clock read or span call inside a captured body",
            "time and span on the host around the replay (the engine's "
            "tick spans): the body runs once, at capture",
        ),
        Rule(
            "global-rng",
            "draw from a process-global random generator",
            "pass an explicit generator (torch.Generator, "
            "np.random.default_rng, random.Random) seeded by the caller",
        ),
        Rule(
            "raw-collective",
            "tensor collective through torch.distributed outside comm/",
            "call the comm.collectives wrapper: it maps group ranks, "
            "stages what a backend cannot carry and feeds the census",
        ),
        Rule(
            "argv-bool",
            "parser actions re-emitted as argv with str(value) for "
            "boolean flags",
            "branch on argparse.BooleanOptionalAction (emit --flag or "
            "--no-flag) and on _StoreTrueAction/_StoreFalseAction (emit "
            "the bare flag) before emitting str(value)",
        ),
        Rule(
            "init-shadows-submodule",
            "package __init__ binds a sibling submodule's name to "
            "another object",
            "export the object under another name, or reach the module "
            "through a from-import of its full path",
        ),
        Rule(
            "bad-disable",
            "disable comment naming an unknown rule or giving no reason",
            "fix the rule id — a typo'd disable suppresses nothing — and "
            "say after the ids why the rule is wrong there",
        ),
        Rule(
            "parse-error",
            "module failed to parse",
            "fix the syntax error so the module can be analyzed",
        ),
    )
}

# JAX's axis-literal vocabulary and collective names, as JAX has them.
_MESH_AXIS_LITERALS = frozenset({
    "data", "fsdp", "expert", "pipeline", "sequence", "tensor",
    "data_dcn", "data_ici",
})
_COLLECTIVE_NAMES = frozenset({
    "psum", "pmean", "pmax", "pmin", "all_gather", "psum_scatter",
    "reduce_scatter", "ppermute", "all_to_all", "axis_index", "broadcast",
})
# The six axes of comm/mesh.py, mirrored as literals (the tests pin them
# equal to MESH_AXES); the port's mesh calls and maps that take one.
PORT_AXES = ("data", "fsdp", "expert", "pipeline", "sequence", "tensor")
_MESH_AXIS_METHODS = frozenset({"group", "axes_size", "axes_index"})
_MESH_AXIS_MAPS = frozenset({"shape", "coords"})
# Every axis a mesh can carry: the six plus their DCN/ICI factors
# (comm/mesh.py dcn_axis_name / ici_axis_name).
KNOWN_AXES = frozenset(PORT_AXES) | {
    f"{axis}_{tier}" for axis in PORT_AXES for tier in ("dcn", "ici")
}

_STATIC_ATTRS = frozenset({
    "shape", "size", "ndim", "dtype", "itemsize", "nbytes",
})
_METRIC_METHODS = frozenset({"gauge", "counter_add", "observe"})

# host-read: where warm-step code lives, under the package.
_HOST_READ_DIRS = frozenset({"train", "parallel", "ops"})
_HOST_READ_FILES = frozenset({("resilience", "anomaly.py")})
_READ_METHODS = frozenset({"item", "tolist", "cpu", "numpy"})
# A captured body: a function decorated with this name (``serve/engine.py
# ::captured``), which a CUDA graph records once and replays.
_CAPTURE_DECORATOR = "captured"
# host-clock-in-capture: the host clocks, and the span API of obs/ (JAX's
# names; the ambiguous ones fire only with a string span name first).
_CLOCK_ATTRS = frozenset({"monotonic", "perf_counter", "time",
                          "monotonic_ns", "perf_counter_ns", "time_ns"})
_SPAN_CALLS = frozenset({"start_span", "end_span", "record_span",
                         "phase_span", "step_annotation"})
_SPAN_CALLS_AMBIGUOUS = frozenset({"span", "annotate"})
# Tensor methods and torch functions whose result is not a tensor.
_NON_TENSOR_METHODS = frozenset({
    "item", "tolist", "numpy", "numel", "nelement", "dim", "ndimension",
    "size", "stride", "storage_offset", "element_size", "data_ptr",
    "is_floating_point", "is_complex", "is_contiguous", "is_pinned",
    "is_shared", "is_nonzero", "equal", "get_device", "untyped_storage",
    "storage", "register_hook", "backward", "dim_order",
})
_TENSOR_ATTRS = frozenset({"T", "mT", "H", "mH", "data", "grad", "real",
                           "imag"})
_NON_TENSOR_TORCH = frozenset({
    "is_tensor", "is_storage", "is_floating_point", "is_complex",
    "is_nonzero", "is_grad_enabled", "is_inference_mode_enabled",
    "is_autocast_enabled", "numel", "typename", "get_default_dtype",
    "get_default_device", "set_default_dtype", "set_default_device",
    "device", "no_grad", "enable_grad", "inference_mode",
    "set_grad_enabled", "manual_seed", "seed", "initial_seed",
    "use_deterministic_algorithms", "are_deterministic_algorithms_enabled",
    "get_num_threads", "set_num_threads", "compile", "result_type",
    "promote_types", "can_cast", "broadcast_shapes", "set_printoptions",
    "equal", "allclose", "finfo", "iinfo", "autocast",
})
_NON_TENSOR_TORCH_MODULES = frozenset({
    "cuda", "distributed", "backends", "utils", "profiler", "jit",
    "compiler", "overrides", "testing", "hub", "onnx", "export", "fx",
    "library", "multiprocessing", "package", "autograd",
})
# Full reductions (no dim: a 0-dim result) and the shape-keeping methods
# a 0-dim tensor stays 0-dim under.
_REDUCTIONS = frozenset({
    "sum", "mean", "max", "min", "argmax", "argmin", "prod", "amax",
    "amin", "norm", "all", "any", "count_nonzero", "std", "var", "median",
})
_SHAPE_KEEPING = frozenset({
    "clamp", "clamp_", "clip", "to", "long", "int", "float", "double",
    "half", "bfloat16", "detach", "clone", "contiguous", "abs", "neg",
    "add", "sub", "mul", "div", "floor", "ceil", "round", "sqrt", "exp",
    "log", "remainder", "fmod", "type_as", "add_", "sub_", "mul_", "div_",
})
_FACTORIES = frozenset({"zeros", "ones", "empty", "full"})

# global-rng: torch's draws (and their _like forms), in-place draws,
# numpy's explicit-generator constructors, torch's global seeders.
_TORCH_DRAWS = frozenset({
    "rand", "randn", "randint", "randperm", "bernoulli", "multinomial",
    "normal", "rand_like", "randn_like", "randint_like",
})
_INPLACE_DRAWS = frozenset({"normal_", "uniform_", "random_", "bernoulli_",
                            "exponential_"})
_NP_GENERATORS = frozenset({
    "default_rng", "Generator", "SeedSequence", "BitGenerator", "PCG64",
    "PCG64DXSM", "Philox", "SFC64", "MT19937", "RandomState",
})
_TORCH_SEEDERS = frozenset({"torch.manual_seed", "torch.cuda.manual_seed",
                            "torch.cuda.manual_seed_all"})

# raw-collective: torch.distributed's tensor collectives.
_TENSOR_COLLECTIVES = frozenset({
    "all_reduce", "broadcast", "send", "recv", "isend", "irecv",
    "batch_isend_irecv", "gather", "scatter", "reduce",
})
_TENSOR_COLLECTIVE_PREFIXES = ("all_gather", "reduce_scatter", "all_to_all")

# argv-bool: the action classes a re-emitter must branch on.
_BOOL_OPTIONAL = "BooleanOptionalAction"
_STORE_BOOL = frozenset({"_StoreTrueAction", "_StoreFalseAction"})


@functools.lru_cache(maxsize=None)
def load_metric_checker(schema_path: str = _SCHEMA_PATH):
    """``check_metric_name`` of the port's ``obs/schema.py``, loaded by
    file path (it imports nothing).  Raises ``RuntimeError`` when the
    registry cannot be read: a lint that cannot check a name must not
    pass it."""
    spec = importlib.util.spec_from_file_location(
        "_port_metric_schema", schema_path)
    if spec is None or spec.loader is None:
        raise RuntimeError(f"metric registry {schema_path} is not loadable")
    module = importlib.util.module_from_spec(spec)
    try:
        spec.loader.exec_module(module)
        return module.check_metric_name
    except (OSError, SyntaxError, AttributeError) as e:
        raise RuntimeError(
            f"metric registry {schema_path} is unreadable: {e}") from e


# Rule ids are kebab-case tokens terminated at whitespace: an ASCII
# "- why" reason after the id must read as the reason, not get swallowed
# into a bogus rule name (which would both fail to suppress and fire
# bad-disable).
_DISABLE_RE = re.compile(
    r"#\s*graftcheck:\s*disable(?P<scope>-file)?\s*=\s*"
    r"(?P<rules>[a-z0-9_-]+(?:\s*,\s*[a-z0-9_-]+)*)"
)
# What may separate the ids from the reason.
_REASON_SEPARATORS = " \t-–—:;,."


# ---------------------------------------------------------------------- #
# small AST helpers (JAX's)
# ---------------------------------------------------------------------- #


def _dotted(node: ast.AST) -> str:
    """``a.b.c`` for Name/Attribute chains, '' otherwise."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


def _is_captured(fn) -> bool:
    """Whether ``fn`` carries the ``@captured`` decorator (any spelling:
    ``captured``, ``<module>.captured``)."""
    return any(_tail(d.func if isinstance(d, ast.Call) else d)
               == _CAPTURE_DECORATOR for d in fn.decorator_list)


def _tail(node: ast.AST) -> str:
    """The final component of a call target: ``torch.rand`` → ``rand``."""
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Name):
        return node.id
    return ""


def _contains_static_access(node: ast.AST) -> bool:
    """Whether the expression reads shape metadata or ``len()`` anywhere —
    the marker for host math over trace-time constants."""
    for sub in ast.walk(node):
        if isinstance(sub, ast.Attribute) and sub.attr in _STATIC_ATTRS:
            return True
        if (
            isinstance(sub, ast.Call)
            and isinstance(sub.func, ast.Name)
            and sub.func.id == "len"
        ):
            return True
    return False


def _str_constants(node: ast.AST) -> list[ast.Constant]:
    """A string constant, or the string constants of a tuple/list."""
    elts = node.elts if isinstance(node, (ast.Tuple, ast.List)) else [node]
    return [el for el in elts
            if isinstance(el, ast.Constant) and isinstance(el.value, str)]


def _has_keyword(call: ast.Call, name: str) -> bool:
    return any(kw.arg == name for kw in call.keywords)


# ---------------------------------------------------------------------- #
# suppression comments (JAX's, plus the reason check)
# ---------------------------------------------------------------------- #


def _suppressions(
    src: str,
) -> tuple[dict[int, set[str]], set[str], list[tuple[int, str]]]:
    """(line → disabled rules, file-wide disabled rules, raw entries).
    A line suppression covers its own line and the next (comment-above
    style); ``raw`` keeps (lineno, rule) so typo'd ids can be reported
    with a location."""
    per_line: dict[int, set[str]] = {}
    file_wide: set[str] = set()
    raw: list[tuple[int, str]] = []
    for lineno, line in enumerate(src.splitlines(), start=1):
        mo = _DISABLE_RE.search(line)
        if not mo:
            continue
        rules = {
            r.strip() for r in mo.group("rules").split(",") if r.strip()
        }
        raw.extend((lineno, r) for r in rules)
        if mo.group("scope"):
            file_wide |= rules
        else:
            per_line.setdefault(lineno, set()).update(rules)
            # Comment-above style covers the NEXT line too — but only
            # for comment-only lines: a trailing disable must not bleed
            # onto the following statement (which nobody reviewed).
            if line.lstrip().startswith("#"):
                per_line.setdefault(lineno + 1, set()).update(rules)
    return per_line, file_wide, raw


def unreasoned_disables(src: str) -> list[int]:
    """Lines whose disable comment gives nothing after its ids."""
    out = []
    for lineno, line in enumerate(src.splitlines(), start=1):
        mo = _DISABLE_RE.search(line)
        if mo and not line[mo.end():].strip(_REASON_SEPARATORS):
            out.append(lineno)
    return out


# ---------------------------------------------------------------------- #
# the rules
# ---------------------------------------------------------------------- #


def _package_parts(path: str) -> tuple[str, ...] | None:
    """``path``'s components below the package directory, or None when
    it lies outside the package."""
    parts = path.replace(os.sep, "/").split("/")
    if PACKAGE not in parts:
        return None
    return tuple(parts[len(parts) - parts[::-1].index(PACKAGE):])


def _import_bindings(nodes: list[ast.AST]) -> dict[str, str]:
    """Name → the module or object an import binds it to, over every
    import of the file (function-local ones included)."""
    out: dict[str, str] = {}
    for node in nodes:
        if isinstance(node, ast.Import):
            for alias in node.names:
                if alias.asname:
                    out[alias.asname] = alias.name
                else:
                    root = alias.name.split(".")[0]
                    out[root] = root
        elif isinstance(node, ast.ImportFrom) and node.level == 0 \
                and node.module:
            for alias in node.names:
                out[alias.asname or alias.name] = f"{node.module}.{alias.name}"
    return out


class _RuleRunner:
    def __init__(self, tree: ast.Module, src: str, path: str,
                 enabled: set[str]):
        self.tree = tree
        self.path = path
        self.enabled = enabled
        self.findings: list[Finding] = []
        self.per_line, self.file_wide, self.raw_disables = \
            _suppressions(src)
        self.nodes = list(ast.walk(tree))
        self.bindings = _import_bindings(self.nodes)
        self.in_package = _package_parts(path)

    def report(self, rule_id: str, node: ast.AST, message: str) -> None:
        if rule_id not in self.enabled or rule_id in self.file_wide:
            return
        lineno = getattr(node, "lineno", 0)
        if rule_id in self.per_line.get(lineno, ()):
            return
        self.findings.append(Finding(
            rule=rule_id, message=message, path=self.path, line=lineno,
            col=getattr(node, "col_offset", 0),
            fixit=RULES[rule_id].fixit,
        ))

    def qualified(self, node: ast.AST) -> str:
        """``node``'s dotted name with its first part resolved through
        the file's imports ('' when that part is not an import)."""
        dotted = _dotted(node)
        head, _, rest = dotted.partition(".")
        if head not in self.bindings:
            return ""
        return self.bindings[head] + (f".{rest}" if rest else "")

    def run(self) -> list[Finding]:
        parts = self.in_package
        warm = parts is not None and parts and (
            parts[0] in _HOST_READ_DIRS or parts in _HOST_READ_FILES)
        for node in self.nodes:
            self._check_node(node)
            if isinstance(node, ast.Subscript):
                self._check_axis_map(node)
            if isinstance(node, ast.For):
                self._check_argv_bool(node)
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                captured = parts is not None and _is_captured(node)
                if warm or captured:
                    _HostReads(self, node).scan()
                if captured:
                    self._check_clock_in_capture(node)
        if parts and parts[-1] == "__init__.py":
            self._check_init_shadows()
        return self.findings

    # -- per-node rules --------------------------------------------------

    def _check_node(self, node: ast.AST) -> None:
        if isinstance(node, ast.Import):
            for alias in node.names:
                if alias.name in ("pdb", "ipdb"):
                    self.report(
                        "debug-stray", node,
                        f"import {alias.name} in library code",
                    )
        if not isinstance(node, ast.Call):
            return
        dotted = _dotted(node.func)
        tail = _tail(node.func)

        if dotted in ("pdb.set_trace", "ipdb.set_trace") or (
            isinstance(node.func, ast.Name)
            and node.func.id == "breakpoint"
        ):
            self.report(
                "debug-stray", node, f"{dotted or 'breakpoint()'} left in "
                "code",
            )

        # axis-literal, JAX's spelling: a collective given a raw axis.
        if tail in _COLLECTIVE_NAMES:
            for arg in list(node.args) + [k.value for k in node.keywords]:
                if (
                    isinstance(arg, ast.Constant)
                    and isinstance(arg.value, str)
                    and arg.value in _MESH_AXIS_LITERALS
                ):
                    self.report(
                        "axis-literal", node,
                        f"{tail}(..., {arg.value!r}) uses a raw axis "
                        "literal",
                    )
                elif isinstance(arg, (ast.Tuple, ast.List)) and any(
                    isinstance(el, ast.Constant)
                    and isinstance(el.value, str)
                    and el.value in _MESH_AXIS_LITERALS
                    for el in arg.elts
                ):
                    self.report(
                        "axis-literal", node,
                        f"{tail}(...) takes a tuple with raw axis "
                        "literals",
                    )
        # axis-literal, the port's spelling: mesh.group("tensor") etc.
        if (
            isinstance(node.func, ast.Attribute)
            and tail in _MESH_AXIS_METHODS
            and node.args
            and self._is_axis_literal(node.args[0])
        ):
            self.report(
                "axis-literal", node,
                f".{tail}({ast.unparse(node.args[0])}) uses a raw axis "
                "literal",
            )

        # shard-axis-unknown.
        if tail in ("P", "PartitionSpec"):
            for arg in node.args:
                for const in _str_constants(arg):
                    if const.value not in KNOWN_AXES:
                        self.report(
                            "shard-axis-unknown", node,
                            f"{tail}(...) names axis {const.value!r}, "
                            "which no project mesh has",
                        )

        if (
            tail in _METRIC_METHODS
            and isinstance(node.func, ast.Attribute)
            and node.args
        ):
            self._check_metric_name(node, tail)

        if self.in_package is not None:
            self._check_global_rng(node, tail)
            if self.in_package[:1] != ("comm",):
                self._check_raw_collective(node)

    @staticmethod
    def _is_axis_literal(node: ast.AST) -> bool:
        return any(c.value in PORT_AXES for c in _str_constants(node))

    def _check_axis_map(self, node: ast.Subscript) -> None:
        if (
            isinstance(node.value, ast.Attribute)
            and node.value.attr in _MESH_AXIS_MAPS
            and self._is_axis_literal(node.slice)
        ):
            self.report(
                "axis-literal", node,
                f".{node.value.attr}[{ast.unparse(node.slice)}] uses a raw "
                "axis literal",
            )

    def _check_metric_name(self, node: ast.Call, method: str) -> None:
        """Purely syntactic: literal first args, the static prefix of
        f-string names, and ``labeled("name", ...)`` wrappers are checked
        against obs/schema.py."""
        arg = node.args[0]
        if (
            isinstance(arg, ast.Call)
            and _tail(arg.func) == "labeled"
            and arg.args
        ):
            arg = arg.args[0]  # labeled("ttft_s", **view) → "ttft_s"
        dynamic = False
        if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
            name = arg.value
        elif isinstance(arg, ast.JoinedStr):
            parts: list[str] = []
            for v in arg.values:
                if isinstance(v, ast.Constant) and isinstance(v.value, str):
                    parts.append(v.value)
                else:
                    break
            name = "".join(parts)
            dynamic = True
            if not name:
                return  # no static prefix: nothing checkable
        else:
            return
        if "metric-name" not in self.enabled:
            return
        problem = load_metric_checker()(name, method, dynamic=dynamic)
        if problem:
            self.report("metric-name", node, problem)

    def _check_global_rng(self, node: ast.Call, tail: str) -> None:
        if "global-rng" not in self.enabled:
            return
        name = self.qualified(node.func)
        if name.startswith("torch.") and name[6:] in _TORCH_DRAWS and \
                not _has_keyword(node, "generator"):
            self.report("global-rng", node,
                        f"{name}() without generator= draws from torch's "
                        "global generator")
        elif name in _TORCH_SEEDERS:
            self.report("global-rng", node,
                        f"{name}() seeds a process-global generator")
        elif name.startswith("numpy.random.") and \
                name.rsplit(".", 1)[1] not in _NP_GENERATORS:
            self.report("global-rng", node,
                        f"{name}() uses numpy's global generator")
        elif name.startswith("random.") and name != "random.Random":
            self.report("global-rng", node,
                        f"{name}() uses the stdlib's global generator")
        elif (
            isinstance(node.func, ast.Attribute)
            and tail in _INPLACE_DRAWS
            and not _has_keyword(node, "generator")
        ):
            self.report("global-rng", node,
                        f".{tail}() without generator= draws from torch's "
                        "global generator")

    def _check_clock_in_capture(self, fn) -> None:
        """A host clock read or a span call anywhere in captured ``fn``."""
        for node in ast.walk(fn):
            if not isinstance(node, ast.Call):
                continue
            tail = _tail(node.func)
            if tail in _SPAN_CALLS or (
                tail in _SPAN_CALLS_AMBIGUOUS and node.args
                and isinstance(node.args[0], ast.Constant)
                and isinstance(node.args[0].value, str)
            ):
                self.report(
                    "host-clock-in-capture", node,
                    f"{_dotted(node.func) or tail}() inside captured "
                    f"{fn.name}() would record the capture, not a replay")
            elif self.qualified(node.func) in {
                    f"time.{a}" for a in _CLOCK_ATTRS}:
                self.report(
                    "host-clock-in-capture", node,
                    f"{_dotted(node.func)}() inside captured {fn.name}() "
                    "reads the host clock at capture only")

    def _check_raw_collective(self, node: ast.Call) -> None:
        name = self.qualified(node.func)
        if not name.startswith("torch.distributed."):
            return
        op = name.rsplit(".", 1)[1]
        if op.endswith(("_object", "_object_list")):
            return
        if op in _TENSOR_COLLECTIVES or op.startswith(
                _TENSOR_COLLECTIVE_PREFIXES):
            self.report("raw-collective", node,
                        f"{name}() outside comm/ bypasses "
                        "comm.collectives")

    def _check_argv_bool(self, loop: ast.For) -> None:
        """A loop over ``<parser>._actions`` emitting ``str(...)`` before
        it has branched on the boolean action classes."""
        if not (isinstance(loop.iter, ast.Attribute)
                and loop.iter.attr == "_actions"):
            return
        seen: list[tuple[int, str]] = []   # (line, class) of isinstance tests
        emits: list[ast.Call] = []
        for sub in ast.walk(loop):
            if not isinstance(sub, ast.Call):
                continue
            if _tail(sub.func) == "isinstance" and len(sub.args) == 2:
                for cls in (sub.args[1].elts
                            if isinstance(sub.args[1], ast.Tuple)
                            else [sub.args[1]]):
                    seen.append((sub.lineno, _tail(cls)))
            elif isinstance(sub.func, ast.Name) and sub.func.id == "str":
                emits.append(sub)
        for call in emits:
            before = {cls for line, cls in seen if line <= call.lineno}
            if _BOOL_OPTIONAL not in before or not before & _STORE_BOOL:
                self.report(
                    "argv-bool", call,
                    "str(value) emitted for a parser action before "
                    "branching on BooleanOptionalAction and "
                    "_StoreTrueAction/_StoreFalseAction",
                )

    def _check_init_shadows(self) -> None:
        """Module-level bindings of a sibling submodule's name (a module
        this ``__init__`` imports from) to anything but that module."""
        body = self.tree.body
        siblings = {
            node.module.split(".")[0] for node in body
            if isinstance(node, ast.ImportFrom) and node.level == 1
            and node.module
        } | {
            alias.name for node in body
            if isinstance(node, ast.ImportFrom) and node.level == 1
            and not node.module for alias in node.names
        }
        for node in body:
            bound: list[str] = []
            if isinstance(node, ast.ImportFrom):
                if node.level == 1 and not node.module:
                    bound = [a.asname for a in node.names
                             if a.asname and a.asname != a.name]
                else:
                    bound = [a.asname or a.name for a in node.names]
            elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                   ast.ClassDef)):
                bound = [node.name]
            elif isinstance(node, (ast.Assign, ast.AnnAssign)):
                targets = (node.targets if isinstance(node, ast.Assign)
                           else [node.target])
                bound = [t.id for t in targets if isinstance(t, ast.Name)]
            for name in bound:
                if name in siblings:
                    self.report(
                        "init-shadows-submodule", node,
                        f"{name!r} is bound over the submodule "
                        f".{name}: `import <package>.{name} as m` yields "
                        "this object, not the module",
                    )


class _HostReads(ast.NodeVisitor):
    """The host-read rule over one function, in source order: which names
    hold tensors (and which 0-dim ones) as the function binds them, and
    the reads of their values.  Nested functions get their own scan."""

    def __init__(self, runner: _RuleRunner, fn):
        self.runner = runner
        self.fn = fn
        args = fn.args
        self.tensors = {
            a.arg for a in args.posonlyargs + args.args + args.kwonlyargs
            if a.annotation is not None and self._tensor_annotation(
                a.annotation)
        }
        self.scalars: set[str] = set()

    def scan(self) -> None:
        for stmt in self.fn.body:
            self.visit(stmt)

    def _tensor_annotation(self, node: ast.AST) -> bool:
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            try:
                node = ast.parse(node.value, mode="eval").body
            except SyntaxError:
                return False
        return any(
            isinstance(sub, (ast.Attribute, ast.Name))
            and self.runner.qualified(sub) == "torch.Tensor"
            for sub in ast.walk(node))

    def report(self, node: ast.AST, what: str) -> None:
        self.runner.report(
            "host-read", node, f"{what} in {self.fn.name}() reads a tensor "
            "back to the host")

    # -- inference -------------------------------------------------------

    def _torch_call(self, call: ast.Call) -> str:
        """The function's name under ``torch.`` when ``call`` is a
        tensor-producing torch function, else ''."""
        name = self.runner.qualified(call.func)
        if not name.startswith("torch."):
            return ""
        rest = name[6:]
        head, _, last = rest.rpartition(".")
        if head.split(".")[0] in _NON_TENSOR_TORCH_MODULES:
            return ""
        if last in _NON_TENSOR_TORCH or not (
                last[:1].islower() or last.startswith("_foreach_")):
            return ""
        return rest

    def is_tensor(self, node: ast.AST) -> bool:
        if isinstance(node, ast.Name):
            return node.id in self.tensors
        if isinstance(node, ast.Call):
            if self._torch_call(node):
                return True
            return (isinstance(node.func, ast.Attribute)
                    and node.func.attr not in _NON_TENSOR_METHODS
                    and self.is_tensor(node.func.value))
        if isinstance(node, ast.Attribute):
            return node.attr in _TENSOR_ATTRS and self.is_tensor(node.value)
        if isinstance(node, ast.Subscript):
            return self.is_tensor(node.value)
        if isinstance(node, ast.BinOp):
            return self.is_tensor(node.left) or self.is_tensor(node.right)
        if isinstance(node, ast.UnaryOp):
            return not isinstance(node.op, ast.Not) and \
                self.is_tensor(node.operand)
        if isinstance(node, ast.Compare):
            return not any(isinstance(op, (ast.Is, ast.IsNot, ast.In,
                                           ast.NotIn)) for op in node.ops) \
                and any(self.is_tensor(x)
                        for x in [node.left, *node.comparators])
        if isinstance(node, ast.IfExp):
            return self.is_tensor(node.body) and self.is_tensor(node.orelse)
        return False

    def is_0dim(self, node: ast.AST) -> bool:
        if isinstance(node, ast.Name):
            return node.id in self.scalars
        if isinstance(node, ast.BinOp):
            left, right = self.is_0dim(node.left), self.is_0dim(node.right)
            return (left or right) and (left or not self.is_tensor(
                node.left)) and (right or not self.is_tensor(node.right))
        if isinstance(node, ast.UnaryOp):
            return self.is_0dim(node.operand)
        if not isinstance(node, ast.Call):
            return False
        fn = self._torch_call(node)
        if fn:
            if fn in ("tensor", "scalar_tensor"):
                return bool(node.args) and isinstance(
                    node.args[0], (ast.Constant, ast.UnaryOp))
            if fn in _FACTORIES:
                return bool(node.args) and isinstance(
                    node.args[0], (ast.Tuple, ast.List)) and \
                    not node.args[0].elts
            if fn in _REDUCTIONS:
                return len(node.args) == 1 and not node.keywords
            if fn == "where":
                return any(self.is_0dim(a) for a in node.args) and all(
                    self.is_0dim(a) or not self.is_tensor(a)
                    for a in node.args)
            return False
        if not (isinstance(node.func, ast.Attribute)
                and self.is_tensor(node.func.value)):
            return False
        attr = node.func.attr
        if attr in _REDUCTIONS:
            return not node.args and not node.keywords
        if attr in ("view", "reshape"):
            return len(node.args) == 1 and isinstance(
                node.args[0], (ast.Tuple, ast.List)) and \
                not node.args[0].elts
        return attr in _SHAPE_KEEPING and self.is_0dim(node.func.value)

    def _bind(self, target: ast.AST, value: ast.AST | None) -> None:
        if isinstance(target, ast.Name):
            tensor = value is not None and self.is_tensor(value)
            zero = value is not None and self.is_0dim(value)
            (self.tensors.add if tensor else self.tensors.discard)(target.id)
            (self.scalars.add if zero else self.scalars.discard)(target.id)
        elif isinstance(target, (ast.Tuple, ast.List)):
            if isinstance(value, (ast.Tuple, ast.List)) and \
                    len(value.elts) == len(target.elts):
                for t, v in zip(target.elts, value.elts):
                    self._bind(t, v)
                return
            # Unpacking a tensor (x.chunk(3), torch.split) gives tensors.
            tensor = value is not None and self.is_tensor(value)
            for t in target.elts:
                if isinstance(t, ast.Starred):
                    t = t.value
                if isinstance(t, ast.Name):
                    self.scalars.discard(t.id)
                    (self.tensors.add if tensor else
                     self.tensors.discard)(t.id)

    # -- visitors ---------------------------------------------------------

    def visit_FunctionDef(self, node):  # nested: scanned on its own
        pass

    visit_AsyncFunctionDef = visit_FunctionDef
    visit_ClassDef = visit_FunctionDef

    def visit_Assign(self, node: ast.Assign):
        self.visit(node.value)
        for target in node.targets:
            if not isinstance(target, (ast.Name, ast.Tuple, ast.List)):
                self.visit(target)
            self._bind(target, node.value)

    def visit_AnnAssign(self, node: ast.AnnAssign):
        if node.value is not None:
            self.visit(node.value)
        if isinstance(node.target, ast.Name) and self._tensor_annotation(
                node.annotation):
            self.tensors.add(node.target.id)
            self.scalars.discard(node.target.id)
        else:
            self._bind(node.target, node.value)

    def visit_AugAssign(self, node: ast.AugAssign):
        self.visit(node.value)
        if isinstance(node.target, ast.Name):
            if self.is_tensor(node.value):
                self.tensors.add(node.target.id)
        else:
            self.visit(node.target)

    def visit_NamedExpr(self, node: ast.NamedExpr):
        self.visit(node.value)
        self._bind(node.target, node.value)

    def _visit_loop_target(self, target: ast.AST) -> None:
        for sub in ast.walk(target):
            if isinstance(sub, ast.Name):
                self.tensors.discard(sub.id)
                self.scalars.discard(sub.id)

    def visit_For(self, node: ast.For):
        self.visit(node.iter)
        self._visit_loop_target(node.target)
        for stmt in node.body + node.orelse:
            self.visit(stmt)

    visit_AsyncFor = visit_For

    def visit_comprehension(self, node: ast.comprehension):
        self.visit(node.iter)
        self._visit_loop_target(node.target)
        for cond in node.ifs:
            self.visit(cond)

    def visit_ListComp(self, node):
        """The generators bind before the element is read."""
        for gen in node.generators:
            self.visit(gen)
        for field in ("elt", "key", "value"):
            if hasattr(node, field):
                self.visit(getattr(node, field))

    visit_SetComp = visit_GeneratorExp = visit_DictComp = visit_ListComp

    def _test(self, node: ast.AST) -> None:
        if self.is_tensor(node) or (
            isinstance(node, ast.BoolOp)
            and any(self.is_tensor(v) for v in node.values)
        ) or (
            isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.Not)
            and self.is_tensor(node.operand)
        ):
            self.report(node, f"the test `{ast.unparse(node)}`")

    def visit_If(self, node: ast.If):
        self._test(node.test)
        self.generic_visit(node)

    visit_While = visit_If
    visit_IfExp = visit_If

    def visit_Call(self, node: ast.Call):
        func = node.func
        if (
            isinstance(func, ast.Attribute)
            and func.attr in _READ_METHODS
            and self.is_tensor(func.value)
        ):
            self.report(node, f".{func.attr}()")
        elif (
            isinstance(func, ast.Name)
            and func.id in ("float", "int", "bool")
            and node.args
            and not _contains_static_access(node.args[0])
            and self.is_tensor(node.args[0])
        ):
            self.report(node, f"{func.id}({ast.unparse(node.args[0])})")
        self.generic_visit(node)

    def visit_Subscript(self, node: ast.Subscript):
        index = node.slice.elts if isinstance(node.slice, ast.Tuple) \
            else [node.slice]
        for i in index:
            if self.is_0dim(i):
                self.report(node, f"a subscript by the 0-dim tensor "
                            f"`{ast.unparse(i)}`")
        self.generic_visit(node)


# ---------------------------------------------------------------------- #
# entry points
# ---------------------------------------------------------------------- #

DEFAULT_LINT_TARGETS = (PACKAGE, "chip_smoke.py")

_SKIP_DIRS = {"__pycache__", ".git", "csrc"}


def lint_source(
    src: str, path: str = "<string>", *,
    enabled: Iterable[str] | None = None,
) -> list[Finding]:
    """Lint one module's source; ``path`` places it (the package-scoped
    rules read it).  ``enabled`` restricts the rule set (default: all
    rules)."""
    enabled_set = set(enabled) if enabled is not None else set(RULES)
    unknown = enabled_set - set(RULES)
    if unknown:
        raise ValueError(f"unknown rules {sorted(unknown)}")
    try:
        tree = ast.parse(src)
    except SyntaxError as e:
        return [Finding(
            rule="parse-error", message=f"unparseable module: {e}",
            path=path, line=e.lineno or 0,
            fixit=RULES["parse-error"].fixit,
        )]
    runner = _RuleRunner(tree, src, path, enabled_set)
    findings = runner.run()
    # A disable comment naming an unknown rule silently suppresses
    # nothing — surface the typo as its own finding.
    for lineno, rule_id in runner.raw_disables:
        if rule_id not in RULES:
            findings.append(Finding(
                rule="bad-disable",
                message=f"disable comment names unknown rule "
                        f"{rule_id!r}",
                path=path, line=lineno,
                fixit=RULES["bad-disable"].fixit,
            ))
    for lineno in unreasoned_disables(src):
        findings.append(Finding(
            rule="bad-disable",
            message="disable comment gives no reason after its ids",
            path=path, line=lineno, fixit=RULES["bad-disable"].fixit,
        ))
    findings.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    return findings


def iter_python_files(targets: Iterable[str], root: str) -> list[str]:
    """Every ``.py`` file under ``targets`` (files or directories relative
    to ``root``); a target that does not exist raises."""
    out: list[str] = []
    for target in targets:
        full = os.path.join(root, target)
        if os.path.isfile(full):
            out.append(full)
            continue
        if not os.path.isdir(full):
            raise FileNotFoundError(f"lint target {full} does not exist")
        for dirpath, dirnames, filenames in os.walk(full):
            dirnames[:] = sorted(d for d in dirnames if d not in _SKIP_DIRS)
            for fname in sorted(filenames):
                if fname.endswith(".py"):
                    out.append(os.path.join(dirpath, fname))
    return out


def lint_paths(
    targets: Iterable[str] | None = None, *, root: str | None = None,
    enabled: Iterable[str] | None = None,
) -> list[Finding]:
    """Lint every ``.py`` under ``targets`` (files or directories,
    relative to ``root`` — default: the port and ``chip_smoke.py`` in
    this checkout)."""
    root = _REPO_ROOT if root is None else root
    findings: list[Finding] = []
    for path in iter_python_files(targets or DEFAULT_LINT_TARGETS, root):
        with open(path, encoding="utf-8") as f:
            src = f.read()
        findings.extend(lint_source(src, os.path.relpath(path, root),
                                    enabled=enabled))
    return findings


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m pytorch_distributed_training_tpu_torch.analysis."
        "lint", description=__doc__.splitlines()[0],
    )
    ap.add_argument("--root", default=_REPO_ROOT,
                    help="directory the lint targets resolve against")
    ap.add_argument("--paths", nargs="+", default=None,
                    help="lint targets (files or directories, relative to "
                    f"--root; default: {' '.join(DEFAULT_LINT_TARGETS)})")
    ap.add_argument("--rules", nargs="+", default=None, choices=sorted(RULES),
                    metavar="ID", help="run only these rules")
    ap.add_argument("--json", action="store_true",
                    help="print the findings and the report as JSON")
    ap.add_argument("--metrics-dir", default=None,
                    help="also write each finding as a graftcheck_finding "
                    "record through the obs emitter")
    args = ap.parse_args(argv)
    targets = args.paths or DEFAULT_LINT_TARGETS
    t0 = time.perf_counter()
    try:
        files = iter_python_files(targets, args.root)
    except FileNotFoundError as e:
        ap.error(str(e))
    findings = lint_paths(targets, root=args.root, enabled=args.rules)
    seconds = time.perf_counter() - t0
    records = [finding_record(f) for f in findings]
    validate_finding_records(records)  # the schema gate, emitting side
    if args.metrics_dir:
        from ..obs import MetricsEmitter

        with MetricsEmitter(args.metrics_dir, rank=0, world=1,
                            meta={"tool": "lint"}) as em:
            for rec in records:
                em.emit("record", rec)
            em.summary(lint_findings=len(records), lint_clean=not records)
    rules = sorted(args.rules or RULES)
    if args.json:
        print(json.dumps({"findings": records, "report": {
            "files_checked": len(files), "rules": rules,
            "findings": len(records), "seconds": seconds,
        }}, indent=2))
    else:
        for f in findings:
            print(f.format())
        print(f"lint: {len(files)} files, {len(rules)} rules, "
              f"{len(findings)} finding(s), {seconds:.2f} s"
              + (" — clean" if not findings else ""))
    return 1 if findings else 0


if __name__ == "__main__":
    sys.exit(main())
