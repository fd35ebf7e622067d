"""AST rule engine for codebase invariants the runtime can't cheaply check.

Port of ``deepspeedsyclsupport_tpu/analysis/codelint.py``, run over the
port's own tree (``deepspeedsyclsupport_tpu_torch/``) with the same rule
names, the same ``# dslint: allow(<rule-name>)`` suppression and the same
baseline workflow (``baseline.py``; the port's baseline is
``analysis/dslint_baseline.json``). Each rule encodes a contract:

* ``signal-handler-safety`` — ``runtime/resilience.py`` contract: a signal
  handler runs between bytecodes of the frame it interrupted, so any lock
  acquisition (Event.set, logging, counters), allocation-heavy call or IO
  inside one can deadlock the process at the worst possible moment. Handler
  bodies may only do attribute stores on pre-existing objects.
* ``undeclared-event-name`` — every monitor event name in a declared group
  (``Train/``, ``Goodput/``, …) must resolve against the port's
  ``monitor/telemetry.py`` ``EVENT_NAMES``/``EVENT_PREFIXES`` registry
  (``undeclared-region`` and ``undeclared-stage-name`` likewise against
  ``monitor/mfu.py`` and ``monitor/reqtrace.py``).
* ``wall-clock-in-step-path`` — ``time.time()`` is wall clock; NTP steps it
  backwards/forwards under running jobs, corrupting durations. Step-path
  modules must measure with ``time.perf_counter()``/``monotonic()`` (or the
  ``utils/timer.py`` timers, which do). Wall timestamps meant for humans
  are fine — suppress those lines explicitly.
* ``host-sync-in-step-path`` — ``.item()``, ``.cpu()``, ``.tolist()``,
  ``.numpy()`` and ``torch.cuda.synchronize()`` in a step-path module wait
  for the card, serializing host dispatch against device compute. Syncs
  belong at print boundaries, checkpoint sites, the designated gates and
  opt-in telemetry paths (``HOST_SYNC_SANCTIONED``).

Suppression: append ``# dslint: allow(<rule-name>)`` to the offending line
(with a reason in a nearby comment). CLI (the JAX package's
``tools/dslint.py``, its flags, output and exit codes)::

    python -m deepspeedsyclsupport_tpu_torch.analysis.codelint --check
"""
import ast
import os
import re
from dataclasses import dataclass
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Set

#: the tree :func:`lint_paths` walks by default (repo-relative)
PACKAGE = "deepspeedsyclsupport_tpu_torch"

# --------------------------------------------------------------------- model


@dataclass(frozen=True)
class Violation:
    rule: str
    path: str          # repo-relative
    line: int
    message: str
    snippet: str       # stripped source line — the stable part of the key

    @property
    def key(self) -> str:
        """Line-number-independent identity used by the baseline: a moved
        violation is the same debt, an edited one is new."""
        return f"{self.rule}|{self.path}|{self.snippet}"

    def __str__(self) -> str:
        return f"{self.path}:{self.line}: [{self.rule}] {self.message}"


_ALLOW_RE = re.compile(r"#\s*dslint:\s*allow\(([\w\-, ]+)\)")


def _suppressed(source_lines: Sequence[str], lineno: int, rule: str) -> bool:
    if not 1 <= lineno <= len(source_lines):
        return False
    m = _ALLOW_RE.search(source_lines[lineno - 1])
    return bool(m) and rule in [r.strip() for r in m.group(1).split(",")]


# ------------------------------------------------------------- module scopes

#: modules on the training/inference step path: wall-clock durations and
#: host syncs here execute once per step (or per token)
STEP_PATH_MODULES = (
    "runtime/engine.py", "runtime/zero.py", "runtime/zeropp.py",
    "runtime/onebit.py", "runtime/loss_scaler.py", "runtime/sentinel.py",
    "comm/comm.py", "comm/comms_logging.py",
    "parallel/", "inference/v2/", "moe/",
    "utils/timer.py", "monitor/telemetry.py",
    "elasticity/elastic_agent.py",
)

#: functions sanctioned to host-sync: print boundaries, checkpoint /
#: telemetry sites, offline accessors, the engine's designated gates
#: (the fp16 / sentinel verdicts every rank must agree on before the
#: update) and the opt-in timed paths. module-relative "ClassName.method"
#: or "func".
HOST_SYNC_SANCTIONED = {
    "runtime/engine.py": {
        "Engine._post_step", "Engine._flush_monitor", "Engine.get_lr",
        "Engine.get_loss_scale", "Engine.get_global_grad_norm",
        "Engine.skipped_steps", "Engine._sync", "Engine.stop_profile",
        "Engine.save_checkpoint", "Engine.load_checkpoint",
        "Engine.eval_batch", "Engine.xla_comms_summary",
        "Engine.graph_report", "Engine.emit_comm_census",
        "Engine.mfu_ledger",
        # offline accessors: the whole tree to the host
        "shard_params_from_jax", "gather_params",
        # the armed sentinel's gate: the step's scalars read once, before
        # the update, so every rank applies or skips alike
        "Engine._apply_grads", "Engine._dist_gate",
        # resume: the ranks agree on a tag before any step
        "Engine._agree_resume_tag",
    },
    # the sentinel's designated pull: lag-deferred reads of step scalars
    # whose step already retired (and its rollback / abort paths)
    "runtime/sentinel.py": {
        "TrainingSentinel._process", "TrainingSentinel._rollback",
        "TrainingSentinel._abort", "_scalar",
    },
    # the 1-bit optimizers' warm-up switch, read at the step it happens
    "runtime/onebit.py": {"_scalar"},
    # the synchronized timers (wall_clock_breakdown, opt-in)
    "utils/timer.py": {"_sync"},
    # a decode round's sampled tokens to the host: the serving loop's one
    # read a round (the scheduler decides the next round on them)
    "inference/v2/engine_v2.py": {
        "InferenceEngineV2._decode_multi_dispatch",
        "InferenceEngineV2.generate",
    },
    "inference/v2/serving.py": {"ServingSession._per_token_round"},
    # a write into a pinned host buffer (no device read)
    "inference/v2/graphs.py": {"DecodeRunner.__call__"},
    # the timed logger's syncs (opt-in: comms_logger.timed)
    "comm/comm.py": {"barrier", "_run"},
    "elasticity/elastic_agent.py": set(),
}


def _in_step_path(relpath: str) -> bool:
    return any(relpath.endswith(m) or (m.endswith("/") and f"/{m}" in
               f"/{relpath}") for m in STEP_PATH_MODULES)


# --------------------------------------------------------------------- rules


class Rule:
    name = ""
    description = ""

    def check(self, relpath: str, tree: ast.AST,
              source_lines: Sequence[str]) -> Iterable[Violation]:
        raise NotImplementedError


def _qualname(stack: Sequence[ast.AST]) -> str:
    parts = [n.name for n in stack
             if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                               ast.ClassDef))]
    return ".".join(parts) or "<module>"


class _ScopedVisitor(ast.NodeVisitor):
    """Tracks the class/function nesting stack while visiting."""

    def __init__(self):
        self.stack: List[ast.AST] = []

    def visit_scope(self, node):
        self.stack.append(node)
        self.generic_visit(node)
        self.stack.pop()

    visit_FunctionDef = visit_AsyncFunctionDef = visit_ClassDef = visit_scope


def _call_name(node: ast.Call) -> str:
    """Dotted name of a call target ('time.time', 'torch.cuda.synchronize', ...)."""
    parts: List[str] = []
    t = node.func
    while isinstance(t, ast.Attribute):
        parts.append(t.attr)
        t = t.value
    if isinstance(t, ast.Name):
        parts.append(t.id)
    return ".".join(reversed(parts))


class SignalHandlerSafety(Rule):
    name = "signal-handler-safety"
    description = ("signal handlers may only store attributes — no calls, "
                   "locks, allocs or IO (runtime/resilience.py contract)")

    def check(self, relpath, tree, source_lines):
        handlers: List[ast.FunctionDef] = []
        defs: Dict[str, ast.FunctionDef] = {}
        for node in ast.walk(tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                defs[node.name] = node
                if node.name == "_on_signal":
                    handlers.append(node)
        for node in ast.walk(tree):
            if (isinstance(node, ast.Call)
                    and _call_name(node).endswith("signal.signal")
                    and len(node.args) >= 2):
                h = node.args[1]
                hname = (h.attr if isinstance(h, ast.Attribute)
                         else h.id if isinstance(h, ast.Name) else None)
                if hname in defs:
                    handlers.append(defs[hname])
        seen: Set[int] = set()
        for fn in handlers:
            if id(fn) in seen:
                continue
            seen.add(id(fn))
            for sub in ast.walk(fn):
                bad: Optional[str] = None
                if isinstance(sub, ast.Call):
                    bad = f"call to {_call_name(sub) or 'expression'}()"
                elif isinstance(sub, (ast.With, ast.AsyncWith)):
                    bad = "with-block (lock acquisition)"
                elif isinstance(sub, (ast.Import, ast.ImportFrom)):
                    bad = "import (allocates, takes the import lock)"
                elif isinstance(sub, ast.Raise):
                    bad = "raise (unwinds the interrupted frame)"
                if bad is None:
                    continue
                line = getattr(sub, "lineno", fn.lineno)
                if _suppressed(source_lines, line, self.name):
                    continue
                snippet = source_lines[line - 1].strip() \
                    if line <= len(source_lines) else ""
                yield Violation(
                    self.name, relpath, line,
                    f"signal handler {fn.name!r} does {bad}; handlers must "
                    f"be async-signal-safe (attribute stores only)", snippet)


class UndeclaredEventName(Rule):
    name = "undeclared-event-name"
    description = ("monitor event-name literals in declared groups must "
                   "resolve against telemetry's EVENT_NAMES/EVENT_PREFIXES")

    def __init__(self):
        from ..monitor import telemetry as T

        self._is_declared = T.is_declared
        groups = {n.split("/", 1)[0] for n in T.EVENT_NAMES}
        groups |= {p.rstrip("/") for p in T.EVENT_PREFIXES}
        self._groups = groups

    def check(self, relpath, tree, source_lines):
        if relpath.startswith(("tests/", "docs/")):
            return
        docstrings = _docstring_linenos(tree)
        for node in ast.walk(tree):
            if not (isinstance(node, ast.Constant)
                    and isinstance(node.value, str)):
                continue
            s = node.value
            if "/" not in s or "\n" in s:
                continue
            first = s.split("/", 1)[0]
            if first not in self._groups:
                continue
            if node.lineno in docstrings:
                continue
            if self._is_declared(s) or self._is_declared(s + "/x"):
                # exact name, family member, or a group prefix being used
                # to BUILD a name (f-string / concat base like "Comm/")
                continue
            if s.rstrip("/") in self._groups:
                continue
            if _suppressed(source_lines, node.lineno, self.name):
                continue
            snippet = source_lines[node.lineno - 1].strip() \
                if node.lineno <= len(source_lines) else ""
            yield Violation(
                self.name, relpath, node.lineno,
                f"event name {s!r} is in declared group {first!r} but does "
                f"not resolve against the telemetry registry (typo, or add "
                f"it to EVENT_NAMES / declare_events)", snippet)


class UndeclaredRegionName(Rule):
    name = "undeclared-region"
    description = ("MFU region labels (region_scope(...) / 'mfu.<name>' "
                   "scope literals) must resolve against monitor/mfu.py's "
                   "SCOPE_REGIONS registry — a typo'd label silently "
                   "orphans its region's time in the step-time ledger")

    def __init__(self):
        from ..monitor.mfu import SCOPE_PREFIX, SCOPE_REGIONS

        self._regions = set(SCOPE_REGIONS)
        self._prefix = SCOPE_PREFIX

    def _bad(self, label: str) -> bool:
        return label not in self._regions

    def check(self, relpath, tree, source_lines):
        if relpath.startswith(("tests/", "docs/")):
            return
        docstrings = _docstring_linenos(tree)
        # region_scope("<literal>") calls with an undeclared region
        region_call_args: Set[int] = set()
        for node in ast.walk(tree):
            if not isinstance(node, ast.Call) or not node.args:
                continue
            if _call_name(node).split(".")[-1] not in ("region_scope",
                                                       "named_scope"):
                continue
            arg = node.args[0]
            if not (isinstance(arg, ast.Constant)
                    and isinstance(arg.value, str)):
                continue
            region_call_args.add(id(arg))
            s = arg.value
            label = (s[len(self._prefix):]
                     if s.startswith(self._prefix) else s)
            is_scope_helper = _call_name(node).endswith("region_scope")
            if not is_scope_helper and not s.startswith(self._prefix):
                continue  # unrelated named_scope — not an MFU region
            if self._bad(label) and not _suppressed(
                    source_lines, node.lineno, self.name):
                snippet = source_lines[node.lineno - 1].strip() \
                    if node.lineno <= len(source_lines) else ""
                yield Violation(
                    self.name, relpath, node.lineno,
                    f"MFU region {label!r} is not declared in "
                    f"monitor/mfu.py SCOPE_REGIONS (typo, or add the "
                    f"region there + to the MFU/region.* event family)",
                    snippet)
        # bare "mfu.<name>" literals anywhere else (building a label by
        # hand bypasses region_scope's runtime check)
        for node in ast.walk(tree):
            if not (isinstance(node, ast.Constant)
                    and isinstance(node.value, str)):
                continue
            if id(node) in region_call_args or node.lineno in docstrings:
                continue
            s = node.value
            if not s.startswith(self._prefix) or "\n" in s or "/" in s:
                continue
            if s.endswith((".py", ".json", ".gz", ".txt", ".md")):
                continue  # a filename (mfu.py, mfu_opmap.json), not a label
            label = s[len(self._prefix):]
            if not label or not label.replace("_", "").isalnum():
                continue  # "mfu." prefix itself / regex fragments
            if self._bad(label) and not _suppressed(
                    source_lines, node.lineno, self.name):
                snippet = source_lines[node.lineno - 1].strip() \
                    if node.lineno <= len(source_lines) else ""
                yield Violation(
                    self.name, relpath, node.lineno,
                    f"string {s!r} names MFU region {label!r} which is "
                    f"not in monitor/mfu.py SCOPE_REGIONS", snippet)


class UndeclaredStageName(Rule):
    name = "undeclared-stage-name"
    description = ("request-lifecycle stage literals (ServingSession._stage /"
                   " RequestJournal.stage / note_stage calls and "
                   "{'stage': ...} record payloads) must resolve against "
                   "monitor/reqtrace.py's stage registries — a typo'd stage "
                   "silently orphans its interval as 'unattributed' in every "
                   "request waterfall")

    STAGE_CALLS = ("stage", "_stage", "note_stage")

    def __init__(self):
        from ..monitor.reqtrace import FLEET_STAGES, SERVE_STAGES

        self._stages = set(SERVE_STAGES) | set(FLEET_STAGES)

    def _literals(self, node):
        """String constants reachable from a stage argument (plain literal
        or the branches of a conditional expression)."""
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            yield node.value, node.lineno
        elif isinstance(node, ast.IfExp):
            yield from self._literals(node.body)
            yield from self._literals(node.orelse)

    def check(self, relpath, tree, source_lines):
        if relpath.startswith(("tests/", "docs/")):
            return
        docstrings = _docstring_linenos(tree)

        def _flag(value, lineno, where):
            if value in self._stages or lineno in docstrings:
                return None
            if _suppressed(source_lines, lineno, self.name):
                return None
            snippet = source_lines[lineno - 1].strip() \
                if lineno <= len(source_lines) else ""
            return Violation(
                self.name, relpath, lineno,
                f"stage {value!r} ({where}) is not declared in "
                f"monitor/reqtrace.py SERVE_STAGES/FLEET_STAGES — the "
                f"join would bucket its time as 'unattributed' (typo, or "
                f"declare the stage + its Serve/stage.* event)", snippet)

        for node in ast.walk(tree):
            if isinstance(node, ast.Call) and len(node.args) >= 2 and \
                    _call_name(node).split(".")[-1] in self.STAGE_CALLS:
                for value, lineno in self._literals(node.args[1]):
                    v = _flag(value, lineno, "stage call")
                    if v is not None:
                        yield v
            elif isinstance(node, ast.Dict):
                for k, val in zip(node.keys, node.values):
                    if isinstance(k, ast.Constant) and k.value == "stage":
                        for value, lineno in self._literals(val):
                            v = _flag(value, lineno, "record payload")
                            if v is not None:
                                yield v


def _docstring_linenos(tree: ast.AST) -> Set[int]:
    """Line ranges of every docstring (multi-line strings included)."""
    out: Set[int] = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.FunctionDef,
                             ast.AsyncFunctionDef, ast.ClassDef)):
            body = getattr(node, "body", [])
            if body and isinstance(body[0], ast.Expr) and \
                    isinstance(body[0].value, ast.Constant) and \
                    isinstance(body[0].value.value, str):
                end = getattr(body[0], "end_lineno", body[0].lineno)
                out.update(range(body[0].lineno, end + 1))
    return out


class WallClockInStepPath(Rule):
    name = "wall-clock-in-step-path"
    description = ("time.time() in step-path modules — wall clock jumps "
                   "under NTP; use time.perf_counter()/monotonic() (or the "
                   "utils/timer.py timers)")

    def check(self, relpath, tree, source_lines):
        if not _in_step_path(relpath):
            return
        for node in ast.walk(tree):
            if isinstance(node, ast.Call) and _call_name(node) == "time.time":
                if _suppressed(source_lines, node.lineno, self.name):
                    continue
                snippet = source_lines[node.lineno - 1].strip() \
                    if node.lineno <= len(source_lines) else ""
                yield Violation(
                    self.name, relpath, node.lineno,
                    "time.time() measures wall clock; step-path durations "
                    "must use time.perf_counter() (NTP steps corrupt "
                    "wall-clock deltas)", snippet)


class HostSyncInStepPath(Rule):
    name = "host-sync-in-step-path"
    description = (".item()/.cpu()/.tolist()/.numpy()/"
                   "torch.cuda.synchronize() outside sanctioned checkpoint/"
                   "telemetry/gate sites stall the dispatch pipeline")

    #: tensor methods that wait for the card and copy to the host
    SYNC_METHODS = ("item", "cpu", "tolist", "numpy")
    SYNC_CALLS = ("cuda.synchronize",)

    def _is_sync(self, node: ast.Call) -> bool:
        name = _call_name(node)
        if any(name.endswith(c) for c in self.SYNC_CALLS):
            return True
        return isinstance(node.func, ast.Attribute) and \
            node.func.attr in self.SYNC_METHODS and not node.args

    def check(self, relpath, tree, source_lines):
        if not _in_step_path(relpath):
            return
        sanctioned = HOST_SYNC_SANCTIONED.get(
            next((m for m in HOST_SYNC_SANCTIONED if relpath.endswith(m)),
                 relpath), set())

        violations: List[Violation] = []
        rule = self

        class V(_ScopedVisitor):
            def visit_Call(self, node):
                if rule._is_sync(node):
                    qn = _qualname(self.stack)
                    if qn not in sanctioned and not _suppressed(
                            source_lines, node.lineno, rule.name):
                        snippet = source_lines[node.lineno - 1].strip() \
                            if node.lineno <= len(source_lines) else ""
                        violations.append(Violation(
                            rule.name, relpath, node.lineno,
                            f"host sync {_call_name(node)}() in step-path "
                            f"function {qn!r}; move it to a print boundary "
                            f"/ checkpoint site or suppress with a reason",
                            snippet))
                self.generic_visit(node)

        V().visit(tree)
        yield from violations


ALL_RULES: Sequence[Callable[[], Rule]] = (
    SignalHandlerSafety, UndeclaredEventName, UndeclaredRegionName,
    UndeclaredStageName, WallClockInStepPath, HostSyncInStepPath)


# -------------------------------------------------------------------- runner

def lint_paths(root: str, relpaths: Optional[Iterable[str]] = None,
               rules: Optional[Sequence[Rule]] = None) -> List[Violation]:
    """Run every rule over the package tree under ``root`` (repo root).
    ``relpaths`` limits the scan; default walks the port package
    (``deepspeedsyclsupport_tpu_torch``) alone."""
    if rules is None:
        rules = [cls() for cls in ALL_RULES]
    if relpaths is None:
        relpaths = []
        for dirpath, dirnames, files in os.walk(os.path.join(root, PACKAGE)):
            dirnames[:] = [d for d in dirnames if d != "__pycache__"]
            for f in sorted(files):
                if f.endswith(".py"):
                    relpaths.append(os.path.relpath(
                        os.path.join(dirpath, f), root))
    out: List[Violation] = []
    for rel in sorted(relpaths):
        path = os.path.join(root, rel)
        try:
            source = open(path, encoding="utf-8").read()
            tree = ast.parse(source)
        except (OSError, SyntaxError):
            continue
        lines = source.splitlines()
        rel_posix = rel.replace(os.sep, "/")
        for rule in rules:
            out.extend(rule.check(rel_posix, tree, lines))
    return out


# ----------------------------------------------------------------------- CLI
REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def run_codebase_lint(args) -> int:
    from . import baseline as B

    violations = lint_paths(REPO_ROOT)
    baseline_path = os.path.join(REPO_ROOT, args.baseline)
    if args.update_baseline:
        counts = B.save_baseline(baseline_path, violations)
        print(f"dslint: baseline rewritten with {sum(counts.values())} "
              f"violation(s) across {len(counts)} key(s) -> {args.baseline}")
        return 0
    check = B.check_against_baseline(violations,
                                     B.load_baseline(baseline_path))
    for v in check.new:
        print(f"{v}  [NEW]")
    if args.verbose:
        for v in check.baselined:
            print(f"{v}  [baselined]")
    for k in check.stale_keys:
        print(f"dslint: stale baseline entry (violation fixed — run "
              f"--update-baseline): {k}")
    print(f"dslint: {len(check.new)} new, {len(check.baselined)} baselined, "
          f"{len(check.stale_keys)} stale")
    return 0 if check.ok else 1


def run_graph_lint(_args) -> int:
    """One counted step of the ``tiny`` model on the CPU (a world of one)
    and every ``Engine.graph_report`` analyzer over it: the smoke proof
    that the analyzers run (the real holds are the tests')."""
    import numpy as np

    from .. import build_model, initialize

    model = build_model("tiny", dtype="float32")
    cfg = {"train_batch_size": 4, "steps_per_print": 10_000,
           "optimizer": {"type": "AdamW", "params": {"lr": 1e-3}},
           "flops_profiler": {"enabled": True, "profile_step": 1,
                              "output_file": os.devnull}}
    engine = initialize(model=model, config=cfg, device="cpu")[0]
    ids = np.random.RandomState(0).randint(0, model.config.vocab_size,
                                           (4, 32))
    engine.train_batch({"input_ids": ids})
    report = engine.graph_report()
    ok = True
    for name in ("collectives", "donation", "resharding", "dtype"):
        print(report[name].report())
        ok = ok and report[name].ok
    return 0 if ok else 1


def main(argv=None) -> int:
    import argparse

    from .baseline import DEFAULT_BASELINE

    p = argparse.ArgumentParser(
        prog="python -m deepspeedsyclsupport_tpu_torch.analysis.codelint",
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--check", action="store_true",
                   help="codebase lint vs the baseline (default action)")
    p.add_argument("--update-baseline", action="store_true",
                   help="regenerate the baseline from the current tree")
    p.add_argument("--graph", action="store_true",
                   help="run one tiny CPU step and the graph analyzers")
    p.add_argument("--list-rules", action="store_true")
    p.add_argument("--baseline", default=DEFAULT_BASELINE)
    p.add_argument("-v", "--verbose", action="store_true",
                   help="also print baselined violations")
    args = p.parse_args(argv)
    if args.list_rules:
        for cls in ALL_RULES:
            print(f"{cls.name}: {cls.description}")
        return 0
    if args.graph:
        return run_graph_lint(args)
    return run_codebase_lint(args)


if __name__ == "__main__":
    import sys

    try:
        sys.exit(main())
    except Exception as e:  # usage/internal errors are exit 2, not a pass
        print(f"dslint: error: {e}", file=sys.stderr)
        sys.exit(2)
