"""torchlint (``src/repro_torch/analysis``): a trigger and a near-miss
fixture per T-rule, the rules without a JAX idiom (T3, T4, T6) against
their reference rules (R3, R4, R6) on shared fixtures, the suppression,
baseline and CLI machinery, and the gate: the port's tree is clean with an
empty baseline.

Fixtures are strings written under ``tmp_path``: no fixture is a file of
``src/``, which both linters walk.
"""
import ast
import textwrap
from pathlib import Path

import pytest

from repro.analysis.core import lint_paths as r_lint_paths
from repro_torch.analysis import lint as tlint
from repro_torch.analysis.callgraph import Index
from repro_torch.analysis.core import (Finding, collect_files, lint_paths,
                                       load_baseline, project_from_sources,
                                       run_rules)

SRC = Path(__file__).resolve().parent.parent / "src"


def _write(root, files):
    for rel, src in files.items():
        p = root / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(textwrap.dedent(src))


def _lint(tmp_path, files, rules=None):
    _write(tmp_path, files)
    return lint_paths([tmp_path], rules=rules)


def _where(findings):
    return sorted((f.path, f.line) for f in findings)


# ---------------------------------------------------------------------------
# T1 capture purity
# ---------------------------------------------------------------------------
_T1_STEP = """\
    import functools
    import time

    import torch
    from graphs import ChunkGraphs

    def helper(x, n):
        k = n.item()
        print(k)
        return x * time.perf_counter()

    def step(model, x, n, opts=[]):
        if torch.any(x > 0):
            x = x + 1
        return helper(x, n) + int(n)

    {build}
    """


def test_t1_flags_host_work_reachable_from_a_captured_step(tmp_path):
    found = _lint(tmp_path, {"graphs.py": "class ChunkGraphs: pass\n",
                             "mod.py": _T1_STEP.format(
        build="G = ChunkGraphs(functools.partial(step, None), 'cuda')")},
        rules=["T1"])
    msgs = {f.line: f.message for f in found}
    assert all(f.rule == "T1" for f in found)
    assert ".item()" in msgs[8] and "print()" in msgs[9]
    assert "host clock" in msgs[10]
    assert "mutable default" in msgs[12]
    assert "branch on a tensor" in msgs[13]
    assert "`int(n)`" in msgs[15]


def test_t1_near_miss_step_not_captured(tmp_path):
    # the same functions, but no graph takes the step: host work is fine
    found = _lint(tmp_path, {"graphs.py": "class ChunkGraphs: pass\n",
                             "mod.py": _T1_STEP.format(build="G = None")},
                  rules=["T1"])
    assert found == []


def test_t1_capture_roots_through_capture_begin_and_overlap(tmp_path):
    found = _lint(tmp_path, {"mod.py": """\
        import functools
        import numpy as np

        def overlap(x):
            return np.asarray(x)

        def clean(x):
            return x + 1

        class Runner:
            def step_fn(self):
                return functools.partial(overlap)

            def chunk(self, graphs):
                graphs.run(1, overlap=(self.step_fn(), None))

        class Graph:
            def step(self):
                return clean(self.x).cpu()

            def capture(self, g):
                g.capture_begin()
                self.out = self.step()
                g.capture_end()
        """}, rules=["T1"])
    assert _where(found) == [("mod.py", 5), ("mod.py", 19)]


def test_t1_follows_a_callable_field_of_a_project_class(tmp_path):
    files = {"mod.py": """\
        import functools
        from graphs import ChunkGraphs

        class Model:
            def __init__(self, verify):
                self.verify = verify

        def _dense():
            def verify(x):
                return x.{call}()
            return Model(verify=verify)

        def step(model, x):
            return model.verify(x)

        G = ChunkGraphs(functools.partial(step, _dense()), "cuda")
        """, "graphs.py": "class ChunkGraphs: pass\n"}
    found = _lint(tmp_path, {k: v.replace("{call}", "cpu")
                             for k, v in files.items()}, rules=["T1"])
    assert _where(found) == [("mod.py", 10)]
    # near miss: the field is bound to a function with no host work
    assert _lint(tmp_path, {k: v.replace("{call}", "sin")
                            for k, v in files.items()}, rules=["T1"]) == []


_PORT_ROOTS = {("runtime/graphs.py", "StepGraph.step"),
               ("runtime/engine.py", "_decode_step"),
               ("core/hcmp/executors.py", "overlap_step"),
               ("core/hcmp/executors.py", "HcmpOverlapRunner.step_fn")}


def _port_project(edit=None):
    sources = {f.rel: f.text for f in collect_files([SRC / "repro_torch"])}
    if edit is not None:
        edit(sources)
    return project_from_sources(sources)


def test_port_capture_roots_reach_the_models_and_the_kernels():
    """The clean-tree gate of T1, T2 and T7 is only as strong as the
    roots: the captured steps the graphs take, and through the model's
    callable fields every family's verify, the attention and the kernel
    wrappers."""
    idx = Index(_port_project())
    assert _PORT_ROOTS <= {(f.file.rel, f.qualname) for f in idx.roots}
    reached = {(f.file.rel, f.qualname) for f in idx.reached_from_capture()}
    for rel, qual in [("models/api.py", "_dense_like.verify"),
                      ("models/transformer.py", "verify"),
                      ("models/hybrid.py", "verify"),
                      ("models/xlstm_model.py", "verify"),
                      ("models/encdec.py", "verify"),
                      ("core/speculative/verify.py", "spec_step"),
                      ("runtime/cache.py", "capacity_left")]:
        assert (rel, qual) in reached, (rel, qual)
    assert {"kernels/dispatch.py", "kernels/launch.py", "models/attention.py",
            "models/mamba2.py"} <= {rel for rel, _ in reached}


def test_port_host_sync_injected_into_a_kernel_wrapper_is_caught():
    idx = Index(_port_project())
    fi = next(f for f in idx.reached_from_capture()
              if f.file.rel == "kernels/dispatch.py"
              and not isinstance(f.node, ast.Lambda))
    first = fi.node.body[0]

    def edit(sources):
        lines = sources["kernels/dispatch.py"].splitlines(keepends=True)
        lines.insert(first.lineno - 1, " " * first.col_offset
                     + "torch.cuda.synchronize()\n")
        sources["kernels/dispatch.py"] = "".join(lines)

    found = run_rules(_port_project(edit), ["T1"])
    assert [(f.path, f.line) for f in found] == \
        [("kernels/dispatch.py", first.lineno)], found


# ---------------------------------------------------------------------------
# T2 in-place state
# ---------------------------------------------------------------------------
def test_t2_flags_rebinding_dropped_carry_field_write_and_release(tmp_path):
    found = _lint(tmp_path, {"graphs.py": """\
        def bump(cache):
            cache.k = cache.k + 1
            return cache

        class Graph:
            def step(self):
                state, done, rem = self.step_fn(self.state)
                self.state = bump(state)
                return rem

            def capture(self, g):
                g.capture_begin()
                self.step()
                g.capture_end()

        def measure(graphs, state):
            graphs.release(state)
            return state.cache
        """}, rules=["T2"])
    msgs = " | ".join(f"{f.line}: {f.message}" for f in found)
    assert _where(found) == [("graphs.py", 2), ("graphs.py", 7),
                             ("graphs.py", 8), ("graphs.py", 18)], msgs
    assert "drops the carry `done`" in msgs
    assert "rebinds `self.state`" in msgs
    assert "field `k` of the carry `cache`" in msgs
    assert "read after `release(state)`" in msgs


def test_t2_near_miss_copy_back_in_place(tmp_path):
    found = _lint(tmp_path, {"graphs.py": """\
        def bump(cache):
            cache.k.add_(1)
            return cache

        class Graph:
            def step(self):
                state, done, rem = self.step_fn(self.state)
                self.state.copy_(bump(state))
                self.done.copy_(done)
                return rem

            def capture(self, g):
                g.capture_begin()
                self.step()
                g.capture_end()

        def measure(graphs, state):
            graphs.release(state)
            state = None
            return state
        """}, rules=["T2"])
    assert found == []


# ---------------------------------------------------------------------------
# T3 host-sync budget (shared fixtures with R3)
# ---------------------------------------------------------------------------
_SYNC_SHARED = {
    "hot path np.asarray": {"runtime/hot.py": """\
        import numpy as np

        class E:
            def sched_step(self, x):
                return np.asarray(x)
        """},
    "cold function and benchmark": {
        "runtime/cold.py": """\
            import numpy as np

            class E:
                def snapshot(self, x):
                    return np.asarray(x)
            """,
        "benchmarks/bench_decode.py": """\
            import time

            def run(f, x):
                t0 = time.time()
                f(x)
                return time.time() - t0
            """},
    "wall clock": {"mod.py": """\
        import time

        def measure(f):
            t0 = time.time()
            f()
            return time.time() - t0
        """},
    "host list in a hot path": {"runtime/hot.py": """\
        import numpy as np

        def boundary(req):
            return np.asarray([1, 2], np.int32), np.asarray(req.tokens)
        """},
}


@pytest.mark.parametrize("case", sorted(_SYNC_SHARED))
def test_t3_reports_what_r3_reports(tmp_path, case):
    _write(tmp_path, _SYNC_SHARED[case])
    t = lint_paths([tmp_path], rules=["T3"])
    r = r_lint_paths([tmp_path], rules=["R3"])
    assert _where(t) == _where(r)
    assert {f.rule for f in t} <= {"T3"} and {f.rule for f in r} <= {"R3"}
    assert (case == "cold function and benchmark") == (t == [])


def test_t3_flags_torch_syncs_in_hot_paths_only(tmp_path):
    found = _lint(tmp_path, {"runtime/eng.py": """\
        import torch

        class E:
            def generate(self, x):
                n = x.sum().item()
                if torch.any(x > n):
                    torch.cuda.synchronize()
                return x.cpu()

            def report(self, x):
                return x.sum().item()
        """}, rules=["T3"])
    assert _where(found) == [("runtime/eng.py", 5), ("runtime/eng.py", 6),
                             ("runtime/eng.py", 7), ("runtime/eng.py", 8)]


# ---------------------------------------------------------------------------
# T4 lock + thread discipline (shared fixtures with R4)
# ---------------------------------------------------------------------------
_LOCK_SHARED = {
    "off-lock read": {"mod.py": """\
        import threading

        class C:
            def __init__(self):
                self._lock = threading.Lock()
                self.count = 0

            def bump(self):
                with self._lock:
                    self.count += 1

            def peek(self):
                return self.count
        """},
    "locked read": {"mod.py": """\
        import threading

        class C:
            def __init__(self):
                self._lock = threading.Lock()
                self.count = 0

            def bump(self):
                with self._lock:
                    self.count += 1

            def peek(self):
                with self._lock:
                    return self.count
        """},
    "scheduler off the worker": {"mod.py": """\
        import threading

        class Srv:
            def __init__(self, scheduler):
                self.scheduler = scheduler
                self._thread = None

            def start(self):
                self._thread = threading.Thread(target=self._run)
                self._thread.start()

            def _run(self):
                self.scheduler.boundary()

            def peek(self):
                return self.scheduler.load
        """},
    "router reaching through a replica": {
        "server.py": """\
            import threading

            class Srv:
                def __init__(self, scheduler):
                    self.scheduler = scheduler

                def start(self):
                    threading.Thread(target=self._run).start()

                def _run(self):
                    self.scheduler.boundary()
            """,
        "router.py": """\
            from server import Srv

            class Router:
                def audit(self, srv):
                    return srv.scheduler.pending
            """},
}


@pytest.mark.parametrize("case", sorted(_LOCK_SHARED))
def test_t4_reports_what_r4_reports(tmp_path, case):
    _write(tmp_path, _LOCK_SHARED[case])
    t = lint_paths([tmp_path], rules=["T4"])
    r = r_lint_paths([tmp_path], rules=["R4"])
    assert _where(t) == _where(r)
    assert (case == "locked read") == (t == [])


# ---------------------------------------------------------------------------
# T5 walker completeness
# ---------------------------------------------------------------------------
_T5_CLASSES = """\
    import dataclasses
    from typing import Optional

    import torch

    @dataclasses.dataclass
    class KV:
        k: torch.Tensor
        pos: torch.Tensor
        window: int = 0

    @dataclasses.dataclass
    class Rec:
        ssm: torch.Tensor
        conv: Optional[torch.Tensor] = None
    """


def test_t5_flags_a_table_or_construction_missing_a_field(tmp_path):
    found = _lint(tmp_path, {"state.py": _T5_CLASSES, "graphs.py": """\
        from state import KV, Rec

        _SMALL = {KV: ("pos",)}
        _REC = ("ssm",)

        def rebuild(kv, t):
            return KV(k=t["k"], pos=t["pos"]), Rec(**{f: t[f] for f in _REC})
        """}, rules=["T5"])
    msgs = " | ".join(f.message for f in found)
    assert _where(found) == [("graphs.py", 3), ("graphs.py", 7),
                             ("graphs.py", 7)], msgs
    assert "tensor field `k` of `KV`" in msgs
    assert "`KV(...)` in a walker module leaves field `window`" in msgs
    assert "`Rec(...)` in a walker module leaves field `conv`" in msgs


def test_t5_near_miss_complete_walker(tmp_path):
    found = _lint(tmp_path, {"state.py": _T5_CLASSES, "graphs.py": """\
        from state import KV, Rec

        _SMALL = {KV: ("pos",)}
        _BIG = {KV: ("k",)}
        _REC = ("ssm", "conv")

        def rebuild(kv, t):
            return (KV(k=t["k"], pos=t["pos"], window=kv.window),
                    Rec(**{f: t[f] for f in _REC}))
        """}, rules=["T5"])
    assert found == []


def test_t5_flags_unwalked_dataclass_and_list_field(tmp_path):
    found = _lint(tmp_path, {"state.py": _T5_CLASSES + """\

    @dataclasses.dataclass
    class Extra:
        rows: list

    @dataclasses.dataclass
    class Loose:
        x: torch.Tensor
    """, "graphs.py": """\
        from state import KV, Extra

        _SMALL = {KV: ("pos", "k")}

        def fresh():
            return Extra(rows=[])
        """, "eng.py": """\
        import functools
        from state import Loose

        def step(model, x):
            return Loose(x=x)

        G = ChunkGraphs(functools.partial(step, None))
        """}, rules=["T5"])
    msgs = " | ".join(f.message for f in found)
    assert "builds `Loose` inside a captured step" in msgs
    assert "field `rows` of `Extra` is a `list`" in msgs


# ---------------------------------------------------------------------------
# T6 slot protocol (shared fixtures with R6)
# ---------------------------------------------------------------------------
_PROTO_SCHED = """\
    def drive(eng):
        eng.sched_step()
        eng.sched_reset()
        if hasattr(eng, "sched_abort"):
            eng.sched_abort(0)
    """
_PROTO_SHARED = {
    "partial engine": """\
        class ToyEngine:
            def sched_step(self):
                return 0
        """,
    "full engine without the optional slot": """\
        class ToyEngine:
            def sched_step(self):
                return 0

            def sched_reset(self):
                return 0
        """,
    "protocol lagging the scheduler": """\
        from typing import Protocol

        class SchedulableEngine(Protocol):
            def sched_step(self):
                ...
        """,
}


@pytest.mark.parametrize("case", sorted(_PROTO_SHARED))
def test_t6_reports_what_r6_reports(tmp_path, case):
    """Each package's scheduler module by its own name: the reference's
    ``runtime/scheduler.py``, the port's ``runtime/continuous.py``."""
    _write(tmp_path / "r", {"runtime/scheduler.py": _PROTO_SCHED,
                            "runtime/engine.py": _PROTO_SHARED[case]})
    _write(tmp_path / "t", {"runtime/continuous.py": _PROTO_SCHED,
                            "runtime/engine.py": _PROTO_SHARED[case]})
    t = lint_paths([tmp_path / "t"], rules=["T6"])
    r = r_lint_paths([tmp_path / "r"], rules=["R6"])
    assert _where(t) == _where(r)
    assert (case.startswith("full")) == (t == [])
    if case == "partial engine":
        assert "sched_reset" in t[0].message.split("optional")[0]
        assert "sched_abort" not in t[0].message.split("optional")[0]


def test_port_engines_conform_to_protocol():
    from repro_torch.runtime.engine import (BatchEngine, DecodeEngine,
                                            SchedulableEngine,
                                            SpeculativeEngine)
    for cls in (DecodeEngine, BatchEngine, SpeculativeEngine):
        missing = [m for m in dir(SchedulableEngine)
                   if m.startswith("sched_") and not hasattr(cls, m)]
        assert missing == [], (cls.__name__, missing)


# ---------------------------------------------------------------------------
# T7 capture hygiene
# ---------------------------------------------------------------------------
def test_t7_flags_graphs_built_hot_and_keys_holding_objects(tmp_path):
    found = _lint(tmp_path, {"state.py": """\
        import dataclasses
        import torch

        @dataclasses.dataclass
        class St:
            cur_token: torch.Tensor
            width: int
        """, "eng.py": """\
        import torch

        class E:
            def generate(self, x):
                graphs = ChunkGraphs(self.step)
                return graphs.run(x)

            def warm(self, xs):
                for x in xs:
                    torch.compile(self.step)(x)

            @staticmethod
            def key(strategy, state, done, kernel, mode="inline"):
                return (mode, strategy.draft, done, state.cur_token,
                        lambda: 0, {"k": kernel})
        """}, rules=["T7"])
    assert _where(found) == [("eng.py", 5), ("eng.py", 10), ("eng.py", 14),
                             ("eng.py", 14), ("eng.py", 15),
                             ("eng.py", 15)]


def test_t7_near_miss_built_once_and_host_key(tmp_path):
    found = _lint(tmp_path, {"eng.py": """\
        import torch

        class E:
            def __init__(self):
                self.graphs = ChunkGraphs(self.step)
                self.plans = Plans(self.make)

            def generate(self, x):
                return self.graphs.run(x)

            @staticmethod
            def key(strategy, state, done, kernel: str, mode="inline"):
                return (mode, strategy.draft, kernel, tuple(done.shape),
                        tuple(state.cur_token.shape), state.width)
        """}, rules=["T7"])
    assert found == []


# ---------------------------------------------------------------------------
# T8 wrapper vs plain signatures (the launch bounds:
# tests/test_torch_launchbounds.py)
# ---------------------------------------------------------------------------
_T8_PLAIN = """\
    def tree_attention_plain(q, ck, cv, mask):
        return q

    def orphan_plain(q):
        return q
    """


def test_t8_flags_signature_skew_and_orphan_plain(tmp_path):
    found = _lint(tmp_path, {"kernels/plain.py": _T8_PLAIN,
                             "kernels/verify.py": """\
        from kernels.launch import Counted
        from kernels.plain import tree_attention_plain

        @Counted
        def verify_attention(q, cv, ck, mask):
            if q.device.type == "cpu":
                return tree_attention_plain(q, cv, ck, mask)
            raise ValueError

        @Counted
        def lonely(q):
            raise ValueError
        """}, rules=["T8"])
    msgs = " | ".join(f.message for f in found)
    assert _where(found) == [("kernels/plain.py", 4), ("kernels/verify.py", 5),
                             ("kernels/verify.py", 11)], msgs
    assert "its plain version `tree_attention_plain`" in msgs
    assert "`lonely` runs no plain version" in msgs
    assert "`orphan_plain` belongs to no kernel wrapper" in msgs


def test_t8_near_miss_matching_signatures(tmp_path):
    found = _lint(tmp_path, {"kernels/plain.py": _T8_PLAIN.split(
        "\n\n    def orphan")[0] + "\n", "kernels/verify.py": """\
        from kernels.launch import Counted
        from kernels.plain import tree_attention_plain

        @Counted
        def verify_attention(q, ck, cv, mask):
            if q.device.type == "cpu":
                return tree_attention_plain(q, ck, cv, mask)
            raise ValueError
        """}, rules=["T8"])
    assert found == []


# ---------------------------------------------------------------------------
# T9 boundary protocol
# ---------------------------------------------------------------------------
_T9_SCHED = """\
    class ContinuousScheduler:
        def submit(self, req):
            self._pending.append(req)

        def abort(self, req_id):
            self._aborts[req_id] = 1

        def boundary(self):
            {boundary}
            return req

        def fail_all(self):
            {fail}
            self._aborts = {{}}
    """


def test_t9_flags_admit_before_sweep_and_undrained_fail_all(tmp_path):
    found = _lint(tmp_path, {"runtime/continuous.py": _T9_SCHED.format(
        boundary="req = self.policy.pick(self._pending)\n"
                 "            self._apply_aborts()",
        fail="pass")}, rules=["T9"])
    msgs = " | ".join(f.message for f in found)
    assert "BEFORE the abort sweep" in msgs
    assert "does not drain self._pending" in msgs
    assert len(found) == 2         # the exploration itself is clean


def test_t9_near_miss_correct_protocol_order(tmp_path):
    found = _lint(tmp_path, {"runtime/continuous.py": _T9_SCHED.format(
        boundary="self._apply_aborts()\n"
                 "            req = self.policy.pick(self._pending)",
        fail="self._pending = []")}, rules=["T9"])
    assert found == []


# ---------------------------------------------------------------------------
# suppressions, baseline, CLI
# ---------------------------------------------------------------------------
def test_torchlint_markers_silence_t_rules_only(tmp_path):
    files = {"mod.py": """\
        import time

        def measure(f):
            t0 = time.time()  # torchlint: disable=T3 (absolute timestamp)
            # torchlint: disable=T3 (line-above form)
            t1 = time.time()
            t2 = time.time()  # reprolint: disable=R3 (absolute timestamp)
            f()
            return t1 - t0 + t2
        """}
    _write(tmp_path, files)
    t = lint_paths([tmp_path], rules=["T3"])
    r = r_lint_paths([tmp_path], rules=["R3"])
    # each linter honours only its own marker
    assert _where(t) == [("mod.py", 7)]
    assert _where(r) == [("mod.py", 4), ("mod.py", 6)]
    _write(tmp_path / "f", {"mod.py": """\
        # torchlint: disable-file=T3
        import time

        def measure(f):
            return time.time()
        """})
    assert lint_paths([tmp_path / "f"], rules=["T3"]) == []


def test_baseline_roundtrip_and_cli_exit_codes(tmp_path, capsys):
    bad = tmp_path / "mod.py"
    bad.write_text("import time\n\n\ndef f():\n    return time.time()\n")
    baseline = tmp_path / "baseline.txt"
    args = [str(tmp_path), "--rules", "T3", "--baseline", str(baseline)]
    assert tlint.main(args) == 1
    assert "mod.py:5 T3" in capsys.readouterr().out
    assert tlint.main(args + ["--write-baseline"]) == 0
    assert tlint.main(args) == 0
    keys = load_baseline(baseline)
    assert len(keys) == 1 and next(iter(keys)).startswith("mod.py::T3::")
    bad.write_text("import time\n\n\ndef f():\n    return 0\n")
    assert tlint.main(args) == 0                  # a stale entry is fine
    assert tlint.main(args[:1] + ["--rules", "T3", "--no-baseline",
                                  "--format", "github"]) == 0
    bad.write_text("import time\n\n\ndef f():\n    return time.time()\n")
    assert tlint.main(args[:1] + ["--rules", "T3", "--no-baseline",
                                  "--format", "github"]) == 1
    out = capsys.readouterr().out
    assert "::error file=mod.py,line=5,title=torchlint T3::T3: " in out
    assert tlint.main(["--list-rules"]) == 0
    listed = capsys.readouterr().out
    assert all(f"T{i}  " in listed for i in range(1, 10))
    with pytest.raises(SystemExit):
        tlint.main(["--rules", "T3"])             # no paths


def test_finding_key_is_line_number_free():
    f = Finding(path="a.py", line=7, rule="T1", message="m")
    assert f.key == "a.py::T1::m" and "7" not in f.key


def test_port_tree_is_clean_with_an_empty_baseline(capsys):
    """The gate: every finding in src/repro_torch is fixed or carries a
    reasoned ``# torchlint: disable=Tn`` marker; the baseline is empty."""
    findings = lint_paths([SRC / "repro_torch"])
    assert findings == [], "\n".join(f.render() for f in findings)
    assert load_baseline(SRC / "repro_torch/analysis/baseline.txt") == set()
    assert tlint.main([str(SRC / "repro_torch")]) == 0
    assert "torchlint: clean" in capsys.readouterr().out
