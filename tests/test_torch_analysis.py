"""gflint for the port (``repro_torch.analysis``), all on the CPU.

Each rule fires on a seeded violation, stays quiet on the fixed version
and yields to a pragma; the baseline and CLI behave as the reference's;
on shared fixtures the rules the port keeps (GFL002, GFL005, GFL007,
GFL008) and the framework's pragma, baseline and GFL000 handling give
exactly the reference analyzer's findings (rule, path, line, column,
context, message); and the committed ``analysis/baseline_torch.json``
reproduces on ``src/repro_torch`` with nothing new and nothing stale.
"""
import ast
import json
import sys
import textwrap
from pathlib import Path

import pytest

from repro.analysis import run_analysis as ref_run_analysis
from repro.analysis.baseline import save_baseline as ref_save_baseline
from repro.analysis.rules import rule_by_id as ref_rule_by_id
from repro_torch.analysis import ALL_RULES, run_analysis, rule_by_id
from repro_torch.analysis.baseline import (diff_against_baseline,
                                           load_baseline, save_baseline)
from repro_torch.analysis.cli import main as cli_main
from repro_torch.analysis.framework import (AnalysisContext,
                                            collect_modules, is_port_test)
from repro_torch.analysis.rules._graph import graph_scope

REPO_ROOT = Path(__file__).resolve().parents[1]
PORT = REPO_ROOT / "src" / "repro_torch"
BASELINE = REPO_ROOT / "analysis" / "baseline_torch.json"


def write_tree(tmp_path, source, filename="mod.py", extra=None):
    for name, text in {filename: source, **(extra or {})}.items():
        p = tmp_path / name
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(textwrap.dedent(text))


def lint(tmp_path, source, filename="mod.py", extra=None, rule=None):
    """Write fixture module(s) and run the port's gflint over the tree
    (every rule, or only ``rule``)."""
    write_tree(tmp_path, source, filename, extra)
    rules = None if rule is None else [rule_by_id(rule)()]
    return run_analysis([tmp_path], root=tmp_path, rules=rules)


def fired(findings, rule):
    return [f for f in findings if f.rule == rule]


# --------------------------------------------------------------- GFL001
GFL001_FIRES = {
    "global_randn": """
        import torch

        def noise(n):
            return torch.randn(n)
    """,
    "global_inplace": """
        def init(w):
            w.normal_(0.0, 0.02)
    """,
    "global_from_import": """
        from torch import randint as ri

        def pick(n):
            return ri(0, n, (3,))
    """,
    "literal_torch_seed": """
        import torch

        torch.manual_seed(0)
    """,
    "literal_generator_seed": """
        import torch

        def make():
            g = torch.Generator()
            g.manual_seed(1234)
            return g
    """,
    "unseeded_generator": """
        import torch

        def draw(n):
            g = torch.Generator()
            return torch.rand(n, generator=g)
    """,
    "unseeded_inline": """
        import torch

        def build(cfg, Model):
            return Model.init(cfg, torch.Generator())
    """,
    "reseed_same_seed": """
        import torch

        def two_draws(g, seed, n):
            g.manual_seed(seed)
            a = torch.rand(n, generator=g)
            g.manual_seed(seed)
            b = torch.rand(n, generator=g)
            return a, b
    """,
    "reseed_in_loop": """
        import torch

        def per_round(g, seed, n):
            out = []
            for _ in range(3):
                g.manual_seed(seed)
                out.append(torch.randn(n, generator=g))
            return out
    """,
    "loop_invariant_stream_seeds": """
        def stage(gens, seed):
            for stream, gen in gens.items():
                gen.manual_seed(seed)
    """,
    "reseed_inline_and_branch": """
        import torch

        def draws(g, s, n, flag):
            a = torch.rand(n, generator=g.manual_seed(s))
            if flag:
                b = torch.rand(n, generator=g.manual_seed(s))
            else:
                b = None
            return a, b
    """,
}

GFL001_QUIET = {
    "explicit_generators": """
        import torch

        def noise(n, g):
            a = torch.randn(n, generator=g)
            b = torch.empty(n).uniform_(-0.5, 0.5, generator=g)
            return a + b
    """,
    "seeded_generator": """
        import torch

        def draw(n, seed):
            g = torch.Generator()
            g.manual_seed(seed)
            return torch.rand(n, generator=g)
    """,
    "reseed_per_round": """
        import torch

        def per_round(g, seed, n):
            out = []
            for i in range(3):
                g.manual_seed(seed + i)
                out.append(torch.randn(n, generator=g))
            return out
    """,
    "reseed_after_rebinding": """
        import torch

        def two_draws(g, seed, n):
            g.manual_seed(seed)
            a = torch.rand(n, generator=g)
            seed = seed + 1
            g.manual_seed(seed)
            return a, torch.rand(n, generator=g)
    """,
    "reseed_from_fresh_source": """
        import torch

        def two_draws(g, seeds, n):
            g.manual_seed(next(seeds))
            a = torch.rand(n, generator=g)
            g.manual_seed(next(seeds))
            return a, torch.rand(n, generator=g)
    """,
    "per_stream_seeds": """
        def stage(gens, step, round_seed):
            for stream, gen in gens.items():
                gen.manual_seed(round_seed(step, stream))
            for gen in gens.values():
                s = hash((step, id(gen)))
                gen.manual_seed(s)
    """,
    "reseed_without_second_draw": """
        import torch

        def stage(g, seed, n):
            g.manual_seed(seed)
            a = torch.rand(n, generator=g)
            g.manual_seed(seed)     # put back for a graph replay
            return a
    """,
}


@pytest.mark.parametrize("case", sorted(GFL001_FIRES))
def test_gfl001_fires(tmp_path, case):
    hits = fired(lint(tmp_path, GFL001_FIRES[case], rule="GFL001"),
                 "GFL001")
    assert hits, case
    if case.startswith("reseed"):
        assert all("repeats the earlier one" in f.message for f in hits)
        assert len(hits) == 1
    if case.startswith("loop"):
        assert ["loop-invariant seed `seed`" in f.message
                for f in hits] == [True]


@pytest.mark.parametrize("case", sorted(GFL001_QUIET))
def test_gfl001_quiet(tmp_path, case):
    assert not lint(tmp_path, GFL001_QUIET[case], rule="GFL001"), case


def test_gfl001_seed_factory_exempt_and_pragma(tmp_path):
    findings = lint(tmp_path, """
        import torch

        def rng(seed=None):
            g = torch.Generator()
            g.manual_seed(0 if seed is None else seed)
            g.manual_seed(7)
            return g
    """, filename="src/repro_torch/__init__.py", extra={
        "src/repro_torch/other.py": """
            import torch

            def jitter(n):
                return torch.rand(n)  # a dither  # gflint: disable=GFL001
        """}, rule="GFL001")
    assert not findings, findings


# --------------------------------------------------------------- GFL003
STEP = """
    import torch

    class StagedStep:
        def stage(self, i, draws):
            return bool(self.flag.item())          # host code: not flagged

        def body(self, batch, draws, i: int, combine: bool):
            {line}
"""

GFL003_BODY_FIRES = {
    "item": "return self.params.sum().item()",
    "tolist": "return self.params.tolist()",
    "cpu": "return self.params.cpu()",
    "numpy": "return self.params.numpy()",
    "to_cpu": "return self.params.to('cpu')",
    "synchronize": "torch.cuda.synchronize()",
    "equal": "return torch.equal(self.params, self.params)",
    "nonzero": "return torch.nonzero(self.params)",
    "where_one_arg": "return torch.where(self.params > 0)",
    "cast_of_tensor": "x = torch.ones(3)\n            return float(x.sum())",
    "if_on_tensor": "x = torch.ones(3)\n            if x.sum() > 0:\n"
                    "                return x",
    "assert_on_tensor": "x = torch.zeros(3)\n"
                        "            assert torch.isfinite(x).all()",
    "ternary_on_tensor": "x = torch.zeros(3)\n"
                         "            return x if x.any() else None",
    "mask_index": "x = torch.zeros(3)\n            return x[x > 0]",
    "mask_name": "x = torch.zeros(3)\n            keep = ~torch.isnan(x)\n"
                 "            return x[keep]",
    "tensor_only_method": "new = self.mech.combine(self.params)\n"
                          "            if new.isnan().any():\n"
                          "                raise RuntimeError('nan')",
    # a round constant copied from the host (core/privacy/noise.py's
    # f32_scalar until the analyzer's first run on the card)
    "host_to_device": "return torch.tensor(0.5, dtype=torch.float32, "
                      "device=self.params.device)",
    "host_as_tensor": "return torch.as_tensor(i, device='cuda')",
}

GFL003_BODY_QUIET = {
    "device_ops": "x = torch.ones(3)\n            return torch.where(x > 0, "
                  "x, 0.0).sum()",
    "structural_reads": "x = torch.ones(3)\n"
                        "            if x.shape[0] > 1 and x.dim() == 1 and "
                        "len(x) and x is not None:\n"
                        "                return int(x.size(0))",
    "host_flags": "if combine and i % 2:\n                return None",
    "host_scalars": "n = float(i)\n            return torch.full((3,), n)",
    "mask_store": "x = torch.zeros(3)\n            x[x > 0] = 0.0",
    "device_fill": "return torch.full((), 0.5, dtype=torch.float32, "
                   "device=self.params.device)",
    "cpu_constant": "return torch.tensor(0.5, dtype=torch.float32)",
    "device_as_tensor": "x = torch.ones(3)\n"
                        "            return torch.as_tensor(x, device='cuda')",
}


@pytest.mark.parametrize("case", sorted(GFL003_BODY_FIRES))
def test_gfl003_fires_in_step_body(tmp_path, case):
    src = STEP.format(line=GFL003_BODY_FIRES[case])
    hits = fired(lint(tmp_path, src, rule="GFL003"), "GFL003")
    assert len(hits) == 1, (case, hits)
    assert hits[0].context == "StagedStep.body"
    assert "host sync in CUDA-graph scope" in hits[0].message


@pytest.mark.parametrize("case", sorted(GFL003_BODY_QUIET))
def test_gfl003_quiet_in_step_body(tmp_path, case):
    src = STEP.format(line=GFL003_BODY_QUIET[case])
    assert not lint(tmp_path, src, rule="GFL003"), case


GFL003_SCOPES = {
    # a subclass's body, and what it calls through one definition
    "subclass_and_callee": ("""
        import torch
        from gfl import StagedStep

        def helper(x: torch.Tensor):
            return x.max().item()

        class Weighted(StagedStep):
            def body(self, batch, draws, i, combine):
                return helper(self.params)
    """, {"gfl.py": "class StagedStep:\n    pass\n"}, "helper"),
    # a function called inside a capture block
    "capture_block": ("""
        import torch

        def step(x: torch.Tensor):
            return x[x > 0]

        def run(graph, x):
            with torch.cuda.graph(graph):
                step(x)
    """, {}, "step"),
    # make_graphed_callables
    "graphed_callables": ("""
        import torch

        def fwd(x: torch.Tensor):
            if x.mean() > 0:
                return x
            return -x

        def wrap(x):
            return torch.cuda.make_graphed_callables(fwd, (x,))
    """, {}, "fwd"),
    # a capture of a parameter: its call sites' lambda, then the closure
    "captured_parameter": ("""
        import torch

        def _capture(fn, graph):
            with torch.cuda.graph(graph):
                fn()

        def _replay(body, graph):
            _capture(lambda: body(0), graph)

        def run_rounds(graph, buf):
            def body(i):
                buf.add_(1)
                torch.cuda.synchronize()
            _replay(body, graph)
    """, {}, "run_rounds.body"),
    # a capture in the test corpus reaches a method by its one definition
    "test_capture": ("""
        class Model:
            def decode_step(self, tok):
                return self._logits(tok)

            def _logits(self, tok):
                return tok.cpu()
    """, {"tests/test_torch_decode.py": """
        import torch

        def test_graph(model, tok):
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                model.decode_step(tok)
    """}, "Model._logits"),
}


@pytest.mark.parametrize("case", sorted(GFL003_SCOPES))
def test_gfl003_graph_scope_reaches(tmp_path, case):
    src, extra, context = GFL003_SCOPES[case]
    hits = fired(lint(tmp_path, src, extra=extra, rule="GFL003"), "GFL003")
    assert [f.context for f in hits] == [context], hits


def test_gfl003_quiet_outside_scope_ambiguous_and_expected_failures(
        tmp_path):
    findings = lint(tmp_path, """
        import torch

        def host_report(x):
            return x.sum().item()              # no graph reaches it

        class StagedStep:
            def body(self, batch, draws, i, combine):
                return self.mech.combine(self.params)  # two definitions
    """, extra={
        "mech_a.py": "class A:\n    def combine(self, x):\n"
                     "        return x.cpu()\n",
        "mech_b.py": "class B:\n    def combine(self, x):\n"
                     "        return x.tolist()\n",
        "tests/test_torch_emit.py": """
            import pytest
            import torch
            from mod import host_report

            def test_raises(graph, x):
                with pytest.raises(RuntimeError):
                    with torch.cuda.graph(graph):
                        host_report(x)
        """}, rule="GFL003")
    assert not findings, findings


def test_gfl003_pragma_suppresses(tmp_path):
    src = STEP.format(
        line="return self.params.cpu()  # debug  # gflint: disable=GFL003")
    assert not lint(tmp_path, src, rule="GFL003")


# --------------------------------------------------------------- GFL004
BUILD = """
    SOURCES = ("alpha", "beta")
    AUX = {"alpha_occupancy": ("alpha", "occ", [])}

    def function(name, defines=()):
        return None
"""

LAUNCH = """
    import torch
    from kernels import _build
    from kernels.ref import alpha_plain

    def alpha(x: torch.Tensor):
        if x.device.type != "cuda":
            return alpha_plain(x)
        held = _build.function("alpha_occupancy")(4)
        fn = _build.function("alpha")
        fn(x.data_ptr(), held)
        return x

    def beta(x: torch.Tensor):
        {beta_body}
"""

PARITY_TEST = """
    from kernels.launch import alpha, alpha_plain, beta, beta_plain

    def test_alpha():
        alpha(1), alpha_plain(1)

    def test_beta():
        beta(1), beta_plain(1)
"""


def _gfl004(tmp_path, beta_body, tests=PARITY_TEST):
    extra = {"kernels/_build.py": BUILD,
             "kernels/ref.py": "def alpha_plain(x):\n    return x\n"}
    if tests is not None:
        extra["tests/test_torch_launch.py"] = tests
    return fired(lint(tmp_path, LAUNCH.format(beta_body=beta_body),
                      filename="kernels/launch.py", extra=extra,
                      rule="GFL004"), "GFL004")


BETA_OK = ("from kernels.ref import beta_plain\n"
           "        if x.device.type != 'cuda':\n"
           "            return beta_plain(x)\n"
           "        return _build.launch_all(_build.function('beta'), x)")


def test_gfl004_quiet_with_twin_and_parity_test(tmp_path):
    assert not _gfl004(tmp_path, BETA_OK)


@pytest.mark.parametrize("case,body,tests,needle", [
    ("no_twin", "_build.function('beta')(x.data_ptr())", PARITY_TEST,
     "no plain counterpart"),
    ("no_test", BETA_OK, PARITY_TEST.replace("beta_plain", "other"),
     "no parity test naming it and its counterpart (beta_plain)"),
    ("no_launch_of_a_source", "return x", PARITY_TEST,
     "kernel source 'beta' in _build.SOURCES is never launched"),
    ("unknown_source", BETA_OK.replace("'beta'", "'gamma'"), PARITY_TEST,
     "_build.function('gamma') names no source"),
])
def test_gfl004_fires(tmp_path, case, body, tests, needle):
    hits = _gfl004(tmp_path, body, tests)
    assert any(needle in f.message for f in hits), (case, hits)


def test_gfl004_loads_and_host_queries_are_not_launches(tmp_path):
    # a worker that only loads every library, and an occupancy query
    hits = _gfl004(tmp_path, BETA_OK + """

    def load_kernels(names):
        for name in names:
            _build.function(name)

    def occupancy(bits):
        return _build.function("alpha_occupancy")(bits, 8)
    """)
    assert not hits, hits


def test_gfl004_pragma_and_reference_tests_are_no_evidence(tmp_path):
    # a reference test naming beta and its twin is not evidence for the port
    write_tree(tmp_path, PARITY_TEST, "tests/test_launch.py")
    hits = _gfl004(tmp_path, BETA_OK, PARITY_TEST.replace("beta", "other"))
    assert len(hits) == 1 and "'beta'" in hits[0].message
    src = LAUNCH.format(beta_body=BETA_OK).replace(
        "def beta(x: torch.Tensor):",
        "def beta(x: torch.Tensor):  # bench only  # gflint: disable=GFL004")
    (tmp_path / "kernels" / "launch.py").write_text(textwrap.dedent(src))
    assert not fired(run_analysis([tmp_path], root=tmp_path), "GFL004")


# --------------------------------------------------------------- GFL006
GFL006_FIRES = {
    "emit": "from telemetry.stream import emit\n"
            "            emit('step', {'msd': self.params.sum()})",
    "print": "print('round', i)",
    "open": "open('log.txt', 'a').write('x')",
    "logging": "import logging\n            logging.info('round %d', i)",
    "json_dump": "import json\n            json.dump({'i': i}, self.fh)",
}


@pytest.mark.parametrize("case", sorted(GFL006_FIRES))
def test_gfl006_fires_in_step_body(tmp_path, case):
    src = STEP.format(line=GFL006_FIRES[case])
    hits = fired(lint(tmp_path, src, rule="GFL006"), "GFL006")
    assert len(hits) == 1 and hits[0].context == "StagedStep.body", hits
    assert ("raises under capture" if case == "emit"
            else "never on replay") in hits[0].message


def test_gfl006_quiet_on_taps_notes_host_code_and_telemetry(tmp_path):
    findings = lint(tmp_path, STEP.format(
        line="self.tap.tap(self.counter, {'msd': self.params.sum()})\n"
             "            from telemetry.stream import note\n"
             "            note('kernel', {'op': 'fold'})\n"
             "            log_round(i)") + """
    def host_report(i):
        print('done', i)
    """, extra={"telemetry/stream.py": """
        def note(stream, values):
            pass
    """, "mod2.py": """
        from telemetry import sinks

        def log_round(i):
            sinks.write(i)
    """, "telemetry/sinks.py": """
        def write(i):
            print(i)           # the routing point: exempt
    """}, rule="GFL006")
    assert not findings, findings


def test_gfl006_pragma_suppresses(tmp_path):
    src = STEP.format(line="print(i)  # capture-time trace  "
                           "# gflint: disable=GFL006")
    assert not lint(tmp_path, src, rule="GFL006")


# ------------------------------------- shared rules: parity with the reference
UNCHARGED = """
    def release_round(updates, key, mech):
        return mech.client_protect(updates, key, None)

    def caller(updates, key, mech):
        return release_round(updates, key, mech)

    def kernel_round(w, g, ops):
        return ops.round_fold(w, g, mu=0.1)
"""

SHARED = {
    "GFL002": [
        (UNCHARGED, {}),
        (UNCHARGED + """
    def engine(updates, key, mech, acc):
        out = caller(updates, key, mech)
        out = kernel_round(out, key, mech)
        acc.advance(1)
        return out
""", {}),
        ("""
    def engine(flushed, q, mech, acc):
        psi = mech.client_protect_masked(1.0, 2.0, None, None)
        noise = mech.combine_noise_tree(psi)
        acc.record_schedule(flushed, q)
        return psi, noise

    def masks(L, D):
        return pairwise_masks_vec(L, D, 0.3)  # gflint: disable=GFL002

    def dropout(u, alive):
        return masked_client_mean_dropout_vec(u, alive, 0.3)
""", {}),
    ],
    "GFL005": [
        ("""
    def parse_widget_spec(spec):
        return spec.split(":")
""", {}),
        ("""
    def parse_widget_spec(spec):
        return spec.split(":")

    def widget_to_spec(parts):
        return ":".join(parts)
""", {"registry.py": """
    from mod import parse_widget_spec, widget_to_spec

    def register_grammar(name, parse, to_spec):
        return (name, parse, to_spec)

    register_grammar("widget", parse_widget_spec, widget_to_spec)
""", "tests/test_torch_specs.py": """
    def test_round_trips(all_grammars):
        pass
"""}),
        ("""
    def parse_widget_spec(spec):
        return spec.split(":")

    def parse_gadget_spec(spec):  # gflint: disable=GFL005
        return spec

    def register_grammar(name, parse, to_spec):
        return (name, parse, to_spec)

    register_grammar("widget", parse_widget_spec, str)
""", {}),
    ],
    "GFL007": [
        ("""
    import json
    from pathlib import Path

    OUT = Path(".") / "BENCH_speed.json"
    ALIAS = OUT

    def save(payload):
        ALIAS.write_text(json.dumps(payload))

    def save2(payload):
        with open("BENCH_other.jsonl", "a") as fh:
            json.dump(payload, fh)

    def fine(payload):
        Path("notes.json").write_text(json.dumps(payload))
        return json.loads(Path("BENCH_speed.json").read_text())

    def reviewed(payload):
        # one-off debug dump  # gflint: disable=GFL007
        Path("BENCH_debug.json").write_text(json.dumps(payload))
""", {"benchmarks/meta.py": """
    def write_bench(path, payload):
        with open("BENCH_history.jsonl", "a") as fh:
            fh.write(payload)
"""}),
    ],
    "GFL008": [
        ("""
    import os
    import socket
    import subprocess as sp
    from subprocess import run
    import subprocess  # runs nvcc  # gflint: disable=GFL008

    def shell(cmd):
        return sp.run(cmd)
""", {"src/repro_torch/core/fleet/transport.py": """
    import socket
    import subprocess
"""}),
    ],
}


def _both(tmp_path, source, extra, rule_ids):
    write_tree(tmp_path, source, extra=extra)
    port = run_analysis([tmp_path], root=tmp_path,
                        rules=[rule_by_id(r)() for r in rule_ids])
    ref = ref_run_analysis([tmp_path], root=tmp_path,
                           rules=[ref_rule_by_id(r)() for r in rule_ids])
    return [f.to_dict() for f in port], [f.to_dict() for f in ref]


@pytest.mark.parametrize("rule,case", [
    (rule, i) for rule in sorted(SHARED) for i in range(len(SHARED[rule]))])
def test_shared_rules_match_the_reference(tmp_path, rule, case):
    source, extra = SHARED[rule][case]
    port, ref = _both(tmp_path, source, extra, [rule])
    assert port == ref


def test_shared_rules_fire_and_yield_to_pragmas(tmp_path):
    """The shared fixtures hold a firing, a quiet and a suppressed case of
    each rule (so the parity above compares something)."""
    counts = {}
    for rule, cases in SHARED.items():
        for i, (source, extra) in enumerate(cases):
            sub = tmp_path / f"{rule}_{i}"
            port, _ = _both(sub, source, extra, [rule])
            counts[(rule, i)] = len(port)
    assert counts == {("GFL002", 0): 2, ("GFL002", 1): 0, ("GFL002", 2): 1,
                      ("GFL005", 0): 1, ("GFL005", 1): 0, ("GFL005", 2): 1,
                      ("GFL007", 0): 2, ("GFL008", 0): 3}


def test_framework_matches_the_reference(tmp_path):
    """Pragmas (line, line above, disable-file), the baseline file and
    GFL000 on a parse error: the same through both analyzers."""
    shared = ["GFL002", "GFL007", "GFL008"]
    port, ref = _both(tmp_path, """
        # gflint: disable-file=GFL007
        import socket
        import subprocess  # gflint: disable=GFL008
        # reviewed  # gflint: disable=GFL002
        X = mech.client_protect(1, 2, 3)
        Y = mech.iid_noise_combine(1)
        open("BENCH_x.json", "w").write("{}")
    """, {"broken.py": "def broken(:\n",
          "tests/test_torch_broken.py": "def test(:\n"}, shared)
    assert port == ref
    assert {f["rule"] for f in port} == {"GFL000", "GFL002", "GFL008"}
    # the baseline each writes is the same file
    from repro.analysis.framework import Finding as RefFinding
    from repro_torch.analysis.framework import Finding
    save_baseline(tmp_path / "port.json", [Finding(**f) for f in port])
    ref_save_baseline(tmp_path / "ref.json", [RefFinding(**f) for f in ref])
    assert (tmp_path / "port.json").read_text() == \
        (tmp_path / "ref.json").read_text()


# ---------------------------------------------------------- baseline / CLI
def test_baseline_roundtrip_and_diff(tmp_path):
    findings = lint(tmp_path, GFL001_FIRES["global_randn"])
    assert findings
    bl = tmp_path / "baseline.json"
    save_baseline(bl, findings)
    loaded = load_baseline(bl)
    assert all(e["justification"].startswith("TODO")
               for e in loaded.values())
    new, stale, matched = diff_against_baseline(findings, loaded)
    assert not new and not stale and len(matched) == len(findings)
    new, stale, matched = diff_against_baseline([], loaded)
    assert not new and len(stale) == len(findings)
    import dataclasses
    moved = [dataclasses.replace(f, line=f.line + 40) for f in findings]
    new, stale, matched = diff_against_baseline(moved, loaded)
    assert not new and not stale
    # justifications survive a rewrite
    key = findings[0].key()
    loaded[key]["justification"] = "a dither, not privacy noise"
    save_baseline(bl, findings, loaded)
    assert load_baseline(bl)[key]["justification"] == \
        "a dither, not privacy noise"


def test_cli_exit_codes_and_defaults(tmp_path, capsys):
    write_tree(tmp_path, GFL001_FIRES["global_randn"],
               "src/repro_torch/mod.py")
    root = ["--root", str(tmp_path)]
    assert cli_main(root) == 1                       # src/repro_torch
    assert cli_main(root + ["--baseline", str(tmp_path / "none.json")]) == 2
    assert cli_main(root + ["--write-baseline"]) == 0
    assert (tmp_path / "analysis" / "baseline_torch.json").is_file()
    assert cli_main(root) == 0                       # the default baseline
    (tmp_path / "src" / "repro_torch" / "mod.py").write_text("X = 1\n")
    assert cli_main(root) == 1                       # a stale entry
    assert cli_main(root + ["--no-baseline"]) == 0
    capsys.readouterr()
    assert cli_main(["--list-rules"]) == 0
    listed = capsys.readouterr().out.split()
    assert [r.id for r in ALL_RULES] == [w for w in listed
                                         if w.startswith("GFL")]
    assert [r.id for r in ALL_RULES] == [f"GFL00{i}" for i in range(1, 9)]


def test_cli_json_format(tmp_path, capsys):
    (tmp_path / "mod.py").write_text("import torch\nK = torch.randn(3)\n")
    code = cli_main([str(tmp_path), "--root", str(tmp_path),
                     "--no-baseline", "--format", "json"])
    out = json.loads(capsys.readouterr().out)
    assert code == 1 and out["stale"] == [] and out["baselined"] == 0
    assert [f["rule"] for f in out["new"]] == ["GFL001"]


def test_parse_error_reported_not_crashing(tmp_path):
    findings = lint(tmp_path, "def broken(:\n")
    assert [f.rule for f in findings] == ["GFL000"]
    assert findings[0].message.startswith("syntax error")


def test_evidence_corpus_is_the_ports_tests():
    assert is_port_test("tests/test_torch_cuda.py")
    assert not is_port_test("tests/test_analysis.py")


# ------------------------------------------------------------ self-check
def test_committed_baseline_exactly_reproduced():
    """gflint over src/repro_torch matches analysis/baseline_torch.json:
    nothing new, nothing stale, every entry justified."""
    findings = run_analysis([PORT], root=REPO_ROOT)
    baseline = load_baseline(BASELINE)
    new, stale, matched = diff_against_baseline(findings, baseline)
    assert not new, [f.render() for f in new]
    assert not stale, stale
    assert baseline
    for entry in baseline.values():
        assert entry["justification"].strip() and \
            "TODO" not in entry["justification"]


def test_graph_scope_holds_the_round_bodies():
    """The four round bodies, run_rounds' closure, what the card tests
    capture and what those call are in GFL003's scope; stage() is not."""
    sources, tests, _ = collect_modules([PORT], REPO_ROOT)
    _, more, _ = collect_modules([REPO_ROOT / "tests"], REPO_ROOT)
    ctx = AnalysisContext(sources, [m for m in more if is_port_test(m.path)],
                          REPO_ROOT)
    scope = {(m.path.split("src/repro_torch/")[-1],
              (m.context_of(fn) + "." if m.context_of(fn) else "") + fn.name)
             for m, fn in graph_scope(ctx).functions()}
    want = {("core/gfl.py", "StagedStep.body"),
            ("core/population/engine.py", "StagedWeightedStep.body"),
            ("core/events/engine.py", "StagedEventTick.body"),
            ("core/resilience/runtime.py", "StagedResilientStep.body"),
            ("core/population/graphed.py", "run_rounds.body"),
            ("kernels/ops.py", "round_fold"),
            ("kernels/swa_decode.py", "swa_decode"),
            ("kernels/clip_accum.py", "clip_accum"),
            ("models/model.py", "Model.decode_step"),
            ("models/moe.py", "moe_forward"),
            ("core/gfl.py", "_client_updates")}
    assert want <= scope, want - scope
    assert not {name for _, name in scope if name.endswith(".stage")}


ANALYSIS = PORT / "analysis"


@pytest.mark.parametrize("path", sorted(ANALYSIS.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(ANALYSIS)))
def test_analyzer_is_stdlib_only(path):
    """No torch, jax or reference import: the analyzer runs anywhere."""
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        mods = ([a.name for a in node.names] if isinstance(node, ast.Import)
                else [node.module] if isinstance(node, ast.ImportFrom)
                and node.level == 0 else [])
        for mod in mods:
            top = mod.split(".")[0]
            assert top in sys.stdlib_module_names or \
                mod.startswith("repro_torch.analysis"), (path, mod)
