"""gflint for the port: AST-based privacy/repro invariant analysis of
``repro_torch``, with the reference analyzer's structure, rule ids,
pragma grammar and baseline format, and rules aimed at the port's torch
idioms (Generators, CUDA-graph bodies, ``_build.function`` launches).

Stdlib only: it imports neither ``torch`` nor ``jax`` nor ``repro``.
CLI: ``python -m repro_torch.analysis`` (scans ``src/repro_torch``
against ``analysis/baseline_torch.json``).
"""
from repro_torch.analysis.baseline import (diff_against_baseline,
                                           load_baseline, save_baseline)
from repro_torch.analysis.framework import (AnalysisContext, Finding,
                                            ModuleInfo, Rule, run_analysis)
from repro_torch.analysis.rules import ALL_RULES, default_rules, rule_by_id

__all__ = [
    "ALL_RULES", "AnalysisContext", "Finding", "ModuleInfo", "Rule",
    "default_rules", "diff_against_baseline", "load_baseline",
    "rule_by_id", "run_analysis", "save_baseline",
]
