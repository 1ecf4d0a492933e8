"""gflint rule registry for the port: the reference's rule ids, GFL001,
GFL003, GFL004 and GFL006 rewritten for torch."""
from __future__ import annotations

from repro_torch.analysis.rules.accounting import AccountantCoverageRule
from repro_torch.analysis.rules.bench import BenchWriteRoutingRule
from repro_torch.analysis.rules.callbacks import GraphSideEffectRule
from repro_torch.analysis.rules.keys import GeneratorHygieneRule
from repro_torch.analysis.rules.net import NetRoutingRule
from repro_torch.analysis.rules.parity import LaunchParityRule
from repro_torch.analysis.rules.specs import SpecRoundTripRule
from repro_torch.analysis.rules.tracing import GraphSyncRule

ALL_RULES = (GeneratorHygieneRule, AccountantCoverageRule, GraphSyncRule,
             LaunchParityRule, SpecRoundTripRule, GraphSideEffectRule,
             BenchWriteRoutingRule, NetRoutingRule)


def default_rules():
    return [cls() for cls in ALL_RULES]


def rule_by_id(rule_id: str):
    for cls in ALL_RULES:
        if cls.id == rule_id:
            return cls
    raise KeyError(rule_id)
