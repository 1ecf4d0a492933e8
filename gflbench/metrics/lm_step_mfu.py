"""Model FLOPs of the window's rounds (6 N a token and PaLM's attention
term, :func:`gflbench.counts.lm_flops_per_token`) over the window, as a
share of the fp32 peak."""
from gflbench import counts, peaks


def read(run):
    tokens, seq = run.window.get("tokens"), run.workload.get("seq")
    if tokens is None or seq is None:
        return None
    c = run.config
    per_token = counts.lm_flops_per_token(
        c["parameters"], c["num_hidden_layers"], c["hidden_size"], seq)
    return (100.0 * tokens * per_token
            / run.window["seconds"] / peaks.F32_FLOPS_PER_S)
