"""The card's roofs and the analytic traffic model of one GFL round
(mirrors ``repro/launch/roofline.py``, for one NVIDIA H100 SXM).

Rates are NVIDIA's H100 SXM data sheet figures at the full 700 W power
limit (dense, no sparsity).  A card set below that limit runs slower under
load, so every time measured against these roofs is reported beside the
card's ``nvidia-smi`` name and power limit.

Left out of the port: ``shape_bytes``, ``parse_collectives`` and
``parse_collectives_scaled``, which read XLA's HLO text; torch has no HLO,
so there is nothing for them to parse.
"""
from __future__ import annotations

import json
from dataclasses import asdict, dataclass

HBM_BYTES_PER_S = 3.35e12        # HBM3, 80 GB (data sheet)
F32_OPS_PER_S = 67e12            # fp32 outside the tensor cores, FMA = 2
BF16_OPS_PER_S = 989e12          # bf16 tensor cores, dense
L2_BYTES = 50 * 2 ** 20          # L2 cache (data sheet: 50 MB)
SM_COUNT = 132
FP32_LANES_PER_SM = 128          # Hopper white paper
INT32_LANES_PER_SM = 64          # Hopper white paper
#: the SM clock the fp32 peak implies: 67e12 / (2 * 128 * 132) = 1.98 GHz
SM_CLOCK_HZ = F32_OPS_PER_S / (2 * FP32_LANES_PER_SM * SM_COUNT)
#: INT32 instructions a second, 64 lanes x 132 SMs x 1.98 GHz = 16.7e12.
#: Derived from the white paper's lane count and the clock above, not a
#: published peak.  Integer and conversion instructions are both counted
#: against it; conversions issue at a quarter of this rate (CUDA
#: programming guide, compute capability 9.0), so a bound that counts them
#: here is a lower bound.
INT32_OPS_PER_S = INT32_LANES_PER_SM * SM_COUNT * SM_CLOCK_HZ


def kernel_bound_ms(nbytes: float, flops: float = 0.0,
                    int_ops: float = 0.0) -> tuple[float, str]:
    """Least time one kernel call could take on the card, in ms, and what
    bounds it: the larger of ``nbytes`` over the HBM rate and the
    operations over their units' rates (``flops`` on the fp32 lanes,
    ``int_ops`` on the INT32 lanes).  Returns (ms, "bytes"|"operations")."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = max(flops / F32_OPS_PER_S, int_ops / INT32_OPS_PER_S)
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


@dataclass
class Roofline:
    """One card's roofline of a step: ``flops`` and ``hbm_bytes`` are
    counted by the caller from the step's shapes (there is no compiled
    program to ask), ``model_flops`` from :func:`model_flops_estimate`."""
    arch: str
    shape: str
    flops: float
    hbm_bytes: float
    model_flops: float
    compute_s: float = 0.0
    memory_s: float = 0.0
    bottleneck: str = ""
    useful_flop_frac: float = 0.0

    def finalize(self) -> "Roofline":
        self.compute_s = self.flops / BF16_OPS_PER_S
        self.memory_s = self.hbm_bytes / HBM_BYTES_PER_S
        self.bottleneck = ("compute" if self.compute_s >= self.memory_s
                           else "memory")
        self.useful_flop_frac = (self.model_flops / self.flops
                                 if self.flops else 0.0)
        return self

    def to_json(self) -> str:
        return json.dumps(asdict(self), indent=1)


def round_pipeline_traffic(P: int, L: int, D: int, *, itemsize: int = 4,
                           mode: str = "mask", fused: bool = True) -> dict:
    """Analytic HBM bytes of one GFL round's client fold + combine.

    Counts reads/writes of every materialized tensor in the chain over the
    ``[P, L, D]`` gradients.  ``mode`` is the mechanism's client level:
    "none" | "mask" (secure-agg, generated in registers when fused) |
    "laplace" (iid noise, pre-drawn and streamed once when fused).

    Reference chain (each op re-reads its operand from HBM): norms,
    scale+update, noise materialize+add (noised modes), fold, combine.
    Fused pipeline (K1 ``fold_norms``, K2 ``fold_apply``, K3
    ``graph_combine``): a norms pass, one scale/noise/fold pass, and the
    fused combine — in "laplace" mode the pre-drawn noise operand costs
    one extra HBM write + read (counted on BOTH sides; "mask" noise is
    generated in the kernel and costs nothing).

    ``pld_passes`` counts the gradient-scale ([P, L, D]) HBM round trips:
    8 for the reference chain, 2 fused ("none"/"mask"), 4 fused
    ("laplace", incl. the noise write+read).
    """
    PLD = P * L * D * itemsize
    PD = P * D * itemsize
    if fused:
        terms = {
            "norms_pass_read": PLD,
            "fold_pass_read": PLD + PD,                    # grads + base w
            "noise_materialize": PLD if mode == "laplace" else 0,
            "noise_stream": PLD if mode == "laplace" else 0,
            "psi_write": PD,
            "combine": 3 * PD if mode == "none" else 4 * PD,
        }
        passes = {"none": 2, "mask": 2, "laplace": 4}[mode]
    else:
        noised = mode != "none"
        terms = {
            "norms_pass_read": PLD,
            "update_read_write": 2 * PLD + PD,
            "noise_materialize": PLD if noised else 0,
            "noise_add": 3 * PLD if noised else 0,
            "fold_read": PLD,
            "psi_write": PD,
            "combine": 3 * PD if mode == "none" else 4 * PD,
        }
        passes = 8 if noised else 4
    terms["total"] = sum(terms.values())
    terms["pld_passes"] = passes
    return terms


def model_flops_estimate(n_params: int, n_active_params: int, tokens: int,
                         kind: str) -> float:
    """6*N*D for training, 2*N*D for inference forward (per step)."""
    n = n_active_params or n_params
    mult = 6.0 if kind == "train" else 2.0
    return mult * n * tokens


def active_params(cfg, n_params: int) -> int:
    """Active (per-token) params for MoE archs; == n_params for dense."""
    if cfg.moe is None:
        return n_params
    m = cfg.moe
    dff = m.expert_d_ff or cfg.d_ff
    per_expert = 3 * cfg.d_model * dff
    routed_total = m.num_experts * per_expert * (
        cfg.num_layers - m.first_dense_layers)
    routed_active = m.top_k * per_expert * (
        cfg.num_layers - m.first_dense_layers)
    return n_params - routed_total + routed_active
