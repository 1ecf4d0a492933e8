"""The port's kernel-bench entry point on the CPU, reduced: the rows mirror
``benchmarks/kernel_bench.py`` (its ``fused_pallas`` realization is the
port's ``fused_kernels``; ``fused_ref`` and the rows about it have no
counterpart), every value is finite, and the analytic byte ratios equal
the reference's."""
import math

import pytest

from repro.launch.roofline import round_pipeline_traffic as ref_traffic
from repro_torch.launch import kernel_bench as kb

# benchmarks/kernel_bench.py's row names (micro_rows, round_rows)
REF_MICRO = ["kernel/graph_combine_us", "oracle/graph_combine_us",
             "kernel/secure_agg_us", "kernel/laplace_us", "oracle/laplace_us",
             "kernel/clip_accum_us", "oracle/clip_accum_us"]
REF_ROUND = ["unfused_chain_us", "fused_ref_us", "fused_pallas_us",
             "hbm_ratio", "roundtrip_ratio", "speedup", "achieved_gbps_ref",
             "achieved_gbps_pallas", "roofline_frac_ref",
             "roofline_frac_pallas"]


def _port_name(name):
    return name.replace("pallas", "kernels")


def test_micro_rows_mirror_reference():
    rows = kb.micro_rows(reduced=True, device="cpu")
    assert [n for n, _ in rows] == REF_MICRO
    assert all(math.isfinite(v) and v > 0 for _, v in rows)


def test_round_rows_mirror_reference():
    rows, report = kb.round_rows(reduced=True, device="cpu")
    want = [f"round/{mode}/{_port_name(n)}" for mode in ("mask", "laplace")
            for n in REF_ROUND if not n.endswith("_ref")
            and not n.endswith("_ref_us")]
    assert [n for n, _ in rows] == want
    assert all(math.isfinite(v) for _, v in rows)
    vals = dict(rows)
    P, L, _ = kb.ROUND_SHAPE
    for rec in report:
        mode, D = rec["mode"], rec["D"]
        assert D == kb.REDUCED_D
        ref_b = ref_traffic(P, L, D, mode=mode, fused=False)
        fus_b = ref_traffic(P, L, D, mode=mode, fused=True)
        assert vals[f"round/{mode}/hbm_ratio"] == \
            fus_b["total"] / ref_b["total"]
        assert vals[f"round/{mode}/roundtrip_ratio"] == \
            fus_b["pld_passes"] / ref_b["pld_passes"]
    # PR 5's analytic ratios
    assert vals["round/mask/hbm_ratio"] == pytest.approx(0.314, abs=1e-3)
    assert vals["round/laplace/hbm_ratio"] == pytest.approx(0.543, abs=1e-3)


def test_round_rows_take_any_width():
    rows, report = kb.round_rows(device="cpu", D=300)
    assert [r["D"] for r in report] == [300, 300]
    assert all(math.isfinite(v) for _, v in rows)


def test_main_prints_csv_rows(capsys):
    out = kb.main(["--reduced", "--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0] == "# device: cpu" and out["device"] == "cpu"
    names = [ln.split(",")[0] for ln in lines[1:]]
    assert names == [n for n, _ in out["micro"] + out["round"]]


def test_time_ms_on_cpu():
    calls = []
    ms = kb.time_ms(lambda: calls.append(1), device="cpu", budget_s=0.01,
                    max_reps=5)
    assert ms >= 0 and len(calls) == 2 + 5
