"""K1's work from the cell's shapes and the k1_roofline reader."""
import re
from types import SimpleNamespace

import pytest

from btbench.harness import costs
from btbench.harness.spec import kernel_patterns, load_reader
from btbench.reference.frontend import RefFrontEnd


def test_k1_work_at_full_band():
    ref = RefFrontEnd(80e6, 2441e6, squelch_db=10.0, block_slots=64,
                      max_ac_errors=6, enable_le=True, device="cpu")
    w = costs.k1_work(ref)
    # x: 2 planes of the block's 3,200,000 new samples and its overlap
    N = 3_200_000 + 5 * 50_000 + (533 - 1) + 4 * 40
    assert ref.block_samples == N
    C, M, Q, T = 80, 80, 7, 201
    n_sym = (64 + 5) * 625
    n = N // 40 - 2 * Q            # true channel frames
    n_data = -(-n // 1024)         # demod groups of 1024 frames: 85
    n_k = (69 * 1250 - 240) // 40 + 1          # probe points of 69 slots
    F = -(-(n_data * 1024 + 2) // 50) * 50     # frames pfb_snr computes
    assert (n_data, n_k, F) == (85, 2151, 87050)
    n_bytes = 4 * (2 * N + C * -(-n_sym // 32) + C * F // 50 + C * n_k)
    assert w["bytes"] == n_bytes
    ops = F * (4 * M * Q + min(8 * C * M, 5 * M * 6.321928094887363)
               + 4 * C)
    ops += C * (min(F, n_data * 1024 + 2) * 32 + n_data * 512 * 84 +
                n_k * T * 8)
    assert w["ops"] == pytest.approx(ops, rel=1e-12)
    assert w["bound_s"] == pytest.approx(max(n_bytes / 3.35e12,
                                             ops / 67e12))
    assert w["bound_by"] == "operations"


def test_k1_roofline_reads_the_k1_kernels_only():
    t = dict(op_s={"void pfb_snr_kernel<5>(SnrSrc)": 0.09,
                   "demod_pack_kernel(Args)": 0.06,
                   "le_detect_kernel(int)": 0.5,
                   "Memcpy HtoD (Pinned -> Device)": 3.0},
             busy_s=1.0, window_s=4.0)
    w = SimpleNamespace(done=[0.0] * 1000)
    run = SimpleNamespace(trace=t, window=w, k1=dict(bound_s=18e-6),
                          kernel_patterns=kernel_patterns)
    share = load_reader("k1_roofline")(run)
    assert share == pytest.approx(100 * 18e-6 * 1000 / 0.15)
    assert load_reader("step.device_ms_per_block")(run) == \
        pytest.approx((0.09 + 0.06 + 0.5) / 1000 * 1e3)
    assert load_reader("device.idle_pct")(run) == pytest.approx(75.0)
    # no K1 kernel in the trace: no reading, never a 0
    t["op_s"] = {"Memcpy HtoD (Pinned -> Device)": 3.0}
    assert load_reader("k1_roofline")(run) is None
    assert load_reader("k1_roofline")(SimpleNamespace(
        trace=None, window=w, k1={}, kernel_patterns=kernel_patterns)) \
        is None
    assert all(isinstance(p, re.Pattern) for p in kernel_patterns("k1"))
