"""The correctness check: a sound run passes, the control fails, and a
run with the timed path broken underneath fails, once for each fault
the cells can have (a step that leaves its state unchanged, half of a
block's channels left out, an answer altered where it is produced).
The card's machine runs the control at each cell's own size:
    python -m pytest --noconftest -m gpu btbench/tests -q
"""
import dataclasses

import pytest
import torch

from btbench.harness import spec as specs
from btbench.harness.check import verdict
from btbench.harness.control import control_numbers
from btbench.harness.main import run_cell
from gr_bluetooth_tpu_torch.io.ingest import PipelinedIngest
from gr_bluetooth_tpu_torch.models import frontend, sniffer
from small_cell import add_live_cell, add_survey_cell, small_copy, spec


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return small_copy(tmp_path_factory.mktemp("small"))


def _run(root, seed=21, seconds=0.6):
    return run_cell(spec(root, "band8.maxrate"), seed, seconds, False,
                    device="cpu")[0]


def test_a_sound_run_is_correct(root):
    out, report = run_cell(spec(root, "band8.maxrate"), 21, 0.6, False,
                           device="cpu")
    assert out["correct"], out["check"]
    assert out["failed"] == 0 and out["attempted"] >= 1
    assert list(out)[-1] == "check"
    # each compared number beside its limit, last on standard error
    assert report[-len(out["check"]):] == [
        f"check {n} {c['value']!r} limit {c['limit']!r}"
        for n, c in out["check"].items()]


def test_a_step_that_leaves_its_state_unchanged_fails(root, monkeypatch):
    def frozen(self, carry, new):
        _, outs = self.step(carry, new)
        packed, self._specs = self._pack(outs)
        return packed                      # the carry is never written

    monkeypatch.setattr(PipelinedIngest, "_graph_fn", frozen)
    out = _run(root)
    assert not out["correct"] and out["check"]["hit_mismatch"]["value"] > 0


def test_half_of_the_channels_left_out_fails(root, monkeypatch):
    orig = frontend.FrontEnd.assemble_block

    def half(self, *a, **k):
        res = orig(self, *a, **k)
        res.hits = [h for h in res.hits if h.chan_idx % 2 == 0]
        return res

    monkeypatch.setattr(frontend.FrontEnd, "assemble_block", half)
    out = _run(root)
    assert not out["correct"] and out["check"]["hit_mismatch"]["value"] > 0


def test_a_hit_altered_where_it_is_produced_fails(root, monkeypatch):
    orig = frontend.FrontEnd.assemble_block

    def altered(self, *a, **k):
        res = orig(self, *a, **k)
        if res.hits:
            res.hits[0] = dataclasses.replace(res.hits[0],
                                              lap=res.hits[0].lap ^ 1)
        return res

    monkeypatch.setattr(frontend.FrontEnd, "assemble_block", altered)
    out = _run(root)
    assert not out["correct"] and out["check"]["hit_mismatch"]["value"] > 0


def test_a_packet_altered_where_it_is_decoded_fails(root, monkeypatch):
    orig = sniffer._apply_batch_row

    def altered(pkt, row):
        ok = orig(pkt, row)
        if pkt.payload is not None:
            pkt.payload = pkt.payload.copy()
            pkt.payload[-1] ^= 1
        return ok

    monkeypatch.setattr(sniffer, "_apply_batch_row", altered)
    out = _run(root)
    assert not out["correct"]
    assert out["check"]["mode_mismatch"]["value"] > 0
    assert out["check"]["hit_mismatch"]["value"] == 0


def test_a_live_run_is_checked_block_for_block(tmp_path):
    root = small_copy(tmp_path)
    add_live_cell(root)
    out, _ = run_cell(spec(root, "band8.live"), 17, 0.3, False,
                      device="cpu")
    assert out["correct"], out["check"]
    assert out["attempted"] == 7                  # 0.3 s of 40 ms blocks
    assert out["metrics"]["result_latency_p95_ms"]["value"] > 5 * 40


def test_the_sharded_survey_is_checked_hit_for_hit(tmp_path, monkeypatch):
    root = small_copy(tmp_path)
    add_survey_cell(root)
    sp = spec(root, "band8.survey_4card")
    out, _ = run_cell(sp, 13, 0.5, True, device="cpu")
    assert out["correct"], out["check"]
    assert out["metrics"]["sharded.ms_per_superblock"]["value"] > 0
    orig = frontend.FrontEnd.assemble_block

    def half(self, *a, **k):
        res = orig(self, *a, **k)
        res.hits = res.hits[: len(res.hits) // 2]
        return res

    monkeypatch.setattr(frontend.FrontEnd, "assemble_block", half)
    out, _ = run_cell(sp, 13, 0.5, False, device="cpu")
    assert not out["correct"]
    assert out["check"]["hit_mismatch"]["value"] > 0


def test_the_control_fails_at_a_small_size(root):
    sp = spec(root, "band8.maxrate")
    for seed in (3, 4, 5):
        n = control_numbers(sp, seed, device="cpu")
        n.update(mode_mismatch=0, unfinished=0)
        ok, _ = verdict(n, sp.limits)
        assert not ok and n["snr_gap_db"] > sp.limits["snr_gap_db"]


@pytest.mark.gpu
@pytest.mark.parametrize("workload", ["fullband.maxrate", "fullband.live",
                                      "band8.maxrate"])
def test_the_control_fails_at_the_cells_size_on_the_card(workload):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    sp = specs.load_spec(workload)
    for seed in (2 ** 33 + 1, 2 ** 33 + 2, 2 ** 33 + 3):
        n = control_numbers(sp, seed, device="cuda")
        n.update(mode_mismatch=0, unfinished=0)
        ok, _ = verdict(n, sp.limits)
        assert not ok, (seed, n)
