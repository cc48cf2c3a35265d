"""The compiled steps (utils/graph.py) on the CPU against the JAX package.

On the CPU a CompiledStep runs its function at every call with the
bookkeeping that replay imposes on a card: arguments copied into its
static inputs, results into its static outputs, which the next call
rewrites.  These tests hold the paths that go through it to the JAX
package's jitted steps and to the port's eager bodies:

  * stream() (the ingest's compiled step: static carry and chunk,
    packed outputs copied into a ring of DEPTH + 2 host buffers) over
    more blocks than the pipeline holds, LE on: hits and LE hits equal
    the JAX FrontEnd.stream's (Pallas in interpret mode) and the eager
    ingest loop's exactly, slot SNR within 1e-3 dB of the JAX package's;
  * a slip mid-stream resets the static carry: slips, clock_slipped
    events and hits equal the JAX ingest's over a scripted overrun of
    two blocks' air;
  * graft_entry.entry(device="cpu") on planted noise equals the JAX
    __graft_entry__.entry() step's outputs;
  * two front ends of one configuration own separate buffers, and
    process_block's results do not alias the step's outputs.
"""
import numpy as np
import pytest
import torch

import __graft_entry__ as jgraft
import chip_smoke
from gr_bluetooth_tpu.io import ingest as jingest
from gr_bluetooth_tpu.models import frontend as jfrontend
from gr_bluetooth_tpu.utils.log import EventBus as JBus
from gr_bluetooth_tpu_torch import graft_entry
from gr_bluetooth_tpu_torch.io import ingest
from gr_bluetooth_tpu_torch.models.frontend import FrontEnd
from gr_bluetooth_tpu_torch.utils.graph import CompiledStep
from gr_bluetooth_tpu_torch.utils.log import EventBus
from torch_parity import one_torch_thread  # noqa: F401  (autouse)
from torch_parity import pallas_interpret

FS, CENTER = 8e6, 2426e6          # 2426 MHz: LE advertising channel 38


def _classic(results):
    return [[(h.channel, h.chan_idx, h.clkn, h.sym_offset, h.lap, h.errors)
             for h in r.hits] for r in results]


def _le(results):
    return [[(h.channel, h.index, h.clkn, h.sym_offset, h.distance)
             for h in r.le_hits] for r in results]


def _eager_stream(fe, planes, wire="f32"):
    """The ingest's eager body, block by block: PipelinedIngest.step on
    fresh tensors, each block's outputs assembled as they come."""
    ing = ingest.PipelinedIngest(fe, wire)
    carry, chunks = ingest.wire_chunks(planes, fe, wire, pad_tail=True)
    c = torch.from_numpy(carry)
    out, base = [], 0
    for chunk in chunks:
        c, outs = ing.step(c, torch.from_numpy(np.ascontiguousarray(chunk)))
        out.append(fe.assemble_block(
            *(None if o is None else o.numpy() for o in outs),
            slot_base=base))
        base += fe.block_slots
    return out


def _same_results(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.slot_base == b.slot_base
        assert a.hits == b.hits and a.le_hits == b.le_hits
        assert np.array_equal(a.snr_db, b.snr_db)
        assert np.array_equal(a.windows, b.windows)
        assert np.array_equal(a.le_windows, b.le_windows)


def test_stream_past_the_pipeline_depth_matches_jax_and_eager():
    """DEPTH + 3 blocks: the host ring (DEPTH + 2 slots) wraps and every
    block rewrites the step's static outputs; the results are the JAX
    stream's hits and the eager loop's blocks."""
    n_blocks = ingest.DEPTH + 3
    fe = FrontEnd(FS, CENTER, block_slots=8, max_ac_errors=1,
                  enable_le=True, device="cpu")
    x, planted, le_planted = chip_smoke.plant_le_capture(fe, n_blocks,
                                                         le_per_block=2)
    planes = np.stack([x.real, x.imag]).astype(np.float32)
    got = list(fe.stream(planes))
    ing = fe._ingests["f32"]
    assert ing._next == n_blocks > len(ing._ring) == ingest.DEPTH + 2
    assert ing._step.graph is None and ing._step.outputs[0].ndim == 1
    _same_results(got, _eager_stream(fe, planes))
    chip_smoke.check_survey([h for r in got for h in r.hits], planted)
    chip_smoke.check_le([h for r in got for h in r.le_hits], le_planted)

    fj = jfrontend.FrontEnd(FS, CENTER, block_slots=8, max_ac_errors=1,
                            enable_le=True, use_pallas=True)
    with pallas_interpret():
        ref = list(fj.stream(planes))
    assert len(got) == len(ref) == n_blocks
    assert _classic(got) == _classic(ref) and _le(got) == _le(ref)
    assert sum(map(len, _le(got))) >= n_blocks
    for a, b in zip(got, ref):
        np.testing.assert_allclose([h.snr_db for h in a.hits + a.le_hits],
                                   [h.snr_db for h in b.hits + b.le_hits],
                                   atol=1e-3, rtol=0)


def _overrun(fe):
    """tests/test_ingest.py's scripted overrun at this front end's block
    size: two chunks' air cut after chunk 5 and reported as dropped,
    as the wire chunks and the slip the live source would give."""
    x, _ = chip_smoke.plant_capture(fe, 12, seed=11)
    planes = np.stack([x.real, x.imag]).astype(np.float32)
    st, ov = fe.step_samples, fe.overlap_samples
    inter = ingest.wire_encode(planes, "i16")
    cut_lo, cut_hi = ov + 6 * st, ov + 8 * st
    kept = np.concatenate([inter[:cut_lo], inter[cut_hi:]], axis=0)
    carry = ingest.wire_decode_np(kept[:ov], "i16")
    chunks = [kept[ov + i * st: ov + (i + 1) * st]
              for i in range((kept.shape[0] - ov) // st)]
    slots = round((cut_hi - cut_lo) / fe.samples_per_slot)
    return carry, chunks, slots, cut_hi - cut_lo


def test_slip_resets_the_static_carry_as_jax_does():
    """A slip after chunk 5: the port's compiled ingest gives the JAX
    ingest's slot bases, clock_slipped events and hits (the first block
    after the slip starts from a zero carry on both), and the eager
    loop's blocks with its carry zeroed at the slip."""
    fe = FrontEnd(FS, CENTER, block_slots=8, max_ac_errors=1, device="cpu")
    carry, chunks, slots, dropped = _overrun(fe)
    slip_at = 6
    runs = {}
    for name, ing, bus in (
            ("jax", jingest.PipelinedIngest(
                jfrontend.FrontEnd(FS, CENTER, block_slots=8,
                                   max_ac_errors=1, use_pallas=True),
                "i16"), JBus()),
            ("port", ingest.PipelinedIngest(fe, "i16"), EventBus())):
        mark = jingest._Slip if name == "jax" else ingest._Slip
        items = chunks[:slip_at] + [mark(slots=slots, samples=dropped)] + \
            chunks[slip_at:]
        with pallas_interpret():
            runs[name] = (list(ing.run(iter(items), 40,
                                       initial_carry=carry, bus=bus)),
                          bus.events("clock_slipped"))
    (jres, jev), (tres, tev) = runs["jax"], runs["port"]
    assert tev == jev == [{"kind": "clock_slipped", "slots": slots,
                           "samples": dropped,
                           "clkn": 40 + slip_at * 8 + slots}]
    assert [r.slot_base for r in tres] == [r.slot_base for r in jres]
    assert _classic(tres) == _classic(jres)
    assert sum(map(len, _classic(tres)[slip_at:])) >= 3

    # the eager body with the carry zeroed at the slip
    ing = ingest.PipelinedIngest(fe, "i16")
    c = torch.from_numpy(carry)
    want, base = [], 40
    for i, chunk in enumerate(chunks):
        if i == slip_at:
            c, base = torch.zeros_like(c), base + slots
        c, outs = ing.step(c, torch.from_numpy(np.ascontiguousarray(chunk)))
        want.append(fe.assemble_block(
            *(None if o is None else o.numpy() for o in outs),
            slot_base=base))
        base += fe.block_slots
    _same_results(tres, want)


def test_entry_on_cpu_equals_the_jax_entry():
    """graft_entry.entry(device="cpu") and the JAX entry() (its jitted
    _device_step on flat planes) on the same planted block: equal hit
    counts, tables and windows, slot SNR within 1e-3 dB."""
    step, (x,) = graft_entry.entry(device="cpu")
    jstep, (jx,) = jgraft.entry()
    assert isinstance(step, CompiledStep) and step.graph is None
    assert x.shape == jx.shape and not x.any()
    fe = FrontEnd(16e6, 2441e6, block_slots=16, device="cpu")
    xp, _ = chip_smoke.plant_capture(fe, 1, seed=12)
    planes = np.stack([xp.real, xp.imag]).astype(np.float32)[
        :, : x.shape[1]]
    for block in (x.numpy(), planes):
        got = [None if o is None else o.numpy().copy()
               for o in step(torch.from_numpy(block))]
        ref = [None if o is None else np.asarray(o) for o in jstep(block)]
        np.testing.assert_allclose(got[0], ref[0], atol=1e-3, rtol=0)
        assert int(got[1]) == int(ref[1])
        assert np.array_equal(got[2], ref[2])
        assert np.array_equal(got[3], ref[3])
        assert got[4:] == [None] * 3 and ref[4:] == [None] * 3
    assert int(got[1]) >= 10


def test_front_ends_own_their_buffers():
    """Two front ends of one configuration: separate compiled steps and
    static buffers; one's calls leave the other's outputs as they were;
    process_block's results are copies, not the step's outputs."""
    a = FrontEnd(4e6, 2441e6, block_slots=8, device="cpu")
    b = FrontEnd(4e6, 2441e6, block_slots=8, device="cpu")
    x, _ = chip_smoke.plant_capture(a, 2, seed=13)
    planes = np.stack([x.real, x.imag]).astype(np.float32)
    b1 = planes[:, : a.block_samples]
    b2 = planes[:, a.step_samples: a.step_samples + a.block_samples]
    sa, sb = a.compiled_step("fused"), b.compiled_step("fused")
    assert sa is not sb and a.compiled_step("fused") is sa
    ptrs = lambda s: {t.data_ptr() for t in s.inputs + s.outputs  # noqa
                      if t is not None}
    oa = sa(torch.from_numpy(b1))
    keep = [o.clone() for o in oa[:4]]
    sb(torch.from_numpy(b2))
    assert not ptrs(sa) & ptrs(sb)
    for o, k in zip(oa[:4], keep):
        assert torch.equal(o, k)
    want = [o.clone() for o in a.fused_step(b1)[:4]]
    for o, w in zip(keep, want):
        assert torch.equal(o, w)
    # the same step again: its outputs are rewritten in place
    assert sa(torch.from_numpy(b2))[2].data_ptr() == oa[2].data_ptr()

    r1 = a.process_block(b1, 0)
    r2 = a.process_block(b2, 8)
    flat = a.compiled_step("flat")
    for r in (r1, r2):
        assert not np.shares_memory(r.windows, flat.outputs[3].numpy())
    assert r1.hits != r2.hits
    assert r1.hits == b.process_block(b1, 0).hits


def test_an_ingest_runs_one_stream_at_a_time():
    """The ingest's carry is its compiled step's static input: a second
    run iterated while the first is open raises, and once the first is
    closed a new run starts from its own carry and gives the first
    run's blocks."""
    fe = FrontEnd(4e6, 2441e6, block_slots=8, device="cpu")
    x, _ = chip_smoke.plant_capture(fe, 3, seed=14)
    planes = np.stack([x.real, x.imag]).astype(np.float32)
    whole = list(fe.stream(planes))
    first = fe.stream(planes)
    next(first)
    with pytest.raises(RuntimeError, match="one stream at a time"):
        next(fe.stream(planes))
    first.close()
    _same_results(list(fe.stream(planes)), whole)
