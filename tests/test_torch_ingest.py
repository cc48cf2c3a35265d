"""When the port's pipelined ingest (io/ingest.py) hands a block out, and
the thread that pulls its source.

  * a source that yields block j + 1 only once block j's result is out
    (a live source waiting for the air, paced by the consumer here) gets
    every result before it sends the next chunk, and the results are the
    synchronous loop's (fe.stream_sync); every block counts in
    ingest.early_release;
  * a _Slip pulled on the source thread moves slot_base and restarts the
    carry as before: the blocks after it equal a fresh run's from that
    chunk;
  * an exception of the source reaches the consumer after the blocks
    before it;
  * closing the run stops and joins the source thread, which closes the
    source; the ingest then runs a second stream;
  * a source that stays ahead is handed back to the loop, and one that
    falls behind is taken onto a thread again, with the same blocks;
  * the same blocks, in order, under a very short thread switch interval.
"""
import itertools
import sys
import threading
import time

import numpy as np
import pytest
import torch

import chip_smoke
from gr_bluetooth_tpu_torch.io import ingest
from gr_bluetooth_tpu_torch.models.frontend import FrontEnd
from gr_bluetooth_tpu_torch.utils.metrics import metrics
from torch_parity import one_torch_thread  # noqa: F401  (autouse)

FS, CENTER = 8e6, 2426e6          # 2426 MHz: LE advertising channel 38
N_BLOCKS = ingest.DEPTH + 3       # past the ring of DEPTH + 2 slots


@pytest.fixture(scope="module")
def stream():
    """A front end with LE on, a planted capture of N_BLOCKS blocks, its
    wire chunks (f32, the last block zero-padded, as stream() cuts it)
    and the synchronous loop's results."""
    fe = FrontEnd(FS, CENTER, block_slots=8, max_ac_errors=1,
                  enable_le=True, device="cpu")
    x, _, _ = chip_smoke.plant_le_capture(fe, N_BLOCKS, le_per_block=2)
    planes = np.stack([x.real, x.imag]).astype(np.float32)
    carry, chunks = ingest.wire_chunks(planes, fe, "f32", pad_tail=True)
    return fe, x, carry, list(chunks), list(fe.stream_sync(planes))


def _keys(results):
    return [(r.slot_base,
             [(h.channel, h.clkn, h.sym_offset, h.lap, h.errors)
              for h in r.hits],
             [(h.channel, h.index, h.clkn, h.sym_offset, h.distance)
              for h in r.le_hits],
             r.snr_db.tobytes()) for r in results]


def _eager(fe, carry, chunks):
    """The ingest's eager body chunk by chunk (PipelinedIngest.step on
    fresh tensors, each block assembled as it comes), with no feed."""
    ing = ingest.PipelinedIngest(fe, "f32")
    c = torch.from_numpy(carry)
    out = []
    for j, chunk in enumerate(chunks):
        c, outs = ing.step(c, torch.from_numpy(np.ascontiguousarray(chunk)))
        out.append(fe.assemble_block(
            *(None if o is None else o.numpy() for o in outs),
            slot_base=j * fe.block_slots))
    return out


def _source_threads():
    return [t for t in threading.enumerate() if t.name == "ingest-source"]


def _no_source_thread_within(seconds):
    stop = time.monotonic() + seconds
    while _source_threads() and time.monotonic() < stop:
        time.sleep(0.01)
    return not _source_threads()


def test_each_result_out_before_the_next_chunk(stream):
    """The consumer gets block j before the source gives chunk j + 1,
    as a live source gives it only when the air has carried it: a loop
    that held results for later chunks would wait here for ever, and
    fails after 10 s instead."""
    fe, x, carry, chunks, sync = stream
    received = threading.Event()

    def paced():
        for j, chunk in enumerate(chunks):
            if j:
                assert received.wait(10), \
                    f"block {j - 1}'s result held until a later chunk"
                received.clear()
            yield chunk

    metrics.reset()
    got = []
    for res in ingest.PipelinedIngest(fe, "f32").run(paced(), 0,
                                                     initial_carry=carry):
        got.append(res)
        received.set()
    assert [r.slot_base for r in got] == [r.slot_base for r in sync] == \
        [j * fe.block_slots for j in range(N_BLOCKS)]
    chip_smoke.compare_chains(fe, sync, got, x.shape[0])
    assert metrics.counters["blocks"] == N_BLOCKS
    assert metrics.counters["ingest.early_release"] == N_BLOCKS
    metrics.reset()


def test_slip_on_the_source_thread_moves_the_clock_and_restarts_carry(
        stream, monkeypatch):
    """A _Slip among paced chunks: the clock advances by its slots, the
    static carry is set to zeros on the consumer's thread at the slip
    (and at the start), and the blocks after it are a fresh run's from
    the chunk after the slip, started at the slipped clock."""
    fe, _, carry, chunks, _ = stream
    k, slots = 3, 5
    pipe = ingest.PipelinedIngest(fe, "f32")
    set_carry = pipe._set_carry
    calls = []

    def spy(host=None):
        calls.append((threading.current_thread() is
                      threading.main_thread(), host is None))
        set_carry(host)

    monkeypatch.setattr(pipe, "_set_carry", spy)
    items = chunks[:k] + [ingest._Slip(slots, slots * fe.samples_per_slot)] \
        + chunks[k:]
    got = list(pipe.run(iter(items), 10, initial_carry=carry))
    bs = fe.block_slots
    assert [r.slot_base for r in got] == \
        [10 + j * bs for j in range(k)] + \
        [10 + j * bs + slots for j in range(k, N_BLOCKS)]
    assert calls == [(True, False), (True, True)]
    fresh = list(ingest.PipelinedIngest(fe, "f32").run(
        iter(chunks[k:]), 10 + k * bs + slots))
    assert _keys(got[k:]) == _keys(fresh)


def test_source_exception_after_the_blocks_before_it(stream):
    """The source raises on its k-th chunk: the consumer gets blocks
    0..k-1, then the exception; the thread is gone."""
    fe, _, carry, chunks, sync = stream
    k = 4

    class Broken(Exception):
        pass

    def source():
        yield from chunks[:k]
        raise Broken("the radio went away")

    got = []
    with pytest.raises(Broken, match="went away"):
        for res in ingest.PipelinedIngest(fe, "f32").run(
                source(), 0, initial_carry=carry):
            got.append(res)
    assert len(got) == k
    assert _keys(got) == _keys(
        list(ingest.PipelinedIngest(fe, "f32").run(
            iter(chunks[:k]), 0, initial_carry=carry)))
    assert _no_source_thread_within(1.0)


def test_close_stops_the_source_thread_and_a_second_run_works(stream):
    """A consumer that closes the run after two results, over a source
    that never ends: within a second no source thread is left, the
    source was closed on its thread, the ingest is free, and a second
    run on it gives the blocks a fresh ingest gives."""
    fe, _, carry, chunks, _ = stream
    closed = []

    def endless():
        try:
            yield from itertools.cycle(chunks)
        finally:
            closed.append(threading.current_thread().name)

    pipe = ingest.PipelinedIngest(fe, "f32")
    run = pipe.run(endless(), 0, initial_carry=carry)
    first = [next(run), next(run)]
    assert pipe._running and len(_source_threads()) == 1
    run.close()
    assert _no_source_thread_within(1.0)
    assert closed == ["ingest-source"]
    assert not pipe._running
    again = list(pipe.run(iter(chunks), 0, initial_carry=carry))
    want = list(ingest.PipelinedIngest(fe, "f32").run(
        iter(chunks), 0, initial_carry=carry))
    assert _keys(again) == _keys(want)
    assert _keys(first) == _keys(want[:2])


def _pulled_by(items, names, wait_s=0.0, first_waiting=None):
    """Yield items, noting the thread that pulls each; from index
    `first_waiting` on, sleep `wait_s` before each (a source fallen
    behind the loop)."""
    for j, item in enumerate(items):
        if first_waiting is not None and j >= first_waiting:
            time.sleep(wait_s)
        names.append(threading.current_thread().name)
        yield item


def test_a_source_that_stays_ahead_is_pulled_by_the_loop(stream):
    """Every chunk ready (a replay): after DEPTH + 1 checks in a row that
    found one, the loop pulls the source itself, while the blocks stay
    the synchronous loop's."""
    fe, x, carry, chunks, sync = stream
    names = []
    got = list(ingest.PipelinedIngest(fe, "f32").run(
        _pulled_by(chunks + chunks, names), 0, initial_carry=carry))
    assert names[0] == "ingest-source" and names[-1] == "MainThread"
    chip_smoke.compare_chains(fe, sync, got[:N_BLOCKS], x.shape[0])
    assert _keys(got) == _keys(_eager(fe, carry, chunks + chunks))


def test_a_source_that_falls_behind_goes_back_onto_a_thread(stream):
    """Ready chunks, then chunks 50 ms apart: the loop pulls the ready
    ones itself, and the second pull in a row that waits starts a thread
    for the chunks after it; the blocks are those of one steady source."""
    fe, _, carry, chunks, _ = stream
    items = chunks + chunks + chunks[:4]
    late = 2 * len(chunks)
    names = []
    got = list(ingest.PipelinedIngest(fe, "f32").run(
        _pulled_by(items, names, 0.05, late), 0, initial_carry=carry))
    main = [j for j, n in enumerate(names) if n == "MainThread"]
    assert main and main[-1] == late + 1
    assert names[late + 2:] == ["ingest-source"] * 2
    assert _keys(got) == _keys(_eager(fe, carry, items))
    assert _no_source_thread_within(1.0)


def test_same_blocks_under_a_short_switch_interval(stream):
    """Three runs with the interpreter switching threads every
    microsecond: the same blocks in the same order, every one counted
    once, and no source thread left."""
    fe, _, carry, chunks, _ = stream
    pipe = ingest.PipelinedIngest(fe, "f32")
    want = _keys(pipe.run(iter(chunks), 0, initial_carry=carry))
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for _ in range(3):
            metrics.reset()
            assert _keys(pipe.run(iter(chunks), 0,
                                  initial_carry=carry)) == want
            assert metrics.counters["blocks"] == N_BLOCKS
    finally:
        sys.setswitchinterval(old)
        metrics.reset()
    assert _no_source_thread_within(1.0)
