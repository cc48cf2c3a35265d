"""The 7.68 Msps hopping-master clock loss is the reference's behaviour.

A master hopping over all 79 channels (LAP 0x24D952, UAP 0x47, a DM1
every other slot, seed 5, noise 0.01), synthesized at 8 Msps by each
package's testing module and resampled 25/24 to 7.68 Msps by each
package's resampler, seen through the off-grid front end (resampled back
to 8 Msps, the polyphase bank on channels 36-42 only).  With 64-slot
blocks over 256 slots and 16-slot blocks over 512, the JAX package's
Sniffer loses the clock (a clock_lost event) after its first decodes,
and the port's Sniffer gives the same events and decoded packets.  (With
8-slot blocks both follow the master to the end of 512 slots.)  Both
run on the CPU.
"""
import numpy as np
import pytest

from gr_bluetooth_tpu.models.sniffer import Sniffer as JSniffer
from gr_bluetooth_tpu.ops import resample as jresample
from gr_bluetooth_tpu.utils.log import EventBus as JBus
from gr_bluetooth_tpu_torch.models.sniffer import Sniffer
from gr_bluetooth_tpu_torch.ops import resample
from gr_bluetooth_tpu_torch.utils.log import EventBus
from test_torch_modes import _capture, _same_decoded, _same_events, _sim
from torch_parity import one_torch_thread  # noqa: F401  (autouse)

FS = 7.68e6


def _offgrid(n_slots):
    x, sent = _capture("make_piconet_capture", _sim(), n_slots=n_slots,
                       fs=8e6, center_freq=2441e6, seed=5,
                       tx_slots=range(0, n_slots - 6, 2), noise_std=0.01)
    planes = np.stack([x.real, x.imag]).astype(np.float32)
    xt = resample.make_resampler(8e6, FS)(planes)
    assert np.array_equal(xt, jresample.make_resampler(8e6, FS)(planes))
    return xt, sent


@pytest.mark.parametrize("block_slots,n_slots", [(64, 256), (16, 512)])
def test_hopping_master_clock_matches_jax(block_slots, n_slots):
    x, _ = _offgrid(n_slots)
    j = JSniffer(FS, 2441e6, block_slots=block_slots, bus=JBus(),
                 enable_le=False)
    t = Sniffer(FS, 2441e6, block_slots=block_slots, bus=EventBus(),
                device="cpu", enable_le=False)
    _same_decoded(t.run(x), j.run(x))
    _same_events(t.bus.events(), j.bus.events())
    kinds = [e["kind"] for e in j.bus.events()]
    assert kinds.count("uap_found") == 1 and "packet_decoded" in kinds
    assert "clock_lost" in kinds
