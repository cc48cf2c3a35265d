"""The 81 Msps survey of chip_smoke.py phase 8b through both packages on
the CPU: the JAX package's LapSurvey and the port's with its plain
versions, over the same planted capture (3 blocks of 64 slots, seed 3).
Prints each package's missed (LAP, channel) pairs and whether their
observations are equal.

Not a pytest file: a full-band run (79 channels at 81 Msps) takes some
20 s and a few GB on a CPU.  Run it from the repository's root as

    JAX_PLATFORMS=cpu python tests/oddrate_fullband_check.py
"""
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import chip_smoke  # noqa: E402
from gr_bluetooth_tpu.models.lap_survey import LapSurvey as JLapSurvey  # noqa: E402
from gr_bluetooth_tpu_torch.models.lap_survey import LapSurvey  # noqa: E402


def main():
    port = LapSurvey(81e6, 2441e6, block_slots=64, device="cpu")
    x, planted = chip_smoke.plant_capture(port.fe, 3, seed=3)
    obs = {"port": port.run(x, emit_console=False),
           "jax": JLapSurvey(81e6, 2441e6, block_slots=64).run(
               x, emit_console=False)}
    for name, o in obs.items():
        seen = {(a.lap, a.channel) for a in o}
        missed = sorted({(hex(lap), ch) for lap, ch, _ in planted
                         if (lap, ch) not in seen})
        print(f"{name}: {len(o)} observations, {len(planted)} planted, "
              f"missed {missed}")
    key = lambda a: (a.clkn, a.channel, a.lap, a.errors)  # noqa: E731
    print("observations equal:",
          [key(a) for a in obs["port"]] == [key(a) for a in obs["jax"]])


if __name__ == "__main__":
    main()
