"""The access-code map compiled into csrc/detect_words.cu, and
chip_smoke.py's count of the bit-sliced detector's instructions.

csrc/ac_table.cuh holds A68/C68 as constexpr rows; parsed here, it must
equal ops/detect_kernel.py:ac_masks() (the map of core/access_code) bit
for bit, and its LAP rows must be exactly the 24 error planes the kernel
leaves out.  detect_instr_per_word is held to counts done by hand from
the rows: an XOR of w terms is ceil((w - 1) / 2) LOP3s, a full adder 2.
"""
import re
from pathlib import Path

import numpy as np
import pytest

import chip_smoke
from gr_bluetooth_tpu_torch.ops import detect_kernel

HEADER = (Path(__file__).resolve().parent.parent / "gr_bluetooth_tpu_torch" /
          "csrc" / "ac_table.cuh")


def _array(text, name):
    body = re.search(name + r"\[68\] = \{([^}]*)\}", text).group(1)
    return [int(v.rstrip("u"), 0) for v in re.findall(r"0x[0-9a-f]+u|\d+",
                                                         body)]


@pytest.fixture(scope="module")
def table():
    text = HEADER.read_text()
    rows, c68 = _array(text, "A68_ROW"), _array(text, "C68")
    assert len(rows) == len(c68) == 68
    return rows, c68


def test_compiled_map_equals_ac_masks(table):
    rows, c68 = table
    a68 = np.array([[(r >> k) & 1 for k in range(24)] for r in rows])
    assert np.array_equal(detect_kernel.ac_masks(a68, np.array(c68)),
                          detect_kernel.ac_masks())
    assert np.array_equal(a68, detect_kernel.A68)
    assert np.array_equal(np.array(c68), detect_kernel.C68V & 1)


def test_the_lap_rows_are_the_planes_left_out(table):
    """Rows 38..61 predict the LAP symbol itself (their error plane is
    zero for every window); no other row does."""
    rows, c68 = table
    own = [j for j in range(68) if 38 <= j < 62 and not c68[j] and
           rows[j] == 1 << (j - 38)]
    assert own == list(range(38, 62))


def _xor_instr(terms):
    return -(-(terms - 1) // 2)


@pytest.mark.parametrize("symbols,by_hand", [
    # row 14: 5 LAP terms and v_14 -> ceil(5 / 2)
    ([14], lambda rows: _xor_instr(bin(rows[14]).count("1") + 1)),
    # row 7: 15 LAP terms and v_7 -> 8
    ([7], lambda rows: _xor_instr(bin(rows[7]).count("1") + 1)),
    # rows 0-4 share one mask of 13 terms: that chain once (6), then one
    # XOR with each row's own view
    ([0, 1, 2, 3, 4], lambda rows: _xor_instr(bin(rows[0]).count("1")) + 5),
    # rows 62-67 are v_61 ^ v_j (complemented where C68 says): one each
    (list(range(62, 68)), lambda rows: 6),
    # the LAP symbols' own planes cost nothing
    (list(range(38, 62)), lambda rows: 0),
])
def test_instruction_count_by_hand(table, symbols, by_hand):
    rows, _ = table
    assert rows[0] == rows[4] and rows[62] == rows[67] == 1 << 23
    assert chip_smoke.detect_instr_per_word(1, symbols)["pred"] == \
        by_hand(rows)


def test_instruction_count_totals():
    """44 error planes: 21 + 10 + 5 + 2 full adders and 3 half adders
    (82); preamble 5 planes (2 full, 1 half: 6), Barker 7 (3 + 1 full:
    8), 6 for the gate; err <= 1: 6 clear bits, 1 set (2), the hit AND."""
    p = chip_smoke.detect_instr_per_word(1)
    assert (p["shf"], p["csa"], p["gate"], p["le"]) == (65, 82, 20, 9)
    assert p["total"] == sum(v for k, v in p.items() if k != "total")
    assert chip_smoke.detect_instr_per_word(6)["le"] == 5 + 2 * 2 + 1
    assert chip_smoke.detect_instr_per_word(68)["le"] == 5 + 2 * 2 + 1
    assert chip_smoke.detect_instr_per_word(127)["le"] == 7 * 2 + 1
    # fewer than the two-input count of the same formulation
    assert p["total"] < chip_smoke.detect_ops_per_word(1)
