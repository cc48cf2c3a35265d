"""[Frozen copy of gr_bluetooth_tpu_torch/constants.py.]
Bluetooth BR/LE baseband constants.

Values are Bluetooth Core Specification constants; the reference exposes the
same set in include/gr_bluetooth/multi_block.h:47-60 and
include/gr_bluetooth/packet.h:59-84,185-187 and include/gr_bluetooth/piconet.h:83.
"""

# --- air interface (multi_block.h:47-60) ---
SYMBOL_RATE = 1_000_000            # 1 Msym/s, constant for BR
SYMBOLS_PER_SLOT = 625             # one 625 us slot
SLOTS_PER_PACKET_MAX = 5
SYMBOLS_FOR_HISTORY = 3125         # max packet length in symbols (5 slots)
BASE_FREQUENCY = 2_402_000_000.0   # channel 0 center, Hz
CHANNEL_WIDTH = 1_000_000.0        # Hz
CHANNELS = 79                      # BR channels 0..78
ALIASED_CHANNELS = 25              # aliased USRP2 mode: observable 26..50

# --- classic packets (packet.h:59,84,185-187) ---
MAX_SYMBOLS = 3125
MAX_PAYLOAD_BITS = 2744
SYMBOLS_AC_FULL = 72               # preamble(4) + sync(64) + trailer(4)
SYMBOLS_AC_SHORT = 68              # preamble(4) + sync(64): used for search
SYMBOLS_HEADER = 54                # 18 header bits x 3 (FEC 1/3)
ID_THRESHOLD = 5                   # header_present bit-error threshold

# inquiry access LAPs (multi_sniffer_impl.h:42-43)
GIAC = 0x9E8B33
LIAC = 0x9E8B00

# --- LE (packet.h:287-289) ---
LE_MAX_PDU_OCTETS = 39
LE_MAX_SYMBOLS = 376
SYMBOLS_LE_PREAMBLE_AA = 40        # preamble(8) + AA(32)
LE_ADV_AA = 0x8E89BED6

# --- hopping (piconet.h:83, piconet_impl.h:45) ---
SEQUENCE_LENGTH = 1 << 27          # 2^27 slots of hop sequence
CLK6_CANDIDATES = 64
MAX_PATTERN_LENGTH = 1000

# --- DSP front end (multi_block.cc:62-98) ---
CHANNEL_FILTER_CUTOFF = 500_000.0
CHANNEL_FILTER_TRANSITION = 300_000.0
NOISE_FILTER_CUTOFF = 22_500.0
NOISE_FILTER_TRANSITION = 10_000.0
NOISE_PROBE_OFFSET = 790_000.0     # off-channel noise probe offset, Hz
DEFAULT_SNR_DB = 10.0              # default squelch threshold (apps/btrx:55)

# packet type codes (packet_impl.cc:199-203)
TYPE_NAMES = (
    "NULL", "POLL", "FHS", "DM1", "DH1/2-DH1", "HV1", "HV2/2-EV3",
    "HV3/EV3/3-EV3", "DV/3-DH1", "AUX1", "DM3/2-DH3", "DH3/3-DH3",
    "EV4/2-EV5", "EV5/3-EV5", "DM5/2-DH5", "DH5/3-DH5",
)
