"""Per-LAP network tracker — parity with Tracker_Bluetooth
(kismet/plugin-bluetooth/tracker_bluetooth.{h,cc}).

A copy of gr_bluetooth_tpu/kismet/tracker.py (host code, no device).

Semantics mirrored exactly:
  * two-sighting rule: a LAP seen once goes to `first_nets` only; the second
    sighting promotes it to `tracked_nets` ("Due to poor error correction,
    there is a high likelihood that LAPs seen only once don't really exist",
    tracker_bluetooth.cc:171-189)
  * per-network state: bd_addr (low 24 bits = LAP), num_packets,
    first_time/last_time, GPS aggregate, dirty flag (tracker_bluetooth.h:32-52)
  * blit(): returns dirty tracked networks and clears their dirty flags
    (BlitDevices with in_fd=-1, tracker_bluetooth.cc:209-233); snapshot()
    returns everything regardless (the in_fd>=0 enable path)

GPS aggregation follows Kismet's kis_gps_data +=: min/max lat/lon/alt/spd
plus aggregate (sum) lat/lon/alt and point count for centroid computation.
"""
from __future__ import annotations

import threading
import time as _time
from dataclasses import dataclass, field

__all__ = ["GpsFix", "GpsData", "BluetoothNetwork", "TrackerBluetooth",
           "BTBBDEV_FIELDS"]

# Protocol_BTBBDEV field order (tracker_bluetooth.cc:34-46)
BTBBDEV_FIELDS = (
    "bdaddr", "firsttime", "lasttime", "packets",
    "gpsfixed", "minlat", "maxlat", "minlon", "maxlon",
    "minalt", "maxalt", "minspd", "maxspd",
    "agglat", "agglon", "aggalt", "aggpoints",
)


@dataclass(frozen=True)
class GpsFix:
    lat: float
    lon: float
    alt: float = 0.0
    spd: float = 0.0
    fix: int = 2               # 2D/3D fix quality; 0 = none


@dataclass
class GpsData:
    gps_valid: int = 0
    min_lat: float = 90.0
    max_lat: float = -90.0
    min_lon: float = 180.0
    max_lon: float = -180.0
    min_alt: float = 0.0
    max_alt: float = 0.0
    min_spd: float = 0.0
    max_spd: float = 0.0
    aggregate_lat: float = 0.0
    aggregate_lon: float = 0.0
    aggregate_alt: float = 0.0
    aggregate_points: int = 0

    def add(self, g: GpsFix):
        if g.fix < 2:
            return
        if not self.gps_valid:
            self.min_lat = self.max_lat = g.lat
            self.min_lon = self.max_lon = g.lon
            self.min_alt = self.max_alt = g.alt
            self.min_spd = self.max_spd = g.spd
            self.gps_valid = 1
        else:
            self.min_lat = min(self.min_lat, g.lat)
            self.max_lat = max(self.max_lat, g.lat)
            self.min_lon = min(self.min_lon, g.lon)
            self.max_lon = max(self.max_lon, g.lon)
            self.min_alt = min(self.min_alt, g.alt)
            self.max_alt = max(self.max_alt, g.alt)
            self.min_spd = min(self.min_spd, g.spd)
            self.max_spd = max(self.max_spd, g.spd)
        self.aggregate_lat += g.lat
        self.aggregate_lon += g.lon
        self.aggregate_alt += g.alt
        self.aggregate_points += 1


@dataclass
class BluetoothNetwork:
    lap: int
    first_time: float = 0.0
    last_time: float = 0.0
    num_packets: int = 0
    dirty: bool = False
    gpsdata: GpsData = field(default_factory=GpsData)

    @property
    def bd_addr(self) -> str:
        """Only the low 24 bits of BD_ADDR are ever known from a LAP
        (tracker_bluetooth.cc:180)."""
        return (f"00:00:00:{(self.lap >> 16) & 0xff:02x}:"
                f"{(self.lap >> 8) & 0xff:02x}:{self.lap & 0xff:02x}")

    def fields(self) -> dict:
        """BTBBDEV protocol field values in wire order."""
        g = self.gpsdata
        return {
            "bdaddr": self.bd_addr,
            "firsttime": int(self.first_time),
            "lasttime": int(self.last_time),
            "packets": self.num_packets,
            "gpsfixed": g.gps_valid,
            "minlat": g.min_lat, "maxlat": g.max_lat,
            "minlon": g.min_lon, "maxlon": g.max_lon,
            "minalt": g.min_alt, "maxalt": g.max_alt,
            "minspd": g.min_spd, "maxspd": g.max_spd,
            "agglat": g.aggregate_lat, "agglon": g.aggregate_lon,
            "aggalt": g.aggregate_alt, "aggpoints": g.aggregate_points,
        }


class TrackerBluetooth:
    """chain_handler + BlitDevices (tracker_bluetooth.cc:162-233)."""

    def __init__(self, clock=None):
        self._clock = clock or _time.time
        self.first_nets: dict[int, BluetoothNetwork] = {}
        self.tracked_nets: dict[int, BluetoothNetwork] = {}
        self.n_sightings = 0
        # observe() runs on the processing thread while the BTBBDEV
        # server's accept thread snapshots/formats records (the reference
        # guards its equivalent queue with a pthread mutex,
        # bluetooth_kismet_block.cc:107-120)
        self.lock = threading.RLock()

    def observe(self, lap: int, gps: GpsFix | None = None,
                when: float | None = None) -> BluetoothNetwork | None:
        """One LAP sighting; returns the network if tracked (>= 2 sightings),
        None while still in the single-sighting quarantine."""
        with self.lock:
            self.n_sightings += 1
            now = self._clock() if when is None else when
            net = self.first_nets.get(lap)
            if net is None:
                net = BluetoothNetwork(lap=lap, first_time=now)
                self.first_nets[lap] = net
            elif lap not in self.tracked_nets:
                self.tracked_nets[lap] = net
            net.dirty = True
            net.last_time = now
            net.num_packets += 1
            if gps is not None:
                net.gpsdata.add(gps)
            return self.tracked_nets.get(lap)

    def blit(self) -> list[BluetoothNetwork]:
        """Dirty tracked networks; clears dirty (timer blit path)."""
        with self.lock:
            out = []
            for net in self.tracked_nets.values():
                if net.dirty:
                    net.dirty = False
                    out.append(net)
            return out

    def snapshot(self) -> list[BluetoothNetwork]:
        """All tracked networks regardless of dirty (enable path)."""
        with self.lock:
            return list(self.tracked_nets.values())
