"""RINEX 2.11 observation-file parser.

The inverse of receiver/rinex.py's writer, and the input side of the
software RTK chain (receiver/rtk.py): the reference validates its signal
by post-processing RTKCONV RINEX pairs with RTKLIB
(`/root/reference/rtk/base.obs`, SURVEY.md §2.3); here the same artifact
pair is parsed back and double-difference processed without leaving the
framework. The parser covers the subset RTKCONV emits for a GPS L1
receiver: GPS-only sat ids, any observable set declared in
"# / TYPES OF OBSERV" (up to two header continuation lines), epoch flag
0/1 records, 5 observables per data line with continuations.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from gps_sdr_sim_tpu_torch.utils.gpstime import DateTime, GpsTime, date2gps


@dataclass
class ObsEpoch:
    t: GpsTime                       # receiver time tag of the epoch
    obs: Dict[int, Dict[str, float]]  # PRN -> {obs type -> value}


@dataclass
class ObsData:
    types: List[str]
    epochs: List[ObsEpoch] = field(default_factory=list)
    approx_xyz: Optional[np.ndarray] = None
    marker: str = ""


def _year4(yy: int) -> int:
    # RINEX 2 two-digit years: 80-99 -> 1900s, 00-79 -> 2000s.
    return yy + (1900 if yy >= 80 else 2000)


def read_rinex_obs(source) -> ObsData:
    """Parse a RINEX 2.11 observation file.

    `source` is a path or a file-like object. Returns ObsData with one
    ObsEpoch per flag-0/1 epoch record; observables that are blank in the
    file are absent from the per-satellite dict.
    """
    if hasattr(source, "read"):
        lines = source.read().splitlines()
    else:
        with open(source) as fp:
            lines = fp.read().splitlines()

    types: List[str] = []
    n_types = 0
    approx = None
    marker = ""
    i = 0
    while i < len(lines):
        ln = lines[i]
        label = ln[60:].strip()
        i += 1
        if label == "END OF HEADER":
            break
        if label == "# / TYPES OF OBSERV":
            if not types:
                n_types = int(ln[:6])
            for j in range(9):
                t = ln[6 + 6 * j + 4:6 + 6 * j + 6].strip()
                if t:
                    types.append(t)
        elif label == "APPROX POSITION XYZ":
            approx = np.array([float(ln[14 * k:14 * (k + 1)])
                               for k in range(3)])
        elif label == "MARKER NAME":
            marker = ln[:60].strip()
    if len(types) != n_types:
        raise ValueError(f"obs header declares {n_types} observation "
                         f"types, lists {len(types)}")

    data = ObsData(types=types, approx_xyz=approx, marker=marker)
    per_sat_lines = (n_types + 4) // 5
    while i < len(lines):
        hdr = lines[i]
        if not hdr.strip():
            i += 1
            continue
        flag = int(hdr[28]) if len(hdr) > 28 and hdr[28].strip() else 0
        nsat = int(hdr[29:32])
        if flag > 1:
            # Event records: nsat counts the special lines that follow.
            i += 1 + nsat
            continue
        sats: List[int] = []
        j = i
        for chunk in range(0, nsat, 12):
            ln = lines[j]
            for k in range(min(nsat - chunk, 12)):
                sid = ln[32 + 3 * k:32 + 3 * k + 3]
                if sid[0] not in (" ", "G"):
                    raise ValueError(f"non-GPS satellite id {sid!r}")
                sats.append(int(sid[1:3]))
            j += 1
        i = j
        d = DateTime(_year4(int(hdr[1:3])), int(hdr[4:6]), int(hdr[7:9]),
                     int(hdr[10:12]), int(hdr[13:15]), float(hdr[15:26]))
        ep = ObsEpoch(t=date2gps(d), obs={})
        for prn in sats:
            vals: Dict[str, float] = {}
            for row in range(per_sat_lines):
                ln = lines[i]
                i += 1
                for k in range(min(n_types - 5 * row, 5)):
                    fldv = ln[16 * k:16 * k + 14].strip()
                    if fldv:
                        vals[types[5 * row + k]] = float(fldv)
            ep.obs[prn] = vals
        data.epochs.append(ep)
    return data
