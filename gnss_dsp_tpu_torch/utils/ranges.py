"""CLI list/range parsers (behavioral contract: gnsstools/util.py:1-14).

Supports "1,3,7-14" PRN ranges and the GLONASS channel form "-7:7"
(negative channel numbers force a ':' separator).
"""

from __future__ import annotations


def parse_list_ranges(s: str, sep: str = "-") -> list[int]:
    out: list[int] = []
    for part in s.split(","):
        bits = part.split(sep)
        if len(bits) == 1:
            out.append(int(bits[0]))
        else:
            out.extend(range(int(bits[0]), int(bits[1]) + 1))
    return out


def parse_list_floats(s: str) -> list[float]:
    return [float(v) for v in s.split(",")]
