"""Per-module ICD self-checks — the reference's `if __name__=='__main__'`
UX (gps/ca.py:135-149: each signal module, run standalone, prints its
generated chips against interface-control-document vectors).  Here every
code module runs as

    python -m gnss_dsp_tpu_torch.models.codes.<module>   # e.g. gps_ca

and verifies the full chip sequence of every PRN against the packaged
reference-derived sha256 vectors (data/reference_code_hashes.json — a
stronger check than the reference's first-N-chip prints: one flipped
chip anywhere fails), plus prints the reference-style first-chips line
per family for eyeball comparison with the ICD tables."""

from __future__ import annotations

import hashlib
import json
import os

import numpy as np

HASHES = json.load(open(os.path.join(os.path.dirname(__file__), "data",
                                     "reference_code_hashes.json")))


def bits_of(pm1: np.ndarray) -> np.ndarray:
    """±1 chips -> {0,1} bits (the hash domain; +1 -> 0, -1 -> 1)."""
    return ((1 - np.asarray(pm1, np.int16)) // 2).astype(np.uint8)


def _sha(bits: np.ndarray) -> str:
    return hashlib.sha256(
        np.ascontiguousarray(bits, np.uint8).tobytes()).hexdigest()


def _table(fn):
    return lambda prns: [bits_of(r) for r in fn([int(p) for p in prns])]


def _per_prn(fn, raw_bits: bool = False):
    def build(prns):
        out = []
        for p in prns:
            v = fn(int(p))
            out.append(np.asarray(v, np.uint8) if raw_bits else bits_of(v))
        return out
    return build


def _specs(module: str):
    """hash-key -> bits builder, per module (imports deferred so each
    module self-test only builds its own tables)."""
    from gnss_dsp_tpu_torch.models import codes as c

    if module == "gps_ca":
        from gnss_dsp_tpu_torch.models.codes import gps_ca as m

        return [("gps-ca", _table(m.code_table))]
    if module == "gps_l2c":
        from gnss_dsp_tpu_torch.models.codes import gps_l2c as m

        return [("gps-l2cm", _table(m.cm_table)),
                ("gps-l2cl", _table(m.cl_table))]
    if module == "gps_l5":
        from gnss_dsp_tpu_torch.models.codes import gps_l5 as m

        return [("gps-l5i", _table(m.l5i_table)),
                ("gps-l5q", _table(m.l5q_table))]
    if module == "gps_l1c":
        from gnss_dsp_tpu_torch.models.codes import gps_l1c as m

        return [("gps-l1cp", _table(m.l1cp_table)),
                ("gps-l1cd", _table(m.l1cd_table)),
                ("gps-l1cp-sec", _per_prn(m.secondary_bits, raw_bits=True))]
    if module == "gps_p":
        from gnss_dsp_tpu_torch.models.codes import gps_p as m

        end = m.code_length - 5115
        return [("gps-p-first10230",
                 lambda prns: [m.window(int(p), 0, 10230) for p in prns]),
                ("gps-p-endweek",
                 lambda prns: [m.window(int(p), end, 10230) for p in prns])]
    if module == "galileo":
        from gnss_dsp_tpu_torch.models.codes import galileo as m

        return [(k, _table(getattr(m, k.split("-")[1] + "_table")))
                for k in ("galileo-e1b", "galileo-e1c", "galileo-e5ai",
                          "galileo-e5aq", "galileo-e5bi", "galileo-e5bq",
                          "galileo-e6b", "galileo-e6c")]
    if module == "beidou":
        from gnss_dsp_tpu_torch.models.codes import beidou as m

        out = [(k, _table(getattr(m, k.split("-")[1] + "_table")))
               for k in ("beidou-b1i", "beidou-b1cd", "beidou-b1cp",
                         "beidou-b2ad", "beidou-b2ap", "beidou-b2bi",
                         "beidou-b2bq", "beidou-b2bd", "beidou-b2bp",
                         "beidou-b3i")]
        out.append(("beidou-b1cp-sec", _per_prn(m.b1cp_secondary)))
        out.append(("beidou-b2ap-sec", _per_prn(m.b2ap_secondary)))
        return out
    if module == "glonass":
        from gnss_dsp_tpu_torch.models.codes import glonass as m

        return [("glonass-ca", lambda prns: [m.ca_bits()]),
                ("glonass-l3ocd", _table(m.l3ocd_table)),
                ("glonass-l3ocp", _table(m.l3ocp_table)),
                ("glonass-p", lambda prns: [m.p_bits()])]
    if module == "xona":
        from gnss_dsp_tpu_torch.models.codes import xona as m

        return [(k, _table(getattr(m, k.split("-")[1] + "_table")))
                for k in ("xona-x1p", "xona-x1d", "xona-x5p", "xona-x5d")]
    raise SystemExit(f"no self-test spec for module {module!r}")


def run(module: str) -> int:
    """Verify every family the module generates; 0 = all OK."""
    bad = 0
    for key, build in _specs(module):
        ref = HASHES[key]
        prns = [int(k) for k in sorted(ref, key=int)]
        got = build(prns)
        fails = [p for p, bits in zip(prns, got)
                 if _sha(bits) != ref[str(p)]]
        first = "".join(map(str, got[0][:24]))
        print(f"{key:18s} prn {prns[0]:3d} first chips {first}")
        if fails:
            bad += 1
            print(f"{key:18s} MISMATCH for prns {fails[:10]} "
                  f"({len(fails)}/{len(prns)})")
        else:
            print(f"{key:18s} {len(prns)} PRNs OK "
                  "(sha256 vs reference output)")
    print("ALL OK" if not bad else f"{bad} FAMILIES FAILED")
    return 1 if bad else 0
