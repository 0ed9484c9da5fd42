"""C/N0 estimator over tracking output rows (behavioral contract:
cn0.py:8-25): read whitespace rows from stdin taking columns 1,2 as I,Q,
and per --time block print 20*log10(mean|I| / (sqrt(2)*std(Q))) + 30.
"""

from __future__ import annotations

import optparse
import sys

import numpy as np


def cn0(x: np.ndarray) -> float:
    s = np.mean(np.abs(np.real(x)))
    r = np.sqrt(2) * np.std(np.imag(x))
    return 20 * np.log10(s / r) + 30


def main(argv=None) -> int:
    parser = optparse.OptionParser(usage="cn0 [options] < track_output")
    parser.disable_interspersed_args()
    parser.add_option("--time", default="300",
                      help="integration time in milliseconds (default %default)")
    options, _ = parser.parse_args(argv)
    N = int(options.time)
    while True:
        xi = np.zeros(N)
        xq = np.zeros(N)
        for i in range(N):
            t = sys.stdin.readline()
            if not t:
                return 0
            t = t.split()
            xi[i] = float(t[1])
            xq[i] = float(t[2])
        print("%.2f" % cn0(xi + 1j * xq))


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))


def _entry():
    sys.exit(main(sys.argv[1:]))
