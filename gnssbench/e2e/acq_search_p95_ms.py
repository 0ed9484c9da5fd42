"""The 95th percentile of one search's wall (the acquire CLI's call to
its rows written) over every search of the requests completed in the
window, in ms (numpy's linear interpolation between order
statistics)."""

import numpy as np


def read(win):
    walls = win.search_walls()
    return float(np.percentile(walls, 95)) * 1e3 if walls else None
