"""Search cells a second: every cell of the requests completed in the
window (code rows x dopplers x the code-phase hypotheses of one coherent
period x blocks, worked out from the configuration and the frozen
catalog), over the time from the window's start to the end of the last
request that completed in it."""


def read(win):
    return win.rate()
