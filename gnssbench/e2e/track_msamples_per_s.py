"""Channel-samples tracked a second, in millions: each completed pass
counts every channel's whole band capture, over the time from the
window's start to the end of the last pass that completed in it."""


def read(win):
    return win.rate(1e-6)
