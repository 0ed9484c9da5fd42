"""Seconds from the harness's first statement (the interpreter's own
start, tens of ms, comes before it) to the window's start: imports, the
kernels' load (their build on a checkout's first run), the synthesis of
the captures, the files written, the warm-up of every shape."""


def read(win):
    return win.setup_s
