"""step_mfu.decode's reading over this cell: the whole pure-decode step's
bound (every expert's bytes; the attention layers' cache) over its wall
time, over the window's steps, in %."""

import os

from h100bench.layers import load_reader

read = load_reader(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                   "step_mfu.decode").read
