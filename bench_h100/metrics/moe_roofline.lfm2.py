"""moe_roofline.decode's reading over this cell: kernels 4-6 in
pure-decode steps, the bound of the routed experts' work (every expert's
GGUF bytes; 48 rows x 4 = 192 slots over 64 experts) over those kernels'
device time in the profiled slice, in %."""

import os

from h100bench.layers import load_reader

read = load_reader(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                   "moe_roofline.decode").read
