"""prefill_step_ms.docqa's reading over this cell: wall ms per
runner.step call that carries prefill rows (on a plan: the decode launch
and the chunk rows' launches by the row map, the hybrid cache's conv
windows among what it maps), over the window's calls."""

import os

from h100bench.layers import load_reader

read = load_reader(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                   "prefill_step_ms.docqa").read
