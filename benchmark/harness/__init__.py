"""The harness: the cell's files (``spec``), the traffic and inputs drawn
from the seed (``inputs``), the runners of the timed paths (``train``,
``evaluate``), the comparison that decides ``correct`` (``check``), the
counts of operations and bytes (``flops``), the frozen timing helpers
(``timing``) and the reduction of the profiler's trace (``trace``)."""
