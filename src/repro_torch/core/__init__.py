"""The composable-system analytics, held against ``repro/core``: link
classes, the device pool and the H100's constants (``topology``), fabrics,
compositions, the cost model and the topology recommender; and the
data-parallel layer's policy engine (``policy``: a spec for every tensor)
and gradient exchange (``hierarchy``).  The tensor- and expert-parallel
paths are ROADMAP queue A item 7."""
