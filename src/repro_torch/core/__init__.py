"""The composable-system analytics, held against ``repro/core``: link
classes, the device pool and the H100's constants (``topology``), fabrics,
compositions, the cost model and the topology recommender; and the
parallel layer's policy engine (``policy``: a spec for every tensor and
cache leaf) and collectives (``hierarchy``: the gradient exchange, the
tensor-parallel region's entry and exit).  The dry run's readers
(``costmodel.parse_hlo_collectives``, ``recommend_from_measurements``) are
ROADMAP queue A item 7."""
