"""The composable-system analytics, held against ``repro/core``: link
classes, the device pool and the H100's constants (``topology``), fabrics,
compositions, the cost model and the topology recommender.  The parallel
layer (``policy``, ``hierarchy``, ``ComposedSystem.mesh()``) is ROADMAP
queue A item 7."""
