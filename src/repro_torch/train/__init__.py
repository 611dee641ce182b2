"""Training (only ``make_run_ctx``, which the serving engine needs, so far)."""
