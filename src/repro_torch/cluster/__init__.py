"""Cluster plane (serving telemetry only so far)."""
