"""Evaluation: per-graph metrics and the growing-geometry sweep."""
