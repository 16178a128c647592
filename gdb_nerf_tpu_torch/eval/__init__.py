"""Evaluation: image metrics and the per-scene evaluator."""
