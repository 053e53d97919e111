"""Evaluation (PyTorch): so far the corruption dispatch of ``harness``."""
