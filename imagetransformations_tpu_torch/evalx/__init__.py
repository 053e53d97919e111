"""Evaluation (PyTorch): the corruption dispatch and sweep harness
(``harness``), reports (``report``) and flip analysis with failure heads
(``analysis``)."""
