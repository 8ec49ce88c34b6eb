"""Compute layer: kernel zoo, autodiff derivative blocks, covariance assembly
(generic and fused XLA paths), evidence linear algebra, and
accelerator-friendly special functions.

Counterpart of the reference's ``gptools/kernel/`` package plus the numeric
parts of ``gptools/core.py`` (``compute_Kij``, ``compute_K_L_alpha_ll`` —
SURVEY.md sections 1 and 3).
"""
