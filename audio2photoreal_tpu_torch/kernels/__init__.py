"""Kernels written by hand for Hopper, each with its plain PyTorch version.

A wrapper takes the plain version only for a tensor on the CPU; for a CUDA
tensor it launches its kernel or raises.  ``launch_counts`` counts each
kernel's launches (and nothing else), so a run can show that its path went
through the kernels: ``launch_counts.clear()``, run, read a count.
"""

from collections import Counter

launch_counts: Counter = Counter()
