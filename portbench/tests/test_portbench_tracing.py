"""The trace reduction's arithmetic on hand-made intervals (the chip gives the real ones)."""

import numpy as np

from portbench import tracing


def test_union_merges_overlaps_and_clips():
    dev = [(0, 10, "a"), (5, 20, "b"), (30, 40, "c"), (35, 38, "d"), (50, 70, "e")]
    iv = tracing.union(dev, 2, 60)
    assert iv.tolist() == [[2, 20], [30, 40], [50, 60]]


def test_gaps_named_by_the_runtime_call_at_their_middle():
    cpu = [(0, 100, "cudaStreamSynchronize"), (200, 210, "cudaLaunchKernel")]
    gaps = np.array([[10, 30], [150, 260], [300, 400]])
    assert tracing._gap_names(gaps, cpu) == ["cudaStreamSynchronize", "cudaLaunchKernel", "host outside CUDA calls"]
