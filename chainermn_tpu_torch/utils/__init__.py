"""Measurement helpers of the port: the card's peak table
(:mod:`.gpu_info`), device time from a profiler capture (:mod:`.trace`) and
the bounded retry around a measurement (:mod:`.retry`)."""
