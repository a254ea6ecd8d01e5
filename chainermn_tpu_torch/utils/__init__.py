"""Measurement helpers of the port: the card's peak table
(:mod:`.gpu_info`), device time from a profiler capture (:mod:`.trace`),
the bounded retry around a measurement (:mod:`.retry`), the float32
training-step comparison of the on-card checks (:mod:`.compare`) and
gradient accumulation over microbatches (:mod:`.accum`)."""
