"""The port's measurement entry points: the headline ResNet-50 throughput
bench (:mod:`.bench`, root ``bench.py``'s counterpart), the stage-1
matrix-product probe (:mod:`.bench_conv_probe`) and the sequence-parallel
attention microbenchmark (:mod:`.bench_ring_attention`)."""
