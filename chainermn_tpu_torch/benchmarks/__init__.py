"""The port's measurement entry points: the headline ResNet-50 throughput
bench (:mod:`.bench`, root ``bench.py``'s counterpart) and the stage-1
matrix-product probe (:mod:`.bench_conv_probe`)."""
