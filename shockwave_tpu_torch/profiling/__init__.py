"""The port's profilers: the throughput oracle (`measure_throughput`), the
cold-dispatch calibration (`measure_startup`), the sf > 1 priors
(`extrapolate_sf`), the flagship bench (`bench_gpu`) and the card's
peak-rate table (`device`)."""
