"""Hand-written CUDA kernels for the perf-critical hot spots, each beside
its plain PyTorch version (the thing it is checked against, and what runs
for CPU tensors)."""
