"""Device operators of the port: pair-hit kernels, packed pair scoring,
dense histogram matmul, the classify program and the fused pipeline."""
