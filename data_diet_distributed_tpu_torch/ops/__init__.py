"""Score ops: kernels, scores, batched GraNd and the scoring driver."""
