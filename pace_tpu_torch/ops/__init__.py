"""FV3 transport operators as plain PyTorch functions on stacked per-shard
tensors ``(S, [nq,] [K,] Y, X)``, with hand-written CUDA kernels behind the
hot ones (see ``_dispatch``)."""
