"""Work by definition: the bytes and flops of each op, the model FLOPs, the peaks."""
