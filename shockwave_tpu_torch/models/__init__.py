"""PyTorch workload models; this slice ports the Seq2Seq Transformer."""
