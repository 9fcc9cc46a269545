"""The benchmark's plain reference: plain PyTorch, float32 with TF32 off,
importing nothing of the port and taking nothing the port made."""
