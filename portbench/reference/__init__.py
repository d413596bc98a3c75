"""The plain PyTorch reference: float32, no TF32, nothing of the port."""
