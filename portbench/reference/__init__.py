"""The plain reference: CLIP-FSAR in plain PyTorch, float32, importing nothing of the port."""
