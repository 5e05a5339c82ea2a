"""The plain reference in plain PyTorch, float32, importing nothing of the port: CLIP's towers and
CLIP-FSAR's head, torchvision's ResNet trunk, the episode's clips, the episodic train step and the optimizer."""
