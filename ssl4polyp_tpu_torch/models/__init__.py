"""Model cores of the port: ViT layers, weight maps and factories."""
