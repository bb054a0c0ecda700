"""Entry points that run the model: the eval forward."""
