"""Model family (ported so far: ViViT and its transformer layers)."""
